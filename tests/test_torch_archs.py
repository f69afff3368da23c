"""Port parity for every decoder-only architecture of the registry, reduced
(2 layers, d_model <= 256, <= 4 experts), against the JAX package on the
CPU: the configs, the parameter tree, ``param_count()``, and the loss and
its gradients on one batch.

Both sides start from the JAX-initialised parameters (``params_from_jax``)
and the same numpy batch (a VLM's prefix embeddings included).  The fp32
runs set ``dtype="float32"`` on the port and cast the JAX package's
embedding to fp32.  Tolerances: the tree's key paths, shapes and the
parameter counts exactly; the loss within ``rtol=1e-5``; the gradients
within ``rtol=1e-4`` and ``atol=1e-5`` (the MoE and scan gradients sum
over tokens in other orders).  The streaming trainer's global scope on
the reduced jamba hybrid (MoE, mamba and attention) is the stacked step
bit for bit, and ``examples/streaming_at_scale_torch.py`` passes.
"""
import dataclasses
import functools
import importlib.util
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import models as JMD
from repro.configs import get_config as jget
from repro.models import modules as JM
from repro_torch import models as TMD
from repro_torch.configs import ARCH_NAMES, RobustConfig, get_config
from repro_torch.dist import make_streaming_train_step, make_train_step
from repro_torch.dist import trainer as TTR
from repro_torch.launch import train
from repro_torch.models import transformer as TT
from repro_torch.optim import optimizers as TO
from repro_torch.optim import schedules as TS
from repro_torch.tree import tree_items, tree_leaves

torch.set_num_threads(1)

B, SEQ = 2, 16


@pytest.fixture
def fp32_jax(monkeypatch):
    """The JAX package casts activations to bf16 at the embedding; the fp32
    parity runs cast to fp32 there instead."""
    monkeypatch.setattr(JM, "embedding_apply", functools.partial(
        JM.embedding_apply, dtype=jnp.float32))


def _batch(cfg, seed, lead=(B,)):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, lead + (SEQ,)),
           "labels": rng.integers(0, cfg.vocab_size, lead + (SEQ,))}
    if cfg.n_patches:
        out["prefix_embeds"] = rng.normal(
            size=lead + (cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _jb(batch):
    return {k: jnp.asarray(v, jnp.float32 if k == "prefix_embeds"
                           else jnp.int32) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.asarray(v)) if k == "prefix_embeds"
            else torch.from_numpy(np.asarray(v)).long()
            for k, v in batch.items()}


def _pair(name):
    jcfg = jget(name).reduced()
    tcfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    jparams = JMD.init_model(jax.random.key(0), jcfg)
    tparams = TMD.params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    return jcfg, tcfg, jparams, tparams


def _plain(v):
    """A sub-config (the two packages' own dataclasses) as a dict."""
    return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v


def test_registry_is_the_nine_decoder_only_architectures():
    from repro.configs import ARCH_NAMES as JNAMES
    assert sorted(ARCH_NAMES) == sorted(set(JNAMES) - {"whisper-tiny"})
    assert len(ARCH_NAMES) == 9
    with pytest.raises(KeyError, match="available"):
        get_config("whisper-tiny")


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_config_matches_jax(name):
    """Every field the port keeps, the full and the reduced config, and
    the analytic counts."""
    j, t = jget(name), get_config(name)
    for cj, ct in ((j, t), (j.reduced(), t.reduced())):
        for field in dataclasses.fields(ct):
            assert _plain(getattr(ct, field.name)) == \
                _plain(getattr(cj, field.name)), field.name
        assert ct.param_count() == cj.param_count()
        assert ct.active_param_count() == cj.active_param_count()
        assert ct.moe_layer_indices() == cj.moe_layer_indices()
        assert ct.is_attention_free == cj.is_attention_free
    assert t.source == j.source and t.source


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_tree_and_count_match_jax(name):
    """The port's own init: JAX's key paths and shapes, fp32, and
    ``param_count()`` equal to the materialised count."""
    from repro.models import transformer as JT
    jcfg, tcfg = jget(name).reduced(), get_config(name).reduced()
    jparams = JMD.init_model(jax.random.key(0), jcfg)
    tparams = TMD.init_model(tcfg, seed=0, device="cpu")
    jpaths = [(tuple(k.key for k in path), tuple(v.shape)) for path, v in
              jax.tree_util.tree_flatten_with_path(jparams)[0]]
    tpaths = [(path, tuple(v.shape)) for path, v in tree_items(tparams)]
    assert tpaths == jpaths
    assert all(v.dtype == torch.float32 for v in tree_leaves(tparams))
    assert sum(v.numel() for v in tree_leaves(tparams)) == \
        tcfg.param_count()
    assert TT.layer_specs(tcfg) == JT.layer_specs(jcfg)
    assert TT.n_groups(tcfg) == JT.n_groups(jcfg)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_loss_and_grads_match_jax(fp32_jax, name):
    jcfg, tcfg, jparams, tparams = _pair(name)
    batch = _batch(tcfg, seed=1)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JMD.loss_fn(p, jcfg, b, chunk_q=8)))(jparams, _jb(batch))
    live = [p.requires_grad_(True) for p in tree_leaves(tparams)]
    tl = TMD.loss_fn(tparams, tcfg, _tb(batch), chunk_q=8)
    tg = torch.autograd.grad(tl, live)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for (path, _), g, j in zip(tree_items(tparams), tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5, err_msg="/".join(path))


def test_moe_aux_is_in_the_loss(fp32_jax):
    """``lm_loss`` returns the cross entropy plus the summed MoE auxiliary
    loss (JAX's ``loss + aux``), here on the hybrid with one MoE layer."""
    _, tcfg, _, tparams = _pair("jamba-1.5-large-398b")
    b = _tb(_batch(tcfg, seed=2))
    with torch.no_grad():
        x, aux = TT.apply_lm(tparams, tcfg, b["tokens"], return_hidden=True)
        loss = TMD.loss_fn(tparams, tcfg, b)
    assert aux is not None and float(aux) > 0
    from repro_torch.models.losses import chunked_xent
    xent = chunked_xent(x, b["labels"], {"lm_head": tparams["lm_head"]},
                        tied=False)
    assert float(loss) == float(xent + aux)


def test_layers_must_be_a_multiple_of_the_period(capsys):
    with pytest.raises(ValueError, match="multiple of 2"):
        train.run(["--device", "cpu", "--reduced", "--arch",
                   "jamba-1.5-large-398b", "--layers", "3", "--steps", "1"])
    assert "[train] arch" not in capsys.readouterr().out


def test_launcher_helpers_build_the_runs_step():
    """``make_trainer`` and ``worker_batches`` are what ``run`` steps with:
    the reduced VLM's first step from them has ``run``'s loss exactly, and
    step i's prefix is the one of ``fold_seed(seed, PREFIX_STREAM + i)``."""
    from repro_torch.core.attacks import fold_seed
    from repro_torch.dist import init_train_state
    argv = ["--device", "cpu", "--reduced", "--arch", "internvl2-1b",
            "--steps", "1", "--seq", "16", "--per-worker-batch", "1",
            "--seed", "3"]
    _, hist = train.run(argv)
    args = train.parse_args(argv)
    cfg = TMD.arch_config(args.arch, reduced=True)
    opt, step = train.make_trainer(args, cfg, train.robust_config(args),
                                   TS.constant(0.0))
    params = TMD.init_model(cfg, seed=args.seed, device="cpu")
    batches = train.worker_batches(args, cfg, torch.device("cpu"))
    wb = next(batches)
    _, _, metrics = step(params, init_train_state(opt, params), wb,
                         args.seed)
    assert float(metrics["loss"]) == hist[0]["loss"]
    for i, b in enumerate((wb, next(batches))):
        want = TMD.prefix_embeds(cfg, args.workers,
                                 fold_seed(args.seed, TMD.PREFIX_STREAM + i),
                                 "cpu")
        assert torch.equal(b["prefix_embeds"].reshape(want.shape), want)


def test_stream_global_jamba_is_the_stacked_step_bit_for_bit():
    """The reduced hybrid (a mamba layer with a dense MLP, an attention
    layer with an MoE MLP) on the streaming trainer's global scope: the
    stacked step's losses, selection and parameters, bit for bit."""
    cfg = get_config("jamba-1.5-large-398b").reduced()
    n, f = 11, 2
    rcfg = RobustConfig(n_workers=n, f=f)
    opt = TO.sgd(momentum=0.9)
    params = TMD.init_model(cfg, seed=0, device="cpu")
    batch = TTR.split_workers(_tb(_batch(cfg, seed=3, lead=(n,))), n)
    out = []
    for make in (make_train_step, functools.partial(
            make_streaming_train_step, scope="global")):
        step = make(cfg, rcfg, opt, TS.constant(0.05), chunk_q=8,
                    attack="sign_flip", telemetry=True)
        out.append(step(params, TTR.init_train_state(opt, params), batch, 4))
    (p1, _, m1), (p2, _, m2) = out
    assert torch.equal(m1["loss_per_worker"], m2["loss_per_worker"])
    assert torch.equal(m1["telemetry"]["selection"],
                       m2["telemetry"]["selection"])
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, b)


def test_streaming_at_scale_example(capsys):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples",
        "streaming_at_scale_torch.py")
    spec = importlib.util.spec_from_file_location("streaming_at_scale_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    diff = mod.main(["--device", "cpu"])
    assert diff == 0.0
    assert "max |param diff| stacked vs streaming-global: 0" in \
        capsys.readouterr().out
