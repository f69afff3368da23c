"""One robust stacked training step of each decoder-only architecture of
the registry, reduced, against the JAX package's ``make_train_step`` on
the CPU: the MoE, SSM, hybrid and VLM families here, the dense ones in
``tests/test_torch_archs_step_dense.py`` (the slow half of
``tests/test_torch_archs.py``'s parity, in files of their own so they run
side by side).

Both sides start from the JAX-initialised parameters and take the same
numpy batch (11 workers of one sequence of 8 tokens, a VLM's prefix
embeddings and an encoder-decoder's frames included) under the ``inf``
attack, f = 2, multi-Bulyan, SGD with momentum, fp32 activations.  Tolerances: per-worker losses within
``rtol=1e-4``; the selection exactly and the byzantine mass 0 on both;
the honest deviation within ``rtol=1e-3``; the updated parameters within
``rtol=1e-4, atol=1e-5``, except at coordinates where multi-Bulyan's
β-selection meets a near-tie: two honest values equally near the median
within fp32 rounding, so an ulp of the gradients picks the other.  Those
are at most 1e-4 of a leaf's coordinates (a handful of 262,144 here), and
each stays within 1e-2 of JAX's (the scale of one step's update: lr 0.05
times gradients below 0.2).
"""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import models as JMD
from repro.configs import get_config as jget
from repro.configs.base import RobustConfig as JRobust
from repro.dist import trainer as JTR
from repro.models import modules as JM
from repro.optim import optimizers as JO
from repro.optim import schedules as JS
from repro_torch import models as TMD
from repro_torch.configs import RobustConfig, get_config
from repro_torch.dist import trainer as TTR
from repro_torch.optim import optimizers as TO
from repro_torch.optim import schedules as TS
from repro_torch.tree import tree_items

torch.set_num_threads(1)

N, F, SEQ = 11, 2, 8
FAMILIES = ("qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b", "falcon-mamba-7b",
            "jamba-1.5-large-398b", "internvl2-1b")
#: at most this share of a leaf's coordinates may sit at a selection
#: near-tie, each within TIE_ATOL of JAX's value
TIE_SHARE, TIE_ATOL = 1e-4, 1e-2


@pytest.fixture
def fp32_jax(monkeypatch):
    """The JAX package casts activations to bf16 at the embedding; the fp32
    parity runs cast to fp32 there instead."""
    monkeypatch.setattr(JM, "embedding_apply", functools.partial(
        JM.embedding_apply, dtype=jnp.float32))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (N, 1, SEQ)),
           "labels": rng.integers(0, cfg.vocab_size, (N, 1, SEQ))}
    if cfg.n_patches:
        out["prefix_embeds"] = rng.normal(
            size=(N, 1, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.normal(
            size=(N, 1, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


#: the batch's embedding inputs (floats); the rest are token ids
FLOAT_INPUTS = ("prefix_embeds", "frames")


def assert_step_close(got, want, err_msg):
    """``got`` within rtol=1e-4, atol=1e-5 of ``want`` but at selection
    near-ties: at most TIE_SHARE of the coordinates, within TIE_ATOL."""
    diff = np.abs(got - want)
    off = diff > 1e-5 + 1e-4 * np.abs(want)
    assert off.sum() <= TIE_SHARE * want.size, \
        f"{err_msg}: {off.sum()} of {want.size} coordinates off"
    assert diff.max() <= TIE_ATOL, f"{err_msg}: max abs diff {diff.max()}"


def step_matches_jax(name, selection_ulps=0):
    """One step of ``name`` on both sides.  ``selection_ulps``: how many
    fp32 ulps the per-worker selection mass may differ by (0: bit for bit),
    the selected workers the same set either way."""
    jcfg = jget(name).reduced()
    tcfg = dataclasses.replace(get_config(name).reduced(), dtype="float32")
    jparams = JMD.init_model(jax.random.key(0), jcfg)
    tparams = TMD.params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    batch = _batch(tcfg, seed=1)
    opt_j, opt_t = JO.sgd(momentum=0.9), TO.sgd(momentum=0.9)
    jstep = jax.jit(JTR.make_train_step(
        jcfg, JRobust(n_workers=N, f=F), opt_j, JS.constant(0.05),
        chunk_q=SEQ, attack="inf", telemetry=True))
    tstep = TTR.make_train_step(
        tcfg, RobustConfig(n_workers=N, f=F), opt_t, TS.constant(0.05),
        chunk_q=SEQ, attack="inf", telemetry=True)
    jb = {k: jnp.asarray(v, jnp.float32 if k in FLOAT_INPUTS
                         else jnp.int32) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) if k in FLOAT_INPUTS
          else torch.from_numpy(v).long() for k, v in batch.items()}
    jp, _, jm = jstep(jparams, JTR.init_train_state(opt_j, jparams), jb,
                      jax.random.key(2))
    tp, ts, tm = tstep(tparams, TTR.init_train_state(opt_t, tparams), tb, 2)
    np.testing.assert_allclose(tm["loss_per_worker"].numpy(),
                               np.asarray(jm["loss_per_worker"]), rtol=1e-4)
    jt, tt = jm["telemetry"], tm["telemetry"]
    tsel, jsel = tt["selection"].numpy(), np.asarray(jt["selection"])
    np.testing.assert_array_equal(tsel > 0, jsel > 0)
    np.testing.assert_array_max_ulp(tsel, jsel, maxulp=selection_ulps)
    assert float(tt["byz_mass"]) == float(jt["byz_mass"]) == 0.0
    np.testing.assert_allclose(float(tt["honest_dev"]),
                               float(jt["honest_dev"]), rtol=1e-3)
    jl = jax.tree.leaves(jp)
    for (path, t), j in zip(tree_items(tp), jl):
        assert_step_close(t.numpy(), np.asarray(j), "/".join(path))
    assert ts.opt.step == 1


@pytest.mark.parametrize("name", FAMILIES)
def test_one_robust_step_matches_jax(fp32_jax, name):
    step_matches_jax(name)
