"""Port parity for the training path: models, optimizers, data and one
stacked robust train step against the JAX package.

The tiny config has qwen2's flavour (GQA, QKV bias, tied embeddings,
2 layers, d_model 64).  Both sides start from the same JAX-initialised
parameters (``params_from_jax``) and the same numpy batch.  The fp32 runs
set ``dtype="float32"`` on the port and cast the JAX package's embedding
to fp32 (it hard-codes bf16 activations); losses and updated parameters
then match within ``rtol=1e-4`` (``atol=1e-6`` for entries near 0).
"""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import models as JMD
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import RobustConfig as JRobust
from repro.data.synthetic import make_lm_batch
from repro.dist import trainer as JTR
from repro.models import modules as JM
from repro.optim import optimizers as JO
from repro.optim import schedules as JS
from repro_torch import models as TMD
from repro_torch.configs import ArchConfig, RobustConfig, get_config
from repro_torch.data import lm_batches
from repro_torch.data.synthetic import _bigram_table
from repro_torch.dist import trainer as TTR
from repro_torch.optim import optimizers as TO
from repro_torch.optim import schedules as TS
from repro_torch.tree import tree_items, tree_leaves

# the suite runs in several worker processes at once: one thread each
# keeps the port's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

TINY = dict(name="tiny-qwen", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
            qkv_bias=True, tie_embeddings=True, rope_theta=1e6)

N, F, SEQ = 11, 2, 16


@pytest.fixture
def fp32_jax(monkeypatch):
    """The JAX package casts activations to bf16 at the embedding; the fp32
    parity runs cast to fp32 there instead."""
    monkeypatch.setattr(JM, "embedding_apply", functools.partial(
        JM.embedding_apply, dtype=jnp.float32))


def _setup(dtype="float32"):
    jcfg = JArch(**TINY)
    tcfg = ArchConfig(**TINY, dtype=dtype)
    jparams = JMD.init_model(jax.random.key(0), jcfg)
    tparams = TMD.params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")
    batch = make_lm_batch(jax.random.key(1), TINY["vocab_size"], N, SEQ)
    batch = {k: np.asarray(v) for k, v in batch.items()}
    return jcfg, tcfg, jparams, tparams, batch


def _jbatch(batch):
    return JTR.split_workers({k: jnp.asarray(v) for k, v in batch.items()},
                             N)


def _tbatch(batch):
    return TTR.split_workers({k: torch.tensor(v).long()
                              for k, v in batch.items()}, N)


def _assert_tree_close(tparams, jparams, rtol, atol):
    jl = jax.tree.leaves(jparams)
    tl = tree_leaves(tparams)
    assert len(jl) == len(tl)
    for (path, t), j in zip(tree_items(tparams), jl):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                                   atol=atol, err_msg="/".join(path))


# ---------------------------------------------------------------- models
def test_param_tree_matches_jax_layout():
    jcfg = JArch(**TINY)
    jparams = JMD.init_model(jax.random.key(0), jcfg)
    tparams = TMD.init_model(ArchConfig(**TINY), seed=0, device="cpu")
    jpaths = [tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jparams)[0]]
    tpaths = [path for path, _ in tree_items(tparams)]
    assert tpaths == jpaths
    for t, j in zip(tree_leaves(tparams), jax.tree.leaves(jparams)):
        assert tuple(t.shape) == tuple(j.shape)
        assert t.dtype == torch.float32


def test_qwen2_config_matches_jax():
    from repro.configs import get_config as jget
    j, t = jget("qwen2-1.5b"), get_config("qwen2-1.5b")
    for field in dataclasses.fields(t):
        if hasattr(j, field.name):
            assert getattr(t, field.name) == getattr(j, field.name), \
                field.name
    tr, jr = t.reduced(), j.reduced()
    for field in dataclasses.fields(tr):
        assert getattr(tr, field.name) == getattr(jr, field.name), field.name


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_jax(kind):
    from repro_torch.models import modules as TM
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    jp = JM.norm_init(kind, 16)
    jp = {k: np.asarray(v) + rng.normal(size=v.shape).astype(np.float32)
          for k, v in jp.items()}
    want = JM.norm_apply(kind, {k: jnp.asarray(v) for k, v in jp.items()},
                         jnp.asarray(x))
    got = TM.norm_apply(kind, {k: torch.from_numpy(v) for k, v in jp.items()},
                        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["gelu", "silu", "relu2", "relu"])
def test_activations_match_jax(name):
    from repro_torch.models import modules as TM
    x = np.linspace(-4, 4, 101).astype(np.float32)
    np.testing.assert_allclose(
        TM.ACTIVATIONS[name](torch.from_numpy(x)).numpy(),
        np.asarray(JM.ACTIVATIONS[name](jnp.asarray(x))), rtol=1e-5,
        atol=1e-6)


@pytest.mark.parametrize("rope,window,chunk_q", [
    ("full", 0, 16), ("full", 5, 4), ("partial", 0, 7), ("none", 3, 16)])
def test_attention_matches_jax(rope, window, chunk_q):
    """RoPE (full / partial / none), GQA expansion, the sliding window and
    the query-chunked path of attend_full, fp32."""
    from repro.models import attention as JAt
    from repro_torch.models import attention as TAt
    cfg = dict(TINY, rope=rope, rope_fraction=0.5)
    jcfg, tcfg = JArch(**cfg), ArchConfig(**cfg, dtype="float32")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 64)).astype(np.float32)
    jp = JAt.attn_init(jax.random.key(3), jcfg)
    tp = TMD.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    pos = np.broadcast_to(np.arange(16, dtype=np.int32)[None], (2, 16))
    jq, jk, jv = JAt.project_qkv(jp, jnp.asarray(x), jcfg,
                                 positions=jnp.asarray(pos))
    tq, tk, tv = TAt.project_qkv(tp, torch.from_numpy(x), tcfg,
                                 positions=torch.from_numpy(pos.copy()))
    for t, j in ((tq, jq), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    want = JAt.attend_full(jq, jk, jv, window=window, chunk_q=chunk_q)
    got = TAt.attend_full(tq, tk, tv, window=window, chunk_q=chunk_q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("chunk", [7, 4096])
def test_chunked_xent_matches_jax(tied, chunk):
    from repro.models.losses import chunked_xent as jxent
    from repro_torch.models.losses import chunked_xent as txent
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 16)).astype(np.float32)
    labels = rng.integers(0, 32, size=(2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32)
    w = rng.normal(size=(32, 16) if tied else (16, 32)).astype(np.float32)
    rp = {"embed": {"table": w}} if tied else {"lm_head": {"w": w}}
    jrp = jax.tree.map(jnp.asarray, rp)
    trp = jax.tree.map(torch.from_numpy, rp)
    want = jxent(jnp.asarray(x), jnp.asarray(labels), jrp, tied=tied,
                 mask=jnp.asarray(mask), chunk=chunk)
    got = txent(torch.from_numpy(x), torch.from_numpy(labels).long(), trp,
                tied=tied, mask=torch.from_numpy(mask), chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_loss_matches_jax_fp32(fp32_jax):
    jcfg, tcfg, jparams, tparams, batch = _setup()
    want = JMD.loss_fn(jparams, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    got = TMD.loss_fn(tparams, tcfg, {k: torch.tensor(v).long()
                                      for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_loss_matches_jax_bf16():
    """bf16 activations on both sides: the two frameworks round at other
    places (matmul accumulation, casts around the norms), so the bound is
    the bf16 resolution, rtol=1e-2."""
    jcfg, tcfg, jparams, tparams, batch = _setup(dtype="bfloat16")
    want = JMD.loss_fn(jparams, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
    got = TMD.loss_fn(tparams, tcfg, {k: torch.tensor(v).long()
                                      for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-2)


def test_per_worker_grads_match_jax_fp32(fp32_jax):
    jcfg, tcfg, jparams, tparams, batch = _setup()
    jb, tb = _jbatch(batch), _tbatch(batch)
    jl, jg = jax.vmap(lambda wb: jax.value_and_grad(
        lambda p: JMD.loss_fn(p, jcfg, wb, chunk_q=SEQ))(jparams))(jb)
    tl, tg = TTR.per_worker_grads(tparams, tcfg, tb, chunk_q=SEQ)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    _assert_tree_close(tg, jg, rtol=1e-4, atol=1e-6)
    assert tuple(tree_leaves(tg)[0].shape[:1]) == (N,)


# ------------------------------------------------------------ the step
def _steps(jcfg, tcfg, attack, gar="multi_bulyan"):
    opt_j, opt_t = JO.sgd(momentum=0.9), TO.sgd(momentum=0.9)
    jstep = jax.jit(JTR.make_train_step(
        jcfg, JRobust(n_workers=N, f=F, gar=gar), opt_j, JS.constant(0.05),
        chunk_q=SEQ, attack=attack, telemetry=True))
    tstep = TTR.make_train_step(
        tcfg, RobustConfig(n_workers=N, f=F, gar=gar), opt_t,
        TS.constant(0.05), chunk_q=SEQ, attack=attack, telemetry=True)
    return opt_j, opt_t, jstep, tstep


@pytest.mark.parametrize("attack", ["inf", "sign_flip"])
def test_one_train_step_matches_jax_fp32(fp32_jax, attack):
    jcfg, tcfg, jparams, tparams, batch = _setup()
    opt_j, opt_t, jstep, tstep = _steps(jcfg, tcfg, attack)
    jp, _, jm = jstep(jparams, JTR.init_train_state(opt_j, jparams),
                      _jbatch(batch), jax.random.key(2))
    tp, ts, tm = tstep(tparams, TTR.init_train_state(opt_t, tparams),
                       _tbatch(batch), 2)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(tm["loss_per_worker"].numpy(),
                               np.asarray(jm["loss_per_worker"]), rtol=1e-4)
    jt, tt = jm["telemetry"], tm["telemetry"]
    np.testing.assert_array_equal(tt["selection"].numpy(),
                                  np.asarray(jt["selection"]))
    # the JAX step fuses the selection mean into this sum: one ulp apart
    np.testing.assert_allclose(float(tt["byz_mass"]), float(jt["byz_mass"]),
                               rtol=1e-6)
    if attack == "inf":
        assert float(tt["byz_mass"]) == float(jt["byz_mass"]) == 0.0
    np.testing.assert_allclose(float(tt["honest_dev"]),
                               float(jt["honest_dev"]), rtol=1e-4)
    _assert_tree_close(tp, jp, rtol=1e-4, atol=1e-6)
    assert ts.opt.step == 1


def test_one_train_step_matches_jax_bf16():
    """bf16 activations: per-worker losses and gradients differ at the bf16
    resolution (losses rtol=1e-2), and where two candidates sit that close
    to a coordinate's median distance the β-selection can differ.  So the
    updated parameters hold to 1e-2 absolute at every coordinate (one
    step's update reaches 8e-3 here) and to 5% of the mean update size on
    average."""
    jcfg, tcfg, jparams, tparams, batch = _setup(dtype="bfloat16")
    opt_j, opt_t, jstep, tstep = _steps(jcfg, tcfg, "inf")
    jp, _, jm = jstep(jparams, JTR.init_train_state(opt_j, jparams),
                      _jbatch(batch), jax.random.key(2))
    tp, _, tm = tstep(tparams, TTR.init_train_state(opt_t, tparams),
                      _tbatch(batch), 2)
    np.testing.assert_allclose(tm["loss_per_worker"].numpy(),
                               np.asarray(jm["loss_per_worker"]), rtol=1e-2)
    assert float(tm["telemetry"]["byz_mass"]) == 0.0
    _assert_tree_close(tp, jp, rtol=0, atol=1e-2)
    diff = np.concatenate([np.abs(t.numpy() - np.asarray(j)).ravel()
                           for t, j in zip(tree_leaves(tp),
                                           jax.tree.leaves(jp))])
    upd = np.concatenate([np.abs(np.asarray(j) - np.asarray(j0)).ravel()
                          for j, j0 in zip(jax.tree.leaves(jp),
                                           jax.tree.leaves(jparams))])
    assert diff.mean() <= 0.05 * upd.mean()


@pytest.mark.parametrize("attack", ["inf", "sign_flip", "little_is_enough",
                                    "mimic", "none"])
def test_inject_byzantine_matches_jax(attack):
    rng = np.random.default_rng(0)
    tree = {"w": rng.normal(size=(N, 4, 6)).astype(np.float32),
            "b": rng.normal(size=(N, 5)).astype(np.float32)}
    want = JTR.inject_byzantine({k: jnp.asarray(v) for k, v in tree.items()},
                                F, attack, jax.random.key(0))
    got = TTR.inject_byzantine({k: torch.from_numpy(v.copy())
                                for k, v in tree.items()}, F, attack, 0)
    for k in tree:
        # one ulp: the two frameworks reduce the mean and std in other orders
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[k].numpy()[F:], tree[k][F:])


def test_split_workers_matches_jax():
    x = np.arange(22 * 3).reshape(22, 3)
    got = TTR.split_workers({"t": torch.from_numpy(x)}, N)["t"].numpy()
    want = np.asarray(JTR.split_workers({"t": jnp.asarray(x)}, N)["t"])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="not divisible"):
        TTR.split_workers({"t": torch.zeros(10, 3)}, N)


def test_train_step_rejects_bad_attack_f():
    with pytest.raises(ValueError, match="attack_f"):
        TTR.make_train_step(ArchConfig(**TINY), RobustConfig(N, F),
                            TO.sgd(), TS.constant(0.1), attack_f=3)


# ------------------------------------------------------ optim / data
@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_optimizer_update_matches_jax(name):
    rng = np.random.default_rng(3)
    p = {"a": rng.normal(size=(4, 3)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    jo, to = JO.make_optimizer(name), TO.make_optimizer(name)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(2):
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                           jp, 0.1)
        tp, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp, 0.1)
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
    assert ts.step == int(js.step) == 2


def test_schedules_match_jax():
    jf, tf = JS.warmup_cosine(0.05, 3, 40), TS.warmup_cosine(0.05, 3, 40)
    for s in range(0, 45, 4):
        np.testing.assert_allclose(tf(s), float(jf(jnp.int32(s))),
                                   rtol=1e-6)
    assert TS.constant(0.1)(7) == float(JS.constant(0.1)(jnp.int32(7)))


def test_lm_batches_deterministic_and_follow_the_bigram_table():
    a = next(lm_batches(64, 4, 12, seed=3))
    b = next(lm_batches(64, 4, 12, seed=3))
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    table = _bigram_table(64, 3 + 77)
    toks = torch.cat([a["tokens"], a["labels"][:, -1:]], 1).numpy()
    for row in toks:
        for t0, t1 in zip(row[:-1], row[1:]):
            assert t1 in table[t0]
