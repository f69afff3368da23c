"""The port's streaming trainer (``repro_torch.dist.streaming``) and the
trainer pieces it stands on, on the CPU.

The tiny config is ``tests/test_torch_trainer.py``'s (qwen2's flavour: GQA,
QKV bias, tied embeddings, 2 layers, d_model 64, vocab 128); both sides
start from the same JAX-initialised parameters (``params_from_jax``) and
the same numpy batch, n = 11, f = 2, with fp32 activations on both.

* against JAX's ``make_streaming_train_step``, both scopes under four
  attacks: the selection exact, the losses and the updated parameters
  within ``rtol=1e-4, atol=1e-6`` after one step, as
  ``tests/test_torch_trainer.py`` holds the stacked step (a second step
  starts from parameters an ulp apart, and a coordinate's beta-nearest
  choice can flip at a near-tie);
* against the port's own stacked trainer: global scope bit for bit over
  two steps (parameters, losses, selection, honest deviation), uncompressed and
  under JAX's two codec cases (``tests/test_comm.py``), with the same
  wire bytes;
* the leaf-offset seed convention of ``inject_byzantine``,
  ``Codec.encode`` and ``inject_wire``, per-block gradients, the
  honest-deviation helpers, ``as_trainer_state``, the per-leaf wire
  containers and ``encoded_raw_contrib``, and every refusal with JAX's
  message.
"""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro import models as JMD
from repro.comm import codecs as JC
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import RobustConfig as JRobust
from repro.data.synthetic import make_lm_batch
from repro.dist import streaming as JST
from repro.dist import trainer as JTR
from repro.models import modules as JM
from repro.optim import optimizers as JO
from repro.optim import schedules as JS
from repro_torch import models as TMD
from repro_torch.comm import codecs as TC
from repro_torch.configs import ArchConfig, RobustConfig
from repro_torch.dist import streaming as TST
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
STEPS = 2
#: the first step's seed (JAX's key 2 in tests/test_torch_trainer.py)
SEED0 = 2
ATTACKS = ["none", "inf", "sign_flip", "little_is_enough"]
#: JAX's codec cases (tests/test_comm.py), each with the attack it runs
CODEC_CASES = [("bf16", "sign_flip"), ("qsgd:bits=8", "scale_poison:gain=50")]


@pytest.fixture(scope="module")
def setup():
    """(JAX parameters, the port's, the JAX batch, the port's batch)."""
    jparams = JMD.init_model(jax.random.key(0), JArch(**TINY))
    tparams = TMD.params_from_jax(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    batch = make_lm_batch(jax.random.key(1), TINY["vocab_size"], N, SEQ)
    batch = {k: np.asarray(v) for k, v in batch.items()}
    jb = JTR.split_workers({k: jnp.asarray(v) for k, v in batch.items()}, N)
    tb = TTR.split_workers({k: torch.tensor(v).long()
                            for k, v in batch.items()}, N)
    return jparams, tparams, jb, tb


def _tcfg():
    return ArchConfig(**TINY, dtype="float32")


def _port_step(make, **kw):
    opt = TO.sgd(momentum=0.9)
    return opt, make(_tcfg(), RobustConfig(n_workers=N, f=F), opt,
                     TS.constant(0.05), chunk_q=SEQ, telemetry=True, **kw)


def _port_run(tparams, tb, make, steps=STEPS, **kw):
    """[(params, metrics)] of ``steps`` steps of the port's step
    ``make``."""
    opt, step = _port_step(make, **kw)
    params, state, out = tparams, TTR.init_train_state(opt, tparams), []
    for i in range(steps):
        params, state, m = step(params, state, tb, SEED0 + i)
        out.append((params, m))
    return out


def _same(a, b):
    """Same dtype, shape and bits (NaN included: an integer view)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


# ============================================================ against JAX
@pytest.fixture(scope="module")
def jax_runs(setup):
    """{(scope, attack): (params, metrics)} of one JAX streaming step,
    fp32 activations, key SEED0."""
    jparams, _, jb, _ = setup
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "embedding_apply", functools.partial(
            JM.embedding_apply, dtype=jnp.float32))
        for scope in ("global", "block"):
            for attack in ATTACKS:
                opt = JO.sgd(momentum=0.9)
                step = jax.jit(JST.make_streaming_train_step(
                    JArch(**TINY), JRobust(n_workers=N, f=F), opt,
                    JS.constant(0.05), scope=scope, chunk_q=SEQ,
                    attack=attack, telemetry=True))
                params, _, m = step(jparams,
                                    JTR.init_train_state(opt, jparams), jb,
                                    jax.random.key(SEED0))
                out[scope, attack] = (jax.tree.map(np.asarray, params),
                                      jax.tree.map(np.asarray, m))
    return out


@pytest.mark.parametrize("attack", ATTACKS)
@pytest.mark.parametrize("scope", ["global", "block"])
def test_streaming_matches_jax(setup, jax_runs, scope, attack):
    """One step from the same parameters: the selection exact (global
    scope: the global plan's), the losses and the parameters within rtol
    1e-4 / atol 1e-6.  Under block scope the reported selection is the
    mean of the three block plans' selections, which the two frameworks
    round apart by an ulp: there the selected rows are the same and the
    weights within rtol 1e-6.  None of these four attacks draws from its
    generator, so the two seed conventions do not meet."""
    _, tparams, _, tb = setup
    [(tp, tm)] = _port_run(tparams, tb, TST.make_streaming_train_step,
                           steps=1, scope=scope, attack=attack)
    jp, jm = jax_runs[scope, attack]
    sel, jsel = tm["telemetry"]["selection"].numpy(), \
        jm["telemetry"]["selection"]
    if scope == "global":
        np.testing.assert_array_equal(sel, jsel)
    else:
        np.testing.assert_array_equal(sel > 0, jsel > 0)
        np.testing.assert_allclose(sel, jsel, rtol=1e-6)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(tm["loss_per_worker"].numpy(),
                               jm["loss_per_worker"], rtol=1e-4)
    # one ulp: JAX fuses the selection mean into this sum
    np.testing.assert_allclose(float(tm["telemetry"]["byz_mass"]),
                               float(jm["telemetry"]["byz_mass"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm["telemetry"]["honest_dev"]),
                               float(jm["telemetry"]["honest_dev"]),
                               rtol=1e-4)
    for (path, t), j in zip(tree_items(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-6,
                                   err_msg="/".join(path))
    if attack == "inf":
        assert float(tm["telemetry"]["byz_mass"]) == 0.0


# ================================================ against the stacked port
def _stacked_and_global(setup, **kw):
    _, tparams, _, tb = setup
    return (_port_run(tparams, tb, TTR.make_train_step, **kw),
            _port_run(tparams, tb, TST.make_streaming_train_step,
                      scope="global", **kw))


@pytest.mark.parametrize("attack", ["inf", "sign_flip", "little_is_enough"])
def test_global_scope_is_the_stacked_step_bit_for_bit(setup, attack):
    stacked, stream = _stacked_and_global(setup, attack=attack)
    for (ps, ms), (pg, mg) in zip(stacked, stream):
        for a, b in zip(tree_leaves(ps), tree_leaves(pg)):
            assert _same(a, b)
        assert _same(ms["loss_per_worker"], mg["loss_per_worker"])
        assert _same(ms["loss"], mg["loss"])
        for key in ("selection", "byz_mass", "honest_dev", "score_spectrum",
                    "score_gap", "mean_dist"):
            assert _same(ms["telemetry"][key], mg["telemetry"][key]), key
        assert _same(ms["agg_grad_norm"], mg["agg_grad_norm"])


@pytest.mark.parametrize("codec,attack", CODEC_CASES)
def test_global_scope_under_a_codec_is_the_stacked_step(setup, codec,
                                                         attack):
    """The leaf-offset convention: per-block injection, encode and wire
    attack reproduce the stacked trainer's wire, and the statistics add
    each leaf's contribution off its payload in the stacked order."""
    stacked, stream = _stacked_and_global(setup, attack=attack, codec=codec)
    for (ps, ms), (pg, mg) in zip(stacked, stream):
        for a, b in zip(tree_leaves(ps), tree_leaves(pg)):
            assert _same(a, b)
        assert _same(ms["loss_per_worker"], mg["loss_per_worker"])
        for key in ("selection", "byz_mass", "honest_dev", "mean_dist"):
            assert _same(ms["telemetry"][key], mg["telemetry"][key]), key
        assert ms["telemetry"]["wire_bytes_per_worker"] == \
            mg["telemetry"]["wire_bytes_per_worker"] > 0


def test_block_scope_rejects_inf_in_every_block(setup):
    """Under ``inf`` each block's plan puts no mass on the forged rows; a
    codec run (wire bytes the stacked trainer's) trains alike."""
    _, tparams, _, tb = setup
    for codec in (None, "qsgd:bits=8"):
        attack = "inf" if codec is None else "scale_poison"
        got = _port_run(tparams, tb, TST.make_streaming_train_step,
                        scope="block", attack=attack, codec=codec)
        for _, m in got:
            assert float(m["telemetry"]["byz_mass"]) == 0.0
            assert np.isfinite(float(m["loss"]))
    stacked = _port_run(tparams, tb, TTR.make_train_step,
                        attack="scale_poison", codec="qsgd:bits=8")
    assert got[0][1]["telemetry"]["wire_bytes_per_worker"] == \
        stacked[0][1]["telemetry"]["wire_bytes_per_worker"]


@pytest.mark.parametrize("scope", ["global", "block"])
def test_coord_chunk_matches_the_fused_apply(setup, scope):
    """The two-step substrate in column slices (``coord_chunk``, kernels
    off) against the fused apply (K2's plain version): the same selection,
    the parameters within 1e-6."""
    _, tparams, _, tb = setup
    fused = _port_run(tparams, tb, TST.make_streaming_train_step,
                      scope=scope, attack="sign_flip")
    opt = TO.sgd(momentum=0.9)
    step = TST.make_streaming_train_step(
        _tcfg(), RobustConfig(n_workers=N, f=F, use_kernels=False), opt,
        TS.constant(0.05), scope=scope, chunk_q=SEQ, telemetry=True,
        attack="sign_flip", coord_chunk=100)
    params, state = tparams, TTR.init_train_state(opt, tparams)
    for i, (pf, mf) in enumerate(fused):
        params, state, m = step(params, state, tb, SEED0 + i)
        assert torch.equal(m["telemetry"]["selection"],
                           mf["telemetry"]["selection"])
        for a, b in zip(tree_leaves(params), tree_leaves(pf)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_distance_free_rule_plans_once_and_matches_the_stacked_step(setup):
    """A rule that needs no distances (median), telemetry off: the plan is
    made once and the step is the stacked trainer's."""
    _, tparams, _, tb = setup
    outs = []
    for make, kw in ((TTR.make_train_step, {}),
                     (TST.make_streaming_train_step, {"scope": "block"})):
        opt = TO.sgd(momentum=0.9)
        step = make(_tcfg(), RobustConfig(n_workers=N, f=F, gar="median"),
                    opt, TS.constant(0.05), chunk_q=SEQ, attack="sign_flip",
                    **kw)
        p, _, m = step(tparams, TTR.init_train_state(opt, tparams), tb,
                       SEED0)
        assert "telemetry" not in m
        outs.append(p)
    for a, b in zip(*(tree_leaves(p) for p in outs)):
        assert _same(a, b)


# ===================================================== the trainer pieces
def test_block_gradients_are_the_whole_stack_s_leaves(setup):
    """``per_worker_grads(block=k)``: the losses and every block's stack
    bit for bit the matching leaves of the whole stack (the tied
    embedding gathers both of its uses)."""
    _, tparams, _, tb = setup
    losses, whole = TTR.per_worker_grads(tparams, _tcfg(), tb, chunk_q=SEQ)
    assert sorted(tparams) == ["embed", "final_norm", "groups"]
    for k in tparams:
        lk, gk = TTR.per_worker_grads(tparams, _tcfg(), tb, chunk_q=SEQ,
                                      block=k)
        assert _same(lk, losses)
        got, want = tree_leaves(gk), tree_leaves(whole[k])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert _same(a, b) and not a.requires_grad


def _stack(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(N, 4, 6)).astype(np.float32)},
            "b": {"c": rng.normal(size=(N, 5)).astype(np.float32),
                  "d": rng.normal(size=(N, 3)).astype(np.float32)},
            "e": rng.normal(size=(N, 7)).astype(np.float32)}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else
            torch.from_numpy(v.copy()) for k, v in tree.items()}


def _offsets(tree):
    out, off = {}, 0
    for k in sorted(tree):
        out[k] = off
        off += len(tree_leaves(tree[k]))
    return out


def test_inject_byzantine_leaf_offset_reproduces_the_whole_tree():
    """``gaussian`` draws from each leaf's generator: the blocks, each
    injected with its offset, give the whole-tree call's rows; with offset
    0 they would not (past the first block)."""
    whole = TTR.inject_byzantine(_torch(_stack(0)), F, "gaussian", 7)
    offs = _offsets(_stack(0))
    for k, off in offs.items():
        part = TTR.inject_byzantine(_torch(_stack(0))[k], F, "gaussian", 7,
                                    leaf_offset=off)
        for a, b in zip(tree_leaves(part), tree_leaves(whole[k])):
            assert torch.equal(a, b)
    wrong = TTR.inject_byzantine(_torch(_stack(0))["e"], F, "gaussian", 7)
    assert not torch.equal(wrong, whole["e"])


def test_encode_leaf_offset_reproduces_the_whole_tree():
    """QSGD's stochastic rounding draws per leaf: each block encoded with
    its offset is the whole tree's payload and sidecar for its leaves."""
    codec = TC.get_codec("qsgd:bits=8")
    whole, _ = codec.encode(_torch(_stack(1)), seed=11)
    for k, off in _offsets(_stack(1)).items():
        part, _ = codec.encode(_torch(_stack(1))[k], seed=11,
                               leaf_offset=off)
        for a, b in zip(tree_leaves(part.payload),
                        tree_leaves(whole.payload[k])):
            assert torch.equal(a, b)
        for a, b in zip(tree_leaves(part.sidecar),
                        tree_leaves(whole.sidecar[k])):
            assert torch.equal(a, b)


def test_inject_wire_leaf_offset_reproduces_the_whole_tree():
    """A wire attack that draws from its generator (the listed wire
    attacks draw nothing) forges per block what it forges on the whole
    container."""
    codec = TC.get_codec("qsgd:bits=8")

    def noisy(P, S, f, gen):
        z = torch.randint(-127, 128, (f,) + tuple(P.shape[1:]),
                          generator=gen, dtype=torch.int64)
        return z.to(P.dtype), torch.rand((f,) + tuple(S.shape[1:]),
                                         generator=gen)

    whole, _ = codec.encode(_torch(_stack(2)), seed=3)
    whole = TTR.inject_wire(whole, F, noisy, 5)
    for k, off in _offsets(_stack(2)).items():
        part, _ = codec.encode(_torch(_stack(2))[k], seed=3,
                               leaf_offset=off)
        part = TTR.inject_wire(part, F, noisy, 5, leaf_offset=off)
        for a, b in zip(tree_leaves(part.payload),
                        tree_leaves(whole.payload[k])):
            assert torch.equal(a, b)
        for a, b in zip(tree_leaves(part.sidecar),
                        tree_leaves(whole.sidecar[k])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("f_eff", [0, 2])
def test_honest_dev_helpers_match_jax(f_eff):
    """Accumulated over two sub-trees, then finalised: JAX's value, and
    the stacked trainer's one-shot ``_honest_mean_dev`` over the whole
    tree bit for bit."""
    rng = np.random.default_rng(4)
    g = _stack(4)
    agg = {"a": {"w": rng.normal(size=(4, 6)).astype(np.float32)},
           "b": {"c": rng.normal(size=(5,)).astype(np.float32),
                 "d": rng.normal(size=(3,)).astype(np.float32)},
           "e": rng.normal(size=(7,)).astype(np.float32)}
    jz = jnp.zeros((), jnp.float32)
    jd, jr = jz, jz
    td = tr = 0.0
    for k in sorted(g):
        jd, jr = JTR.honest_dev_accumulate(
            jd, jr, jax.tree.map(jnp.asarray, agg[k]),
            jax.tree.map(jnp.asarray, g[k]), f_eff)
        td, tr = TTR.honest_dev_accumulate(td, tr, _torch(agg)[k],
                                           _torch(g)[k], f_eff)
    want = float(JTR.honest_dev_finalize(jd, jr))
    got = TTR.honest_dev_finalize(td, tr)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert _same(got, TTR._honest_mean_dev(_torch(agg), _torch(g), f_eff))


def test_as_trainer_state_coerces_as_jax():
    opt = TO.sgd(momentum=0.9)
    os_ = opt.init({"w": torch.zeros(3)})
    st = TTR.as_trainer_state(os_)
    assert isinstance(st, TTR.TrainerState) and st.opt is os_
    assert TTR.as_trainer_state(st) is st
    with pytest.raises(TypeError) as want:
        JTR.as_trainer_state((1, 2))
    with pytest.raises(TypeError) as got:
        TTR.as_trainer_state((1, 2))
    assert str(got.value) == str(want.value)


def test_streaming_step_takes_a_bare_opt_state(setup):
    _, tparams, _, tb = setup
    opt, step = _port_step(TST.make_streaming_train_step, scope="block",
                           attack="inf")
    p, st, _ = step(tparams, opt.init(tparams), tb, SEED0)
    assert isinstance(st, TTR.TrainerState) and st.opt.step == 1


@pytest.mark.parametrize("spec", ["qsgd:bits=8", "bf16", "topk:frac=0.2",
                                  "signsgd"])
def test_leaf_containers_and_raw_contrib_match_jax(spec):
    """``leaf_containers`` cuts a container into one per leaf with its
    leaf's bytes; ``encoded_raw_contrib`` of the whole container is
    JAX's, and the per-leaf contributions, added in leaf order, are the
    whole container's raw statistics bit for bit."""
    tree = _stack(5)
    jenc, _ = JC.get_codec(spec).encode(jax.tree.map(jnp.asarray, tree),
                                        key=jax.random.key(3))
    enc = TC.encoded_from_jax(jenc, device="cpu")
    parts = TC.leaf_containers(enc)
    assert len(parts) == len(enc.shapes)
    assert sum(p.wire_bytes for p in parts) == enc.wire_bytes
    want = JC.encoded_raw_contrib(jenc)
    got = TC.encoded_raw_contrib(enc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.max(np.abs(want))))
    for uk in (False, True):
        total = torch.zeros((N, N))
        for p in parts:
            total = total + TC.encoded_raw_contrib(p, use_kernels=uk)
        assert torch.equal(total, TC.encoded_raw_stats(
            enc, use_kernels=uk)[0])


# ============================================================ refusals
def _refusal(make, **kw):
    args = (ArchConfig(**TINY) if make.__module__.startswith("repro_torch")
            else JArch(**TINY),)
    if make.__module__.startswith("repro_torch"):
        args += (RobustConfig(n_workers=N, f=F), TO.sgd(), TS.constant(0.1))
    else:
        args += (JRobust(n_workers=N, f=F), JO.sgd(), JS.constant(0.1))
    return make(*args, **kw)


@pytest.mark.parametrize("kw,exc", [
    (dict(scope="layer"), ValueError),
    (dict(transforms=("clip",)), NotImplementedError),
    (dict(attack="adaptive_lie"), NotImplementedError),
    (dict(attack="adaptive_mimic"), NotImplementedError),
    (dict(codec="signsgd:ef=1"), NotImplementedError),
    (dict(codec="topk:frac=0.01,ef=1"), NotImplementedError),
    (dict(attack_f=3), ValueError),
])
def test_refusals_carry_jax_s_message(kw, exc):
    with pytest.raises(exc) as want:
        _refusal(JST.make_streaming_train_step, **kw)
    with pytest.raises(exc) as got:
        _refusal(TST.make_streaming_train_step, **kw)
    assert str(got.value) == str(want.value)


def test_wire_attack_without_a_codec_is_refused_as_in_jax():
    with pytest.raises(ValueError) as want:
        _refusal(JST.make_streaming_train_step, attack="scale_poison")
    with pytest.raises(ValueError) as got:
        _refusal(TST.make_streaming_train_step, attack="scale_poison")
    assert str(got.value).startswith(str(want.value))


@pytest.mark.parametrize("slot", ["tstates", "astate", "cres"])
def test_live_state_slots_are_refused_as_in_jax(setup, slot):
    import dataclasses
    _, tparams, _, tb = setup
    opt, step = _port_step(TST.make_streaming_train_step, scope="block")
    state = dataclasses.replace(TTR.init_train_state(opt, tparams),
                                **{slot: (1,) if slot == "tstates" else 1})
    with pytest.raises(NotImplementedError) as got:
        step(tparams, state, tb, SEED0)
    jopt = JO.sgd()
    jstep = _refusal(JST.make_streaming_train_step, scope="block")
    jstate = JTR.TrainerState(opt=jopt.init({"w": jnp.zeros(2)}),
                              **{slot: (jnp.ones(1),) if slot == "tstates"
                                 else jnp.ones(1)})
    with pytest.raises(NotImplementedError) as want:
        jstep({"w": jnp.zeros(2)}, jstate, {}, jax.random.key(0))
    assert str(got.value) == str(want.value)


def test_the_streaming_module_is_exported():
    from repro_torch import dist
    for name in ("make_streaming_train_step", "as_trainer_state",
                 "honest_dev_accumulate", "honest_dev_finalize"):
        assert callable(getattr(dist, name))
