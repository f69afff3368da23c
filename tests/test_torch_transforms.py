"""The pre-aggregation transforms of the port and the trainer's transform
stage, against the JAX package.

Inputs are made from a seed with numpy and handed to both sides.
Tolerances: transformed stacks and states within fp32 ``rtol=1e-6,
atol=1e-6·max(1, max|want|)`` (the mixing products sum in other orders);
the nearest-neighbour mixing matrix, which is a selection, identical.  The
two trainer steps hold parameters and ``tstates`` to ``rtol=1e-4,
atol=1e-6`` (1e-4 relative for the forged 1e30-scale rows), as
``tests/test_torch_trainer.py`` holds one plain step.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import models as JMD
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import RobustConfig as JRobust
from repro.core import api as JA
from repro.data.synthetic import make_lm_batch
from repro.dist import trainer as JTR
from repro.models import modules as JM
from repro.optim import optimizers as JO
from repro.optim import schedules as JS
from repro_torch import models as TMD
from repro_torch.configs import ArchConfig, RobustConfig
from repro_torch.core import api as TA
from repro_torch.dist import trainer as TTR
from repro_torch.optim import optimizers as TO
from repro_torch.optim import schedules as TS
from repro_torch.tree import tree_items, tree_leaves

# the suite runs in several worker processes at once: one thread each
# keeps the port's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

N, F, SEQ = 11, 2, 16
TOL = 1e-6
TINY = dict(name="tiny-qwen", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128,
            qkv_bias=True, tie_embeddings=True, rope_theta=1e6)


def _close(got, want, tol=TOL, atol=None):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if atol is None:
        fin = want[np.isfinite(want)]
        atol = tol * max(1.0, float(np.max(np.abs(fin))) if fin.size
                         else 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


def _stack(seed, inf_rows=0):
    """A stacked tree (leaves (N, 4, 6), (N, 5), (N, 1)); the first
    ``inf_rows`` rows forged as the ``inf`` attack forges them (1e30)."""
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(size=(N, 4, 6)).astype(np.float32),
            "b": {"c": rng.normal(size=(N, 5)).astype(np.float32)},
            "z": rng.normal(size=(N, 1)).astype(np.float32)}
    for leaf in jax.tree.leaves(tree):
        leaf *= (1.0 + 0.5 * np.arange(N, dtype=np.float32)).reshape(
            (N,) + (1,) * (leaf.ndim - 1))
        leaf[:inf_rows] = 1e30
    return tree


def _jt(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tt(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_tree_close(got, want, **kw):
    jl = jax.tree.leaves(want)
    assert len(jl) == len(tree_leaves(got))
    for (path, t), j in zip(tree_items(got), jl):
        assert tuple(t.shape) == tuple(j.shape), path
        _close(t.numpy(), np.asarray(j), **kw)


# ------------------------------------------------------------ transforms
@pytest.mark.parametrize("max_norm", [0.5, 5.0, 1e6])
def test_clip_by_norm_matches_jax(max_norm):
    tree = _stack(1)
    jout, jst = JA.ClipByNorm(max_norm=max_norm)(_jt(tree))
    tout, tst = TA.ClipByNorm(max_norm=max_norm)(_tt(tree))
    assert jst is None and tst is None
    _assert_tree_close(tout, jout)
    norms = np.sqrt(sum(np.sum(t.numpy().reshape(N, -1) ** 2, axis=1)
                        for t in tree_leaves(tout)))
    assert np.all(norms <= max_norm * (1 + 1e-6))


@pytest.mark.parametrize("inf_rows", [0, F])
def test_worker_momentum_state_over_two_calls_matches_jax(inf_rows):
    jt, tt = JA.WorkerMomentum(beta=0.9), TA.WorkerMomentum(beta=0.9)
    first = _stack(2, inf_rows)
    jst, tst = jt.init(_jt(first)), tt.init(_tt(first))
    for t in tree_leaves(tst):
        assert t.dtype == torch.float32 and not bool(t.any())
    for call in range(2):
        tree = _stack(2 + call, inf_rows)
        tgrads = _tt(tree)
        jout, jst = jt(_jt(tree), state=jst)
        tout, new = tt(tgrads, state=tst)
        _assert_tree_close(tout, jout)
        _assert_tree_close(new, jst)
        # the old state is left as it was: a fresh tensor each call
        for old, nw in zip(tree_leaves(tst), tree_leaves(new)):
            assert old.data_ptr() != nw.data_ptr()
        tst = new
    with pytest.raises(ValueError, match="needs a state"):
        tt(_tt(first))


def _mix_matrix(mix, dists, lib):
    """The (n, n) mixing matrix: ``mix`` applied to the identity stack."""
    n = dists.shape[0]
    if lib is JA:
        out, _ = mix(jnp.eye(n, dtype=jnp.float32),
                     stats=JA.AggStats(n=n, f=0, dists=jnp.asarray(dists)))
        return np.asarray(out)
    out, _ = mix(torch.eye(n), stats=TA.AggStats(
        n=n, f=0, dists=torch.from_numpy(dists)))
    return out.numpy()


def _dists(kind):
    rng = np.random.default_rng(4)
    a = rng.random((N, N)).astype(np.float32)
    d = (a + a.T) * (1.0 - np.eye(N, dtype=np.float32))
    if kind == "tied":                 # every off-diagonal distance equal
        d = 1.0 - np.eye(N, dtype=np.float32)
        d[3, 7] = d[7, 3] = 0.5
    elif kind == "inf":                # two rows far out, inf from all
        d[:2, :] = d[:, :2] = np.inf
        d[0, 0] = d[1, 1] = 0.0
    elif kind == "inf_attack":         # the inf attack's overflow pattern:
        d[:2, :] = d[:, :2] = np.inf   # inf to honest rows, NaN (inf - inf)
        d[:2, :2] = np.nan             # among the forged ones and on their
    elif kind == "nan":                # own diagonal (NaN x 0)
        d[rng.random((N, N)) < 0.15] = np.nan
        d[5, :] = np.inf
    return d


@pytest.mark.parametrize("kind", ["random", "tied", "inf", "inf_attack",
                                  "nan"])
@pytest.mark.parametrize("k", [1, 3, 20])
def test_nn_mix_matrix_matches_jax(kind, k):
    """Stable ranks, NaN last, as ``jnp.argsort``: the same neighbours."""
    d = _dists(kind)
    want = _mix_matrix(JA.NearestNeighborMix(k=k), d, JA)
    got = _mix_matrix(TA.NearestNeighborMix(k=k), d, TA)
    np.testing.assert_array_equal(got, want)
    kk = min(k, N)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-6)
    assert np.all((got == 0) | (got == np.float32(1.0 / kk)))
    if kind == "inf_attack" and k == 3:
        # a forged row's nearest are the first rows at inf: honest 2, 3, 4
        np.testing.assert_array_equal(np.nonzero(got[0])[0], [2, 3, 4])
        np.testing.assert_array_equal(np.nonzero(got[1])[0], [2, 3, 4])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_nn_mix_on_an_inf_attacked_momentum_stack_matches_jax(use_kernels):
    """Momentum of a stack whose first F rows are forged at 1e30 (their
    squared norms overflow), then nn_mix on its own distances: the forged
    rows become means of honest rows, as in the JAX package."""
    jts = (JA.WorkerMomentum(beta=0.9), JA.NearestNeighborMix(k=3))
    tts = (TA.WorkerMomentum(beta=0.9), TA.NearestNeighborMix(k=3))
    tree = _stack(5, inf_rows=F)
    jst = JA.init_transform_states(jts, _jt(tree))
    tst = TA.init_transform_states(tts, _tt(tree))
    for call in range(2):
        jout, jst = JA.apply_transforms(_jt(tree), jts, jst,
                                        key=jax.random.key(call))
        tout, tst = TA.apply_transforms(_tt(tree), tts, tst, seed=call,
                                        use_kernels=use_kernels)
        _assert_tree_close(tout, jout)
        _assert_tree_close(tst[0], jst[0])
        assert tst[1] is None
        for leaf in tree_leaves(tout):
            assert bool(torch.isfinite(leaf).all())
            assert float(leaf[:F].abs().max()) < 1e3   # forged rows mixed


def test_apply_transforms_chains_two_and_passes_through_none():
    jts = (JA.ClipByNorm(max_norm=2.0), JA.NearestNeighborMix(k=4))
    tts = (TA.ClipByNorm(max_norm=2.0), TA.NearestNeighborMix(k=4))
    tree = _stack(6)
    jout, jst = JA.apply_transforms(_jt(tree), jts)
    tout, tst = TA.apply_transforms(_tt(tree), tts, seed=3)
    _assert_tree_close(tout, jout)
    assert jst == tst == (None, None)
    grads = _tt(tree)
    assert TA.apply_transforms(grads, ()) == (grads, ())
    assert set(TA.TRANSFORMS) == set(JA.TRANSFORMS)
    for name, cls in TA.TRANSFORMS.items():
        assert cls().name == JA.TRANSFORMS[name]().name == name
        assert cls().stateful == JA.TRANSFORMS[name]().stateful
        assert cls().needs_dists == JA.TRANSFORMS[name]().needs_dists


def test_nn_mix_needs_distances():
    with pytest.raises(ValueError, match="distance matrix"):
        TA.NearestNeighborMix()(_tt(_stack(1)))


# ------------------------------------------------------------- trainer
@pytest.fixture
def fp32_jax(monkeypatch):
    """The JAX package casts activations to bf16 at the embedding; the fp32
    parity runs cast to fp32 there instead."""
    monkeypatch.setattr(JM, "embedding_apply", functools.partial(
        JM.embedding_apply, dtype=jnp.float32))


def _setup():
    jcfg = JArch(**TINY)
    tcfg = ArchConfig(**TINY, dtype="float32")
    jparams = JMD.init_model(jax.random.key(0), jcfg)
    tparams = TMD.params_from_jax(
        jax.tree.map(np.asarray, jparams), device="cpu")
    batches = [{k: np.asarray(v) for k, v in make_lm_batch(
        jax.random.key(1 + i), TINY["vocab_size"], N, SEQ).items()}
        for i in range(2)]
    return jcfg, tcfg, jparams, tparams, batches


def _two_steps(jtransforms, ttransforms, *, attack="inf", coord_chunk=0,
               use_kernels=True):
    jcfg, tcfg, jparams, tparams, batches = _setup()
    opt_j, opt_t = JO.sgd(momentum=0.9), TO.sgd(momentum=0.9)
    jstep = jax.jit(JTR.make_train_step(
        jcfg, JRobust(n_workers=N, f=F), opt_j, JS.constant(0.05),
        chunk_q=SEQ, attack=attack, transforms=jtransforms,
        coord_chunk=coord_chunk, telemetry=True))
    tstep = TTR.make_train_step(
        tcfg, RobustConfig(n_workers=N, f=F, use_kernels=use_kernels),
        opt_t, TS.constant(0.05), chunk_q=SEQ, attack=attack,
        transforms=ttransforms, coord_chunk=coord_chunk, telemetry=True)
    jstate = JTR.init_train_state(opt_j, jparams, jtransforms, n_workers=N)
    tstate = TTR.init_train_state(opt_t, tparams, ttransforms, n_workers=N)
    for i, batch in enumerate(batches):
        jparams, jstate, jm = jstep(
            jparams, jstate,
            JTR.split_workers({k: jnp.asarray(v) for k, v in batch.items()},
                              N), jax.random.key(10 + i))
        tparams, tstate, tm = tstep(
            tparams, tstate,
            TTR.split_workers({k: torch.tensor(v).long()
                               for k, v in batch.items()}, N), 10 + i)
        np.testing.assert_allclose(tm["loss_per_worker"].numpy(),
                                   np.asarray(jm["loss_per_worker"]),
                                   rtol=1e-4)
        np.testing.assert_array_equal(
            tm["telemetry"]["selection"].numpy(),
            np.asarray(jm["telemetry"]["selection"]))
        _assert_tree_close(tparams, jparams, tol=1e-4, atol=1e-6)
    return jstate, tstate, tm


@pytest.mark.parametrize("attack", ["sign_flip", "inf"])
def test_two_train_steps_with_worker_momentum_match_jax(fp32_jax, attack):
    """Parameters and the momentum state after two steps.  Under ``inf``
    a forged row holds 1e30·sign(honest mean) at each coordinate, a step
    function of the honest gradients: where that mean is 0 within the two
    frameworks' rounding, the packages forge opposite signs (seen at 2 of
    the 704 coordinates of one leaf), so there the forged rows are held to
    the values momentum can give them (|m| = 1e29 or 1.9e30 after two
    steps) and the honest rows to JAX; ``sign_flip``, continuous in the
    gradients, holds every row to JAX."""
    jstate, tstate, tm = _two_steps((JA.WorkerMomentum(0.9),),
                                    (TA.WorkerMomentum(0.9),), attack=attack)
    assert len(tstate.tstates) == len(jstate.tstates) == 1
    if attack == "sign_flip":
        _assert_tree_close(tstate.tstates[0], jstate.tstates[0], tol=1e-4,
                           atol=1e-6)
    else:
        honest = jax.tree.map(lambda x: x[F:], jstate.tstates[0])
        _assert_tree_close(jax.tree.map(lambda t: t[F:], tstate.tstates[0]),
                           honest, tol=1e-4, atol=1e-6)
        for leaf in tree_leaves(tstate.tstates[0]):
            mag = leaf[:F].abs().double().numpy()
            assert np.all(np.isclose(mag, 1e29, rtol=1e-6) |
                          np.isclose(mag, 1.9e30, rtol=1e-6))
        assert float(tm["telemetry"]["byz_mass"]) == 0.0
    assert tstate.opt.step == 2


def test_two_train_steps_with_nn_mix_match_jax(fp32_jax):
    """nn_mix turns the forged rows into means of honest rows; the rule
    then sees what the defence made of them, in both packages."""
    jstate, tstate, tm = _two_steps((JA.NearestNeighborMix(3),),
                                    (TA.NearestNeighborMix(3),))
    assert tstate.tstates == (None,) and len(jstate.tstates) == 1
    assert np.isfinite(float(tm["telemetry"]["honest_dev"]))


def test_two_train_steps_with_coord_chunk_match_jax(fp32_jax):
    """The trainer's ``coord_chunk`` takes the chunked two-step apply
    (without kernels, as the JAX package's ``use_pallas=False``)."""
    _, tstate, _ = _two_steps((), (), coord_chunk=64, use_kernels=False)
    assert tstate.tstates == ()


def test_init_train_state_fills_tstates_only_for_stateful_transforms():
    params = {"w": torch.zeros(3, 2)}
    opt = TO.sgd()
    assert TTR.init_train_state(opt, params).tstates == ()
    st = TTR.init_train_state(opt, params, (TA.NearestNeighborMix(3),),
                              n_workers=4)
    assert st.tstates == ()
    st = TTR.init_train_state(
        opt, params, (TA.ClipByNorm(), TA.WorkerMomentum(0.5)), n_workers=4)
    assert st.tstates[0] is None
    assert tuple(st.tstates[1]["w"].shape) == (4, 3, 2)
    with pytest.raises(ValueError, match="n_workers"):
        TTR.init_train_state(opt, params, (TA.WorkerMomentum(),))
