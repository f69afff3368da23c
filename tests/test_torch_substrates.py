"""The two-step apply substrate of the port (``fused=False``,
``coord_chunk``), K3's plain version and the robust façade, against the
JAX package.

Inputs are made from a seed with numpy and handed to both sides.
Tolerances: K3's plain version against the Pallas kernel in interpret mode
``rtol=0, atol=1e-5`` (as ``tests/test_kernels.py`` holds the kernel to
its own reference); d-shaped aggregates within fp32 ``rtol=1e-6,
atol=1e-6·max(1, max|want|)`` (the two frameworks' matrix products sum in
other orders, an ulp apart); the selection outputs (``w_ext``, ``w_agr``,
the coordinate masks) identical.  Rows are spread apart (some scaled by
20) so that an ulp cannot flip a selection.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import RobustConfig as JRobust
from repro.core import api as JA
from repro.core import robust as JR
from repro.kernels.coord_select import coord_select_pallas
from repro_torch.configs import RobustConfig
from repro_torch.core import api as TA
from repro_torch.core import gar as TG
from repro_torch.core import robust as TR
from repro_torch.kernels import ops, ref
from repro_torch.kernels.coord_select import MAX_THETA
from repro_torch.tree import tree_items, tree_leaves

# the suite runs in several worker processes at once: one thread each
# keeps the port's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

EDGE_GRID = [(7, 1), (11, 2), (15, 3), (12, 2), (6, 0)]
COORD_GRID = [(5, 1), (8, 2), (16, 4), (30, 10), (7, 7)]
TOL = 1e-6


def _x(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[: max(1, n // 5)] *= 20.0           # some rows far out
    return x


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol=TOL):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _plan(n, f, seed=0):
    """A real multi-Bulyan plan from the port's plan code (held to the JAX
    one in test_torch_gar.py), as numpy."""
    theta = n - 2 * f - 2
    G = _t(_x(n, 64, seed))
    w_ext, w_agr = TG.extraction_plan(TG.pairwise_sqdist(G), f, theta)
    return w_ext.numpy(), w_agr.numpy(), theta - 2 * f


def _tree(n, seed):
    """A stacked tree of four leaves (35, 3, 24 and 1 coordinates), rows
    spread as :func:`_x` spreads them."""
    rng = np.random.default_rng(seed)
    s = np.ones(n, np.float32)
    s[: max(1, n // 5)] = 20.0

    def leaf(*shape):
        x = rng.normal(size=(n,) + shape).astype(np.float32)
        return x * s.reshape((n,) + (1,) * len(shape))

    return {"a": leaf(5, 7), "b": {"c": leaf(3), "w": leaf(4, 2, 3)},
            "z": leaf(1)}


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ttree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)


def _assert_tree_close(got, want, tol=TOL):
    jl = jax.tree.leaves(want)
    tl = tree_leaves(got)
    assert len(jl) == len(tl)
    for (path, t), j in zip(tree_items(got), jl):
        assert tuple(t.shape) == tuple(j.shape), path
        _close(t.numpy(), np.asarray(j), tol)


# ------------------------------------------------------------- K3 plain
@pytest.mark.parametrize("theta,beta", COORD_GRID)
@pytest.mark.parametrize("d", [1, 64, 1000, 2049])
def test_coord_select_plain_matches_pallas(theta, beta, d):
    rng = np.random.default_rng(theta * 10_000 + d)
    ge = rng.normal(size=(theta, d)).astype(np.float32)
    ga = rng.normal(size=(theta, d)).astype(np.float32)
    want = coord_select_pallas(jnp.asarray(ge), jnp.asarray(ga), beta,
                               d_tile=128, interpret=True)
    got = ref.coord_select_ref(_t(ge), _t(ga), beta)
    assert got.shape == (d,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_coord_select_plain_breaks_ties_to_the_lower_row():
    """Every agr value at the same distance from the median: the β lowest
    rows are taken (rows alternate +1 / -1, so the order shows)."""
    theta, d, beta = 6, 10, 3
    ge = np.zeros((theta, d), np.float32)
    ga = np.ones((theta, d), np.float32)
    ga[1::2] = -1.0
    want = coord_select_pallas(jnp.asarray(ge), jnp.asarray(ga), beta,
                               d_tile=128, interpret=True)
    got = ref.coord_select_ref(_t(ge), _t(ga), beta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got.numpy(),
                                  np.full(d, np.float32(1.0) / 3))
    ga1 = np.ones((theta, d), np.float32)
    assert torch.equal(ref.coord_select_ref(_t(ge), _t(ga1), beta),
                       torch.ones(d))


def test_coord_select_plain_beta_equals_theta_is_mean():
    theta, d = 9, 33
    rng = np.random.default_rng(9)
    ge = rng.normal(size=(theta, d)).astype(np.float32)
    ga = rng.normal(size=(theta, d)).astype(np.float32)
    got = ref.coord_select_ref(_t(ge), _t(ga), theta)
    want = coord_select_pallas(jnp.asarray(ge), jnp.asarray(ga), theta,
                               d_tile=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ga.mean(axis=0), rtol=1e-5,
                               atol=1e-6)


def test_coord_select_plain_is_chunk_invariant():
    rng = np.random.default_rng(3)
    ge = _t(rng.normal(size=(7, 1000)))
    ga = _t(rng.normal(size=(7, 1000)))
    base = ref.coord_select_ref(ge, ga, 3)
    for chunk in (1, 7, 128):
        assert torch.equal(ref.coord_select_ref(ge, ga, 3, chunk=chunk),
                           base)


@pytest.mark.parametrize("n,f", EDGE_GRID)
def test_fused_plain_is_the_row_order_contraction_then_coord_select(n, f):
    """K2's plain version is K3's on the row-order contraction, bit for
    bit: the two kernels share their coordinate phase."""
    w_ext, w_agr, beta = _plan(n, f, seed=n)
    x = _t(_x(n, 300, seed=n + 5))
    we, wa = _t(w_ext), _t(w_agr)
    ext = torch.zeros((we.shape[0], 300))
    agr = torch.zeros_like(ext)
    for i in range(n):
        ext = ext + we[:, i:i + 1] * x[i:i + 1]
        agr = agr + wa[:, i:i + 1] * x[i:i + 1]
    assert torch.equal(ref.fused_select_ref(x, we, wa, beta),
                       ref.coord_select_ref(ext, agr, beta))


def test_ops_coord_select_takes_plain_version_on_cpu():
    ops.reset_launch_counts()
    rng = np.random.default_rng(5)
    ge, ga = _t(rng.normal(size=(5, 300))), _t(rng.normal(size=(5, 300)))
    assert torch.equal(ops.coord_select(ge, ga, 1),
                       ref.coord_select_ref(ge, ga, 1))
    assert ops.launch_counts()["coord_select"] == 0


@pytest.mark.parametrize("shape_e,shape_a,beta,match", [
    ((3, 8), (4, 8), 1, "shapes differ"),
    ((3, 8, 1), (3, 8, 1), 1, "expected"),
    ((3, 8), (3, 8), 0, "beta"),
    ((3, 8), (3, 8), 4, "beta")])
def test_coord_select_rejects_what_pallas_rejects(shape_e, shape_a, beta,
                                                  match):
    with pytest.raises(ValueError, match=match):
        coord_select_pallas(jnp.zeros(shape_e), jnp.zeros(shape_a), beta,
                            interpret=True)
    with pytest.raises(ValueError, match=match):
        ops.coord_select(torch.zeros(shape_e), torch.zeros(shape_a), beta)


def test_coord_select_cuda_refuses_cpu_tensors():
    from repro_torch.kernels.coord_select import coord_select_cuda
    with pytest.raises(ValueError, match="CUDA"):
        coord_select_cuda(torch.zeros((5, 64)), torch.zeros((5, 64)), 1)
    assert MAX_THETA == 32


# ------------------------------------------------ the two-step substrate
@pytest.mark.parametrize("n,f", EDGE_GRID)
@pytest.mark.parametrize("shape", [(1,), (100,), (257,), (3, 43)])
def test_two_step_leaf_matches_jax(n, f, shape):
    """``_bulyan_leaf(use_kernels=True, fused=False)`` (matrix products +
    K3's plain version) against JAX's ``use_pallas=True, fused=False``
    (XLA products + the Pallas coord_select in interpret mode)."""
    w_ext, w_agr, beta = _plan(n, f, seed=n + 1)
    x = _x(n, int(np.prod(shape)), seed=7 * n + shape[-1]).reshape(
        (n,) + shape)
    want = JA._bulyan_leaf(jnp.asarray(w_ext), jnp.asarray(w_agr), beta,
                           jnp.asarray(x), use_pallas=True, fused=False)
    got = TA._bulyan_leaf(_t(w_ext), _t(w_agr), beta, _t(x),
                          use_kernels=True, fused=False)
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want))


def test_bulyan_leaf_dispatch(monkeypatch):
    """K2 under kernels with ``fused`` (True or "force", with or without
    a chunk); K3 once per leaf with ``fused=False``, once per slice with
    ``coord_chunk``; neither without kernels."""
    calls = []
    real_fs, real_cs = ops.fused_select, ops.coord_select
    monkeypatch.setattr(ops, "fused_select", lambda *a: (
        calls.append("fused_select"), real_fs(*a))[1])
    monkeypatch.setattr(ops, "coord_select", lambda *a: (
        calls.append(("coord_select", a[0].shape[1])), real_cs(*a))[1])
    w_ext, w_agr, beta = (_t(a) if i < 2 else a
                          for i, a in enumerate(_plan(11, 2)))
    x = _t(_x(11, 100, seed=1))
    cases = [
        (dict(use_kernels=True), ["fused_select"]),
        (dict(use_kernels=True, fused="force"), ["fused_select"]),
        (dict(use_kernels=True, coord_chunk=16), ["fused_select"]),
        (dict(use_kernels=True, fused=False), [("coord_select", 100)]),
        (dict(use_kernels=True, fused=False, coord_chunk=30),
         [("coord_select", 30)] * 3 + [("coord_select", 10)]),
        (dict(use_kernels=True, fused=False, coord_chunk=100),
         [("coord_select", 100)]),
        (dict(coord_chunk=16), []),
        (dict(), []),
    ]
    outs = []
    for kw, want in cases:
        calls.clear()
        outs.append(TA._bulyan_leaf(w_ext, w_agr, beta, x, **kw))
        assert calls == want, kw
    for out in outs[1:]:
        _close(out.numpy(), outs[0].numpy())


@pytest.mark.parametrize("chunk", [4, 16, 10_000])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_coord_chunk_leaf_matches_jax(chunk, use_kernels):
    n, f = 11, 2
    w_ext, w_agr, beta = _plan(n, f, seed=3)
    x = _x(n, 5 * 7, seed=chunk).reshape(n, 5, 7)
    want = JA._bulyan_leaf(jnp.asarray(w_ext), jnp.asarray(w_agr), beta,
                           jnp.asarray(x), coord_chunk=chunk,
                           use_pallas=use_kernels, fused=False)
    got = TA._bulyan_leaf(_t(w_ext), _t(w_agr), beta, _t(x),
                          coord_chunk=chunk, use_kernels=use_kernels,
                          fused=False)
    _close(got.numpy(), np.asarray(want))
    whole = TA._bulyan_leaf(_t(w_ext), _t(w_agr), beta, _t(x),
                            use_kernels=use_kernels, fused=False)
    # columns are independent: a slice computes what the whole leaf does
    _close(got.numpy(), whole.numpy(), tol=1e-7)


@pytest.mark.parametrize("chunk", [4, 16, 10_000])
@pytest.mark.parametrize("use_kernels,fused", [(False, True), (True, False)])
def test_coord_chunk_tree_matches_jax(chunk, use_kernels, fused):
    n, f = 11, 2
    tree = _tree(n, seed=chunk)
    want = JA.aggregate_tree(_jtree(tree), f, "multi_bulyan",
                             coord_chunk=chunk, use_pallas=use_kernels,
                             fused=fused)
    got = TA.aggregate_tree(_ttree(tree), f, "multi_bulyan",
                            coord_chunk=chunk, use_kernels=use_kernels,
                            fused=fused)
    _assert_tree_close(got, want)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_tree_plan_is_identical_to_jax(use_kernels):
    """The selection the substrates apply: the same w_ext / w_agr from
    both packages' statistics on the same tree."""
    n, f = 11, 2
    tree = _tree(n, seed=4)
    jagg, tagg = JA.get_aggregator("multi_bulyan"), \
        TA.get_aggregator("multi_bulyan")
    jplan = jagg.plan(JA.compute_stats(_jtree(tree), f,
                                       use_pallas=use_kernels))
    tplan = tagg.plan(TA.compute_stats(_ttree(tree), f,
                                       use_kernels=use_kernels))
    np.testing.assert_array_equal(tplan.w_ext.numpy(),
                                  np.asarray(jplan.w_ext))
    np.testing.assert_array_equal(tplan.w_agr.numpy(),
                                  np.asarray(jplan.w_agr))
    assert tplan.beta == jplan.beta


def test_backend_and_call_carry_the_substrate_options(monkeypatch):
    calls = []
    real = ops.coord_select
    monkeypatch.setattr(ops, "coord_select", lambda *a: (
        calls.append(a[0].shape[1]), real(*a))[1])
    tree = _ttree(_tree(11, seed=6))
    backend = TA.AggregatorBackend("multi_bulyan", 2, fused=False,
                                   coord_chunk=16)
    stats = backend.stats(tree)
    plan = backend.plan(stats)
    out_b = backend.apply(plan, tree)
    numels = [int(np.prod(x.shape[1:])) for x in tree_leaves(tree)]
    want = [c for m in numels for c in
            ([16] * (m // 16) + ([m % 16] if m % 16 else [])
             if m > 16 else [m])]
    assert calls == want
    calls.clear()
    agg = TA.get_aggregator("multi_bulyan")
    out_c = agg(tree, 2, coord_chunk=16)          # no kernels: no K3
    assert calls == []
    _assert_tree_close(out_b, jax.tree.map(lambda t: t.numpy(), out_c))
    out_m = TA.aggregate_matrix(tree["a"].reshape(11, -1), 2,
                                use_kernels=True, fused=False,
                                dists=stats.dists)
    _close(out_m.numpy(), out_b["a"].reshape(-1).numpy())


# ------------------------------------------------------- robust façade
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("coord_chunk", [0, 16])
def test_robust_aggregator_without_transforms_matches_jax(use_kernels,
                                                          coord_chunk):
    n, f = 11, 2
    tree = _tree(n, seed=8)
    jagg = JR.RobustAggregator(JRobust(n_workers=n, f=f,
                                       use_pallas=use_kernels),
                               coord_chunk=coord_chunk)
    tagg = TR.RobustAggregator(RobustConfig(n_workers=n, f=f,
                                            use_kernels=use_kernels),
                               coord_chunk=coord_chunk)
    _assert_tree_close(tagg(_ttree(tree)), jagg(_jtree(tree)))
    _assert_tree_close(
        TR.tree_aggregate(_ttree(tree), f, coord_chunk=coord_chunk,
                          use_kernels=use_kernels),
        JR.tree_aggregate(_jtree(tree), f, coord_chunk=coord_chunk,
                          use_pallas=use_kernels))
    jd, td = jagg.diagnostics(_jtree(tree)), tagg.diagnostics(_ttree(tree))
    assert set(jd) == set(td)
    for k in jd:
        _close(float(td[k]), float(jd[k]), tol=1e-5)
    _close(TR.tree_pairwise_sqdist(_ttree(tree)).numpy(),
           np.asarray(JR.tree_pairwise_sqdist(_jtree(tree))), tol=1e-5)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_robust_aggregator_with_transforms_matches_jax(use_kernels):
    """Clip, worker momentum and nn_mix before multi-Bulyan, the state
    threaded over two calls; outputs and states against JAX."""
    n, f = 11, 2
    cfgs = (JRobust(n_workers=n, f=f, use_pallas=use_kernels),
            RobustConfig(n_workers=n, f=f, use_kernels=use_kernels))
    jagg = JR.RobustAggregator(cfgs[0], coord_chunk=16, transforms=(
        JA.ClipByNorm(max_norm=30.0), JA.WorkerMomentum(beta=0.9),
        JA.NearestNeighborMix(k=3)))
    tagg = TR.RobustAggregator(cfgs[1], coord_chunk=16, transforms=(
        TA.ClipByNorm(max_norm=30.0), TA.WorkerMomentum(beta=0.9),
        TA.NearestNeighborMix(k=3)))
    first = _tree(n, seed=10)
    jst = jagg.init_transform_states(_jtree(first))
    tst = tagg.init_transform_states(_ttree(first))
    assert jst[0] is None and tst[0] is None and tst[2] is None
    for step in range(2):
        tree = _tree(n, seed=10 + step)
        jout, jst = jagg(_jtree(tree), states=jst, key=jax.random.key(step))
        tout, tst = tagg(_ttree(tree), states=tst, seed=step)
        _assert_tree_close(tout, jout, tol=1e-5)
        _assert_tree_close(tst[1], jst[1], tol=1e-5)
        assert tst[0] is None and tst[2] is None
