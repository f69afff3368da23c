"""K1 (pairwise_stats), K2 (fused_select), K5 (dequant_stats) and K3
(coord_select) of the port, K2 and K3 at every θ (the network and
counted variants above 32 included).

On the CPU the plain PyTorch versions (``repro_torch.kernels.ref``) are
held to the Pallas kernels run in interpret mode, over the edge grid of
``tests/test_kernels.py`` (n not a multiple of 8, d not a multiple of 128,
even θ, β = θ, d = 1), and K2's plain version to the XLA ``_bulyan_leaf``
of the JAX package.
Tolerance: fp32 ``atol=1e-5·scale, rtol=1e-5``.  On stacks that hold NaN,
±inf, ±0 and 1e30 the plain versions are held to the Pallas kernels with
NaN and ±inf at the same places and the finite values within ``rtol=1e-5,
atol=1e-5`` each (the two contractions sum in other orders).  The tests
marked ``cuda`` hold the CUDA kernels to their plain versions, bit for
bit for K2 and K3 (NaN at the same places); they need a card and ``nvcc``
and skip elsewhere.  K3's plain version is held to the
Pallas kernel in ``tests/test_torch_substrates.py``.  JAX is imported only by the tests that
use it, so on a GPU machine without JAX the card tests run with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""
import ctypes
import types

import numpy as np
import pytest
import torch

from repro_torch.core import gar as TG
from repro_torch.kernels import build, ops, ref, select_cases
from repro_torch.kernels.coord_select import coord_select_cuda
from repro_torch.kernels.dequant_stats import dequant_stats_cuda
from repro_torch.kernels import fused_select as K2
from repro_torch.kernels.fused_select import MAX_THETA, fused_select_cuda
from repro_torch.kernels.pairwise_sqdist import (launch_config,
                                                 pairwise_stats_cuda)

# the suite runs in several worker processes at once: one thread each
# keeps the port's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

EDGE_GRID = [(7, 1), (11, 2), (15, 3), (12, 2), (6, 0)]


def _x(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[: max(1, n // 5)] *= 20.0           # some rows far out
    return x


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels and apply path (Pallas in interpret mode)."""
    import jax.numpy as jnp
    from repro.core import api
    from repro.kernels.coord_select import coord_select_pallas
    from repro.kernels.fused_select import fused_select_pallas
    from repro.kernels.pairwise_sqdist import pairwise_stats_pallas
    return types.SimpleNamespace(jnp=jnp, api=api,
                                 fused_select=fused_select_pallas,
                                 coord_select=coord_select_pallas,
                                 pairwise_stats=pairwise_stats_pallas)


def _plan(n, f, seed=0):
    """A real multi-Bulyan extraction plan (θ one-hots + averages), from
    the port's plan code (held to the JAX one in test_torch_gar.py)."""
    theta = n - 2 * f - 2
    G = torch.from_numpy(_x(n, 64, seed))
    w_ext, w_agr = TG.extraction_plan(TG.pairwise_sqdist(G), f, theta)
    return w_ext.numpy(), w_agr.numpy(), theta - 2 * f


def _close(got, want, tol=1e-5):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


# ------------------------------------------------------------------- K1
@pytest.mark.parametrize("n", [3, 11, 13, 17])
@pytest.mark.parametrize("d", [1, 100, 257, 3000])
def test_pairwise_stats_plain_matches_pallas(jx, n, d):
    x = _x(n, d, seed=n * 1000 + d)
    want_d, want_s = jx.pairwise_stats(jx.jnp.asarray(x), d_tile=512,
                                       interpret=True)
    got_d, got_s = ref.pairwise_stats_ref(_t(x))
    assert got_d.shape == (n, n) and got_s.shape == (n,)
    assert got_d.dtype == got_s.dtype == torch.float32
    _close(got_d.numpy(), np.asarray(want_d))
    _close(got_s.numpy(), np.asarray(want_s))


def test_pairwise_stats_raw_contract_keeps_the_diagonal():
    """Raw: sq_i + sq_j - 2 gram with no clamp and no zeroed diagonal
    (finalised once, after the sum over leaves).  The sums are rounded
    once, so a finite row's own entry is exactly 0: the diagonal shows
    itself kept where a row holds inf (inf - inf = NaN, not 0), and the
    missing clamp where the fp32 formula on exact sums is negative."""
    x = _x(5, 300, seed=1).astype(np.float64)
    raw, sq = ref.pairwise_stats_ref(_t(x))
    sq64 = np.sum(x * x, axis=1)
    _close(raw.numpy(), sq64[:, None] + sq64[None, :] - 2.0 * (x @ x.T))
    _close(sq.numpy(), sq64)
    # exact: 0.01; the sums round to 2^24, 2^24 + 2 and 2^24 + 2
    raw, _ = ref.pairwise_stats_ref(_t([[4096.0, 1.0], [4096.0, 1.1]]))
    assert float(raw[0, 1]) < 0.0
    z = np.ones((3, 4), np.float32)
    z[1, 2] = np.inf
    raw, _ = ref.pairwise_stats_ref(_t(z))
    assert np.isnan(float(raw[1, 1])) and float(raw[0, 0]) == 0.0


def test_pairwise_stats_plain_chunks_agree():
    x = _t(_x(11, 5000, seed=6))
    one = ref.pairwise_stats_ref(x)
    for chunk in (1, 999):
        for a, b in zip(ref.pairwise_stats_ref(x, chunk=chunk), one):
            _close(a.numpy(), b.numpy())


def test_ops_pairwise_stats_takes_plain_version_on_cpu():
    ops.reset_launch_counts()
    x = _t(_x(11, 100, seed=2))
    for a, b in zip(ops.pairwise_stats(x), ref.pairwise_stats_ref(x)):
        assert torch.equal(a, b)
    assert ops.launch_counts() == {"pairwise_stats": 0, "fused_select": 0,
                                   "dequant_stats": 0, "coord_select": 0,
                                   "pairwise_stats_rect": 0,
                                   "dequant_stats_rect": 0,
                                   "pairwise_sqdist": 0}


@pytest.mark.parametrize("n,d,want", [
    (1, 1, (8, 1)), (8, 10_000, (8, 40)), (11, 1_000_000, (12, 1056)),
    (16, 256, (16, 1)), (17, 1_000_000, (8, 176)),
    (33, 233_373_696, (8, 71)), (11, 233_373_696, (12, 1056))])
def test_k1_launch_config(n, d, want):
    """One diagonal tile of 8/12/16 rows up to n = 16, 8-row tile pairs
    above; chunks fill the card, one per 256 columns at most."""
    assert launch_config(n, d) == want


def test_k1_launch_config_respects_scratch_cap():
    from repro_torch.kernels import pairwise_sqdist as K1
    row_tile, chunks = launch_config(2000, 10 ** 9)
    assert chunks * 4 * 2000 * 2000 <= K1.MAX_SCRATCH_BYTES
    assert row_tile == 8 and chunks >= 1


# ------------------------------------------------------------------- K2
@pytest.mark.parametrize("n,f", EDGE_GRID)
@pytest.mark.parametrize("d", [1, 100, 257])
def test_fused_select_plain_matches_pallas(jx, n, f, d):
    w_ext, w_agr, beta = _plan(n, f, seed=n)
    x = _x(n, d, seed=10 * n + d)
    jnp = jx.jnp
    want = jx.fused_select(jnp.asarray(x), jnp.asarray(w_ext),
                           jnp.asarray(w_agr), beta, d_tile=128,
                           interpret=True)
    got = ref.fused_select_ref(_t(x), _t(w_ext), _t(w_agr), beta)
    assert got.shape == (d,) and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,f", EDGE_GRID)
def test_fused_select_plain_matches_xla_bulyan_leaf(jx, n, f):
    w_ext, w_agr, beta = _plan(n, f, seed=n + 1)
    x = _x(n, 2500, seed=n + 2)
    jnp = jx.jnp
    want = jx.api._bulyan_leaf(jnp.asarray(w_ext), jnp.asarray(w_agr), beta,
                               jnp.asarray(x), use_pallas=False)
    got = ref.fused_select_ref(_t(x), _t(w_ext), _t(w_agr), beta)
    _close(got.numpy(), np.asarray(want))


def test_fused_select_plain_is_chunk_invariant():
    """Columns are independent: any cut of d gives the same bits."""
    w_ext, w_agr, beta = _plan(11, 2)
    x = _t(_x(11, 1000, seed=3))
    base = ref.fused_select_ref(x, _t(w_ext), _t(w_agr), beta)
    for chunk in (1, 7, 128):
        assert torch.equal(ref.fused_select_ref(
            x, _t(w_ext), _t(w_agr), beta, chunk=chunk), base)


def test_fused_select_beta_equals_theta_is_mean():
    w_ext, w_agr, beta = _plan(6, 0)
    assert beta == w_ext.shape[0]
    x = _t(_x(6, 50, seed=4))
    got = ref.fused_select_ref(x, _t(w_ext), _t(w_agr), beta)
    want = torch.mean(_t(w_agr) @ x, dim=0)
    _close(got.numpy(), want.numpy())


def test_ops_fused_select_takes_plain_version_on_cpu():
    ops.reset_launch_counts()
    w_ext, w_agr, beta = _plan(11, 2)
    x = _t(_x(11, 300, seed=5))
    assert torch.equal(ops.fused_select(x, _t(w_ext), _t(w_agr), beta),
                       ref.fused_select_ref(x, _t(w_ext), _t(w_agr), beta))
    assert ops.launch_counts()["fused_select"] == 0
    assert ops.fused_select_variant_counts() == {}


# ------------------------------------------------- non-finite K2 and K3
SPECIALS = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30], np.float32)


def _synthetic_plan(theta, n, seed, signed=False):
    """(θ, n) weights as a multi-Bulyan plan shapes them: ``w_ext`` one-hot
    (rows drawn with repeats, so extracted values tie), ``w_agr`` uniform
    1/m over m drawn rows (every third slot repeats the one before, so
    distances tie).  ``signed``: a dense N(0, 1) ``w_agr`` instead, so an
    inf row gives +inf and -inf aggregates with no NaN among them."""
    rng = np.random.default_rng(seed)
    w_ext = np.zeros((theta, n), np.float32)
    w_ext[np.arange(theta), rng.integers(0, n, size=theta)] = 1.0
    if signed:
        return w_ext, rng.normal(size=(theta, n)).astype(np.float32)
    w_agr = np.zeros((theta, n), np.float32)
    for t in range(theta):
        if t % 3 == 2:
            w_agr[t] = w_agr[t - 1]
            continue
        rows = rng.choice(n, size=int(rng.integers(1, n + 1)), replace=False)
        w_agr[t, rows] = np.float32(1.0) / np.float32(len(rows))
    return w_ext, w_agr


def _non_finite_stack(n, d, seed):
    """(n, d) N(0, 1) with special values at chosen places: column j holds
    SPECIALS[j % 6] in ``j % 4`` rows (rows (3 j + 5 k) mod n), so some
    columns are clean, some carry one special and some several (NaN in
    most rows of a column drives the median to NaN)."""
    x = _x(n, d, seed)
    for j in range(d):
        for k in range(j % 4):
            x[(3 * j + 5 * k) % n, j] = SPECIALS[j % 6]
    x[:, 6 * (d // 12):6 * (d // 12) + 6] = SPECIALS[None, :]   # whole columns
    return x


def _non_finite_coord(theta, d, seed):
    """(θ, d) g_ext / g_agr with specials at chosen places; in column j of
    g_ext, ``j % (θ + 1)`` rows are NaN (from none to every row, past the
    θ - ⌊θ/2⌋ NaNs that make the median NaN); g_agr as
    :func:`_non_finite_stack` places them."""
    ge = _non_finite_stack(theta, d, seed)
    ge[np.isnan(ge)] = 1.0
    for j in range(d):
        ge[np.arange(j % (theta + 1)) * 7 % theta, j] = np.nan
    ga = _non_finite_stack(theta, d, seed + 1)
    return ge, ga


def _nan_aware_close(got, want):
    """NaN and ±inf at the same places; finite values within rtol 1e-5,
    atol 1e-5 each."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(got[inf], want[inf])
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("theta,n,beta", [(1, 3, 1), (2, 7, 1), (3, 9, 2),
                                          (5, 11, 1), (6, 11, 3),
                                          (7, 11, 7)])
@pytest.mark.parametrize("signed", [False, True])
def test_fused_select_plain_matches_pallas_on_non_finite(jx, theta, n, beta,
                                                         signed):
    """NaN, ±inf, ±0 and 1e30 in the stack: the plain version gives NaN and
    inf where the Pallas kernel does (JAX's sort orders NaN last, as
    torch.sort does) and the same finite values."""
    w_ext, w_agr = _synthetic_plan(theta, n, seed=theta, signed=signed)
    x = _non_finite_stack(n, 240, seed=n)
    jnp = jx.jnp
    want = jx.fused_select(jnp.asarray(x), jnp.asarray(w_ext),
                           jnp.asarray(w_agr), beta, d_tile=128,
                           interpret=True)
    got = ref.fused_select_ref(_t(x), _t(w_ext), _t(w_agr), beta)
    assert np.isnan(np.asarray(want)).any()
    _nan_aware_close(got.numpy(), want)


@pytest.mark.parametrize("theta,beta", [(1, 1), (2, 1), (3, 1), (4, 2),
                                        (5, 1), (8, 3), (7, 7)])
def test_coord_select_plain_matches_pallas_on_non_finite(jx, theta, beta):
    """K3's plain version on NaN-laden g_ext (up to every row of a column)
    and specials in g_agr: NaN and inf where the Pallas kernel has them."""
    ge, ga = _non_finite_coord(theta, 300, seed=theta)
    jnp = jx.jnp
    want = jx.coord_select(jnp.asarray(ge), jnp.asarray(ga), beta,
                           d_tile=128, interpret=True)
    got = ref.coord_select_ref(_t(ge), _t(ga), beta)
    _nan_aware_close(got.numpy(), want)


# ------------------------------ θ > 32 (network and counted variants)
WIDE_THETAS = (33, 34, 40)


@pytest.mark.parametrize("theta", WIDE_THETAS)
@pytest.mark.parametrize("case", ["plan", "ties", "non_finite"])
def test_fused_select_plain_matches_pallas_wide_theta(jx, theta, case):
    """θ above the 32 register slots, where the CUDA wrapper takes the
    network variant: the plain version against the Pallas kernel, on a
    real multi-Bulyan plan (n = θ + 2f + 2, f = 2), on one-hot / uniform
    weights with tied extracted values and distances, and on NaN, ±inf,
    ±0 and 1e30 in the stack (NaN-aware)."""
    if case == "plan":
        w_ext, w_agr, beta = _plan(theta + 6, 2, seed=theta)
        x = _x(theta + 6, 130, seed=theta + 1)
    else:
        n, beta = theta + 3, -(-theta // 2)
        w_ext, w_agr = _synthetic_plan(theta, n, seed=theta)
        x = _non_finite_stack(n, 240, seed=n) if case == "non_finite" \
            else _x(n, 130, seed=theta + 2)
    jnp = jx.jnp
    want = jx.fused_select(jnp.asarray(x), jnp.asarray(w_ext),
                           jnp.asarray(w_agr), beta, d_tile=128,
                           interpret=True)
    got = ref.fused_select_ref(_t(x), _t(w_ext), _t(w_agr), beta)
    if case == "non_finite":
        assert np.isnan(np.asarray(want)).any()
        _nan_aware_close(got.numpy(), want)
    else:
        _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("theta", WIDE_THETAS)
@pytest.mark.parametrize("case", ["normal", "ties", "non_finite"])
def test_coord_select_plain_matches_pallas_wide_theta(jx, theta, case):
    """K3's plain version at θ > 32 against the Pallas kernel: normal
    inputs, every distance tied (the lower rows taken), and NaN in up to
    every row of a g_ext column with specials in g_agr (NaN-aware).  The
    Pallas kernel sums the β values in XLA's order, so the two agree
    within fp32 rounding, not bit for bit."""
    beta = theta - 4
    if case == "non_finite":
        ge, ga = _non_finite_coord(theta, 300, seed=theta)
    else:
        ge, ga = (t.numpy() for t in _coord_inputs(theta, 200, theta,
                                                   ties=case == "ties"))
    jnp = jx.jnp
    want = jx.coord_select(jnp.asarray(ge), jnp.asarray(ga), beta,
                           d_tile=128, interpret=True)
    got = ref.coord_select_ref(_t(ge), _t(ga), beta)
    if case == "non_finite":
        _nan_aware_close(got.numpy(), want)
    else:
        _close(got.numpy(), np.asarray(want))


def test_select_cases_hold_the_grid_and_its_non_finite_inputs():
    """The θ > 32 cases the card tests and the smoke script share: θ on
    each side of every boundary (32 | 33, each network bucket's top and
    the next θ, the last top the counted variant's start) and a θ that is
    not a multiple of the contraction's 16-slot passes; at θ = 33, n = 39
    each β of {1, 17, 33} at each width, then one non-finite case;
    one-hot ``w_ext`` rows; the same draws on every call.  The non-finite
    stack and the NaN-laden K3 inputs give the plain versions NaN (a NaN
    median) beside finite values."""
    thetas = select_cases.WIDE_THETAS
    for top in (32,) + K2.NETWORK_SLOTS:
        assert top + 1 in thetas and (top == 32 or top in thetas), top
    assert any(t % 16 for t in thetas if t <= K2.MAX_WIDE_THETA)
    k2 = list(select_cases.k2_cases(33, 39, "cpu"))
    widths = len(select_cases.WIDE_WIDTHS)
    assert len(k2) == 3 * widths + 1
    assert [args[3] for _, args, _ in k2[:3]] == [1, 17, 33]
    assert [non_finite for _, _, non_finite in k2] == [False] * 3 * widths \
        + [True]
    again = next(select_cases.k2_cases(33, 39, "cpu"))[1]
    assert all(torch.equal(a, b) for a, b in zip(k2[0][1][:3], again[:3]))
    x, w_ext, w_agr, beta = k2[-1][1]
    assert x.shape == (39, select_cases.NON_FINITE_WIDTH)
    assert torch.equal(w_ext.sum(dim=1), torch.ones(33))
    out = ref.fused_select_ref(x, w_ext, w_agr, beta)
    assert bool(torch.isnan(out).any()) and bool(torch.isfinite(out).any())
    assert len(list(select_cases.k3_cases(33, True, "cpu"))) == 3 * widths
    k3 = list(select_cases.k3_cases(33, False, "cpu"))
    assert len(k3) == 3 * widths + 1 and k3[-1][2]
    ge, ga, beta = k3[-1][1]
    out = ref.coord_select_ref(ge, ga, beta)
    assert bool(torch.isnan(out).any()) and bool(torch.isfinite(out).any())


def test_variant_names():
    """K2 and K3 share their dispatch: exact θ up to 16, the guarded slots
    up to 32, the network variant up to 128, the counted variant above."""
    assert [K2.variant_name(t) for t in (1, 5, 16, 17, 32, 33, 1000)] == [
        "theta=1", "theta=5", "theta=16", "theta<=32", "theta<=32",
        "theta>32", "theta>128"]
    assert ops.coord_select_variant_counts() == {}


@pytest.mark.parametrize("theta,name", [
    (32, "theta<=32"), (33, "theta>32"), (40, "theta>32"), (41, "theta>32"),
    (48, "theta>32"), (49, "theta>32"), (64, "theta>32"), (65, "theta>32"),
    (96, "theta>32"), (97, "theta>32"), (128, "theta>32"),
    (129, "theta>128")])
def test_variant_name_at_each_boundary(theta, name):
    """Each side of every boundary of the dispatch: the network variant's
    buckets share the name ``theta>32`` (θ = 33 to 128); the counted
    variant, which keeps its column in a scratch, is ``theta>128``."""
    assert K2.variant_name(theta) == name


@pytest.mark.parametrize("reported,name", [
    (1, "theta=1"), (5, "theta=5"), (16, "theta=16"), (32, "theta<=32"),
    (-1, "theta>32"), (-2, "theta>128")])
def test_launched_name_reads_what_the_launcher_reports(reported, name):
    """The launchers report the kernel they took: its θ for a kernel
    compiled for it, 32 for the guarded slots, -1 for the network variant
    and -2 for the counted one; its launch counts under that name."""
    assert K2.launched_name(reported) == name


def test_fused_select_rejects_bad_shapes():
    x = torch.zeros((8, 64))
    w = torch.zeros((3, 8))
    with pytest.raises(ValueError, match="beta"):
        ops.fused_select(x, w, w, 0)
    with pytest.raises(ValueError, match="weights must be"):
        ops.fused_select(x, torch.zeros((3, 7)), torch.zeros((3, 7)), 1)
    with pytest.raises(ValueError, match="shapes differ"):
        ops.fused_select(x, w, torch.zeros((4, 8)), 1)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise; they never compute on the CPU."""
    x = torch.zeros((11, 64))
    w = torch.zeros((7, 11))
    with pytest.raises(ValueError, match="CUDA"):
        pairwise_stats_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        fused_select_cuda(x, w, w, 3)
    assert MAX_THETA == 32


def test_build_command_targets_sm90a_with_hashed_outputs():
    cmd = build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").is_file()
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"


# ---------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 11, 16, 17, 33, 150])
@pytest.mark.parametrize("d", [1, 4095, 100_003])
def test_k1_kernel_matches_plain_on_card(card, n, d):
    x = _t(_x(n, d, seed=n + d)).to(card)
    got_d, got_s = pairwise_stats_cuda(x)
    want_d, want_s = ref.pairwise_stats_ref(x)
    torch.cuda.synchronize()
    _close(got_d.cpu().numpy(), want_d.cpu().numpy())
    _close(got_s.cpu().numpy(), want_s.cpu().numpy())
    again = pairwise_stats_cuda(x)[0]
    assert torch.equal(again, got_d)      # no atomics: bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", EDGE_GRID)
@pytest.mark.parametrize("d", [1, 257, 100_003])
def test_k2_kernel_matches_plain_on_card(card, n, f, d):
    w_ext, w_agr, beta = _plan(n, f, seed=n)
    x = _t(_x(n, d, seed=n * d)).to(card)
    we, wa = _t(w_ext).to(card), _t(w_agr).to(card)
    got = fused_select_cuda(x, we, wa, beta)
    want = ref.fused_select_ref(x, we, wa, beta)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


#: K5 / K7 card widths: odd or 4095 (the per-element loads) and multiples
#: of 4 (the packed words; 4096 is one whole group of 32 columns a warp)
K5_WIDTHS = [1, 4095, 100_003, 4096, 100_004, 1 << 20]


def _k5_payload(n, d, dtype, card, seed, x_seed, offset=0):
    """(n, d) payload on the card, starting ``offset`` elements into a
    larger buffer (offset 1: a base that is not 4-byte aligned), and (n,)
    multipliers, row 0's negative: int8 levels and the multipliers drawn
    from ``seed``, float rows ``_x(n, d, x_seed)``."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        flat = rng.integers(-127, 128, size=n * d).astype(np.int8)
        p = torch.from_numpy(flat)
    else:
        p = _t(_x(n, d, seed=x_seed).reshape(-1)).to(dtype)
    buf = torch.zeros(n * d + offset, dtype=dtype, device=card)
    buf[offset:] = p.to(card)
    mult = _t((rng.random(n) + 0.5) / 127.0).to(card)
    mult[0] = -100.0 * mult[0]
    return buf[offset:].view(n, d), mult


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 3, 11, 13, 37, 150])
@pytest.mark.parametrize("d", K5_WIDTHS)
def test_k5_kernel_equals_k1_on_decoded_on_card(card, n, d, dtype):
    """K5 on a payload == K1 on payload.float() * mult, bit for bit (the
    same template, grid and chunk order), and within K1's tolerance of
    the plain version; row 0 carries a negative multiplier."""
    p, mult = _k5_payload(n, d, dtype, card, n * 7 + d, n + d)
    got_d, got_s = dequant_stats_cuda(p, mult)
    k1_d, k1_s = pairwise_stats_cuda(p.float() * mult[:, None])
    want_d, want_s = ref.dequant_stats_ref(p, mult)
    torch.cuda.synchronize()
    assert torch.equal(got_d, k1_d) and torch.equal(got_s, k1_s)
    scale = max(1.0, 2.0 * float(want_s.max()))
    np.testing.assert_allclose(got_d.cpu().numpy(), want_d.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * scale)
    _close(got_s.cpu().numpy(), want_s.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("n", [11, 13])
@pytest.mark.parametrize("d", [4096, 100_004])
def test_k5_unaligned_base_equals_k1_on_card(card, n, d, dtype):
    """A payload one element into a larger buffer (its rows do not start
    on 4-byte words, so the packed loads cannot run) is K1 on its decoded
    stack bit for bit, as the aligned payload is."""
    p, mult = _k5_payload(n, d, dtype, card, n * 5 + d, n + d, offset=1)
    assert p.is_contiguous() and p.data_ptr() % 4 != 0
    got_d, got_s = dequant_stats_cuda(p, mult)
    k1_d, k1_s = pairwise_stats_cuda(p.float() * mult[:, None])
    torch.cuda.synchronize()
    assert torch.equal(got_d, k1_d) and torch.equal(got_s, k1_s)


def _coord_inputs(theta, d, seed, ties=False):
    rng = np.random.default_rng(seed)
    ge = rng.normal(size=(theta, d)).astype(np.float32)
    ga = rng.normal(size=(theta, d)).astype(np.float32)
    if ties:                      # every agr value 1 away from the median 0
        ge[:] = 0.0
        ga[:] = 1.0
        ga[1::2] = -1.0
    return _t(ge), _t(ga)


@pytest.mark.cuda
@pytest.mark.parametrize("theta,beta", [(5, 1), (8, 2), (16, 4), (30, 10),
                                        (7, 7), (32, 1)])
@pytest.mark.parametrize("d", [1, 64, 1000, 2049, 100_003])
@pytest.mark.parametrize("ties", [False, True])
def test_k3_kernel_matches_plain_on_card(card, theta, beta, d, ties):
    """K3 runs K2's coordinate phase (``csrc/select_tile.cuh``): bit for
    bit its plain version, ties to the lower row, β = θ the mean."""
    ge, ga = (t.to(card) for t in _coord_inputs(theta, d, theta * d, ties))
    got = coord_select_cuda(ge, ga, beta)
    want = ref.coord_select_ref(ge, ga, beta)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if beta == theta:
        _close(got.cpu().numpy(), ga.mean(dim=0).cpu().numpy())


def _same_bits(got, want):
    """Bit for bit with NaN at the same places (torch.equal is False on any
    NaN)."""
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and \
        torch.equal(got[~nan], want[~nan])


def _sweep(top):
    """(θ, β) for θ in 1..top, β in {1, ⌈θ/2⌉, θ}."""
    return [(theta, beta) for theta in range(1, top + 1)
            for beta in sorted({1, -(-theta // 2), theta})]


SWEEP_WIDTHS = (1, 3, 31, 257, 100_003)


@pytest.mark.cuda
@pytest.mark.parametrize("theta,beta,n", [
    (theta, beta, n) for theta, beta in _sweep(MAX_THETA)
    for n in sorted({theta + 1, 11, 37, 150}) if n > theta])
def test_k2_theta_sweep_matches_plain_on_card(card, theta, beta, n):
    """Every θ of both kernels (compiled for θ up to 16, guarded slots
    above), n from θ + 1 to 150, one-hot / uniform weights with ties, at
    odd widths: bit for bit the plain version, and counted under the
    variant θ takes."""
    w_ext, w_agr = _synthetic_plan(theta, n, seed=theta * 100 + n)
    we, wa = _t(w_ext).to(card), _t(w_agr).to(card)
    for d in SWEEP_WIDTHS:
        x = _t(_x(n, d, seed=theta + n + d)).to(card)
        name = K2.variant_name(theta)
        before = fused_select_cuda.variant_launches.get(name, 0)
        got = fused_select_cuda(x, we, wa, beta)
        want = ref.fused_select_ref(x, we, wa, beta)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"d={d}"
        assert fused_select_cuda.variant_launches[name] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("theta,beta", _sweep(MAX_THETA))
@pytest.mark.parametrize("ties", [False, True])
def test_k3_theta_sweep_matches_plain_on_card(card, theta, beta, ties):
    for d in SWEEP_WIDTHS:
        ge, ga = (t.to(card) for t in _coord_inputs(theta, d, theta + d,
                                                      ties))
        got = coord_select_cuda(ge, ga, beta)
        want = ref.coord_select_ref(ge, ga, beta)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"d={d}"


@pytest.mark.cuda
@pytest.mark.parametrize("theta,n,beta", [(1, 3, 1), (2, 7, 1), (3, 9, 2),
                                          (5, 11, 1), (6, 11, 3), (7, 11, 7),
                                          (16, 37, 4), (20, 37, 10)])
@pytest.mark.parametrize("signed", [False, True])
def test_k2_non_finite_matches_plain_on_card(card, theta, n, beta, signed):
    """NaN, ±inf, ±0 and 1e30 in the stack (signed: aggregates of both
    infinite signs under a median driven to NaN): bit for bit the plain
    version, NaN at the same places."""
    w_ext, w_agr = _synthetic_plan(theta, n, seed=theta, signed=signed)
    we, wa = _t(w_ext).to(card), _t(w_agr).to(card)
    for d in (257, 4099):
        x = _t(_non_finite_stack(n, d, seed=n + d)).to(card)
        got = fused_select_cuda(x, we, wa, beta)
        want = ref.fused_select_ref(x, we, wa, beta)
        torch.cuda.synchronize()
        assert _same_bits(got, want), f"d={d}"


@pytest.mark.cuda
@pytest.mark.parametrize("theta,beta", [(1, 1), (2, 1), (3, 1), (4, 2),
                                        (5, 1), (8, 3), (7, 7), (16, 4),
                                        (30, 10)])
def test_k3_non_finite_matches_plain_on_card(card, theta, beta):
    """NaN in up to every row of a g_ext column, specials in g_agr: bit for
    bit the plain version, NaN at the same places."""
    for d in (300, 4099):
        ge, ga = (_t(a).to(card) for a in _non_finite_coord(theta, d,
                                                             seed=theta + d))
        got = coord_select_cuda(ge, ga, beta)
        want = ref.coord_select_ref(ge, ga, beta)
        torch.cuda.synchronize()
        assert _same_bits(got, want), f"d={d}"


@pytest.mark.cuda
@pytest.mark.parametrize("theta", select_cases.WIDE_THETAS)
@pytest.mark.parametrize("n_extra", [1, 6, None])
def test_k2_wide_theta_matches_plain_on_card(card, theta, n_extra):
    """The network (θ ≤ 128) and counted variants on
    ``select_cases.k2_cases``: n = θ + 1, θ + 6 or 256 (one row chunk to
    sixteen), β in {1, ⌈θ/2⌉, θ}, one-hot / uniform weights with ties, at
    odd widths, and a non-finite stack: bit for bit the plain version, NaN
    at the same places, and counted under its variant (``"theta>32"``,
    ``"theta>128"``)."""
    n = 256 if n_extra is None else theta + n_extra
    name = K2.variant_name(theta)
    for label, args, non_finite in select_cases.k2_cases(theta, n, card):
        before = fused_select_cuda.variant_launches.get(name, 0)
        got = fused_select_cuda(*args)
        want = ref.fused_select_ref(*args)
        torch.cuda.synchronize()
        assert _same_bits(got, want), label
        assert not non_finite or bool(torch.isnan(want).any()), label
        assert fused_select_cuda.variant_launches[name] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("theta", select_cases.WIDE_THETAS)
@pytest.mark.parametrize("ties", [False, True])
def test_k3_wide_theta_matches_plain_on_card(card, theta, ties):
    """K3's network (θ ≤ 128) and counted variants on
    ``select_cases.k3_cases``: β in {1, ⌈θ/2⌉, θ} at odd widths, and NaN
    in up to every row of a g_ext column: bit for bit the plain version,
    NaN at the same places, and counted under its variant
    (``"theta>32"``, ``"theta>128"``)."""
    name = K2.variant_name(theta)
    for label, args, non_finite in select_cases.k3_cases(theta, ties, card):
        before = coord_select_cuda.variant_launches.get(name, 0)
        got = coord_select_cuda(*args)
        want = ref.coord_select_ref(*args)
        torch.cuda.synchronize()
        assert _same_bits(got, want), label
        assert not non_finite or bool(torch.isnan(want).any()), label
        assert coord_select_cuda.variant_launches[name] == before + 1


@pytest.mark.cuda
def test_counted_scratch_is_sized_and_checked_by_the_kernel_on_card(card):
    """The counted K2 (θ > 128)'s grid covers d in blocks of 128 columns,
    capped so its scratch (2θ floats a thread) stays near 32 MB, one block
    an SM at least; θ ≤ 128 takes none (the network variant keeps its
    column in shared memory).  Its launcher refuses a scratch one float
    short of that size (cudaErrorInvalidValue, 1)."""
    floats = K2._scratch_fn()
    assert floats(1, 129) == 2 * 129 * 128
    assert floats(1000, 129) == 2 * 129 * 8 * 128
    assert floats(10 ** 8, 129) == \
        2 * 129 * ((32 << 20) // (8 * 129 * 128)) * 128
    assert floats(10 ** 8, 1000) == 2 * 1000 * 132 * 128
    assert floats(10 ** 8, 32) == 0 and floats(10 ** 8, 34) == 0
    assert floats(10 ** 8, 128) == 0 and floats(0, 129) == -1
    theta, n, d = 129, 135, 1000
    w_ext, w_agr = (_t(w).to(card) for w in _synthetic_plan(theta, n, 1))
    x = _t(_x(n, d, seed=1)).to(card)
    out = torch.empty((d,), device=card)
    short = torch.empty((floats(d, theta) - 1,), device=card)
    variant = ctypes.c_int32(0)
    err = K2._launch_fn()(
        x.data_ptr(), w_ext.data_ptr(), w_agr.data_ptr(), out.data_ptr(),
        short.data_ptr(), short.numel(), n, d, theta, 17, K2.MAX_BLOCKS,
        torch.cuda.current_stream().cuda_stream, ctypes.byref(variant))
    assert err == 1


@pytest.mark.cuda
@pytest.mark.parametrize("library", ["fused_select", "coord_select"])
def test_network_buckets_match_the_library_on_card(card, library):
    """Both libraries' network variant takes θ = 33 to ``MAX_WIDE_THETA``,
    each θ over the slots of its bucket in ``NETWORK_SLOTS``, and reports
    a block that fits the card."""
    for theta in range(32, K2.MAX_WIDE_THETA + 2):
        shape = K2.wide_shape(theta, library)
        if not 32 < theta <= K2.MAX_WIDE_THETA:
            assert shape is None, theta
            continue
        want = next(s for s in K2.NETWORK_SLOTS if theta <= s)
        assert shape["slots"] == want, theta
        assert shape["blocks_per_sm"] >= 1 and shape["threads"] % 32 == 0


@pytest.mark.cuda
def test_wide_theta_past_any_shared_memory_on_card(card):
    """θ = 1000 (8 KB of values a coordinate, the grid capped at one block
    an SM): K2 and K3 bit for bit their plain versions."""
    theta, n = 1000, 8
    w_ext, w_agr = _synthetic_plan(theta, n, seed=7)
    we, wa = _t(w_ext).to(card), _t(w_agr).to(card)
    for d in (1, 257):
        x = _t(_x(n, d, seed=d)).to(card)
        got = fused_select_cuda(x, we, wa, 400)
        want = ref.fused_select_ref(x, we, wa, 400, chunk=64)
        ge, ga = (t.to(card) for t in _coord_inputs(theta, d, d))
        got3 = coord_select_cuda(ge, ga, 999)
        want3 = ref.coord_select_ref(ge, ga, 999, chunk=64)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got3, want3), f"d={d}"
