"""K1 (pairwise_stats) and K2 (fused_select) of the port.

On the CPU the plain PyTorch versions (``repro_torch.kernels.ref``) are
held to the Pallas kernels run in interpret mode, over the edge grid of
``tests/test_kernels.py`` (n not a multiple of 8, d not a multiple of 128,
even θ, β = θ, d = 1), and K2's plain version to the XLA ``_bulyan_leaf``
of the JAX package.
Tolerance: fp32 ``atol=1e-5·scale, rtol=1e-5``.  The tests marked
``cuda`` hold the CUDA kernels to their plain versions; they need a card
and ``nvcc`` and skip elsewhere.  JAX is imported only by the tests that
use it, so on a GPU machine without JAX the card tests run with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import gar as TG
from repro_torch.kernels import build, ops, ref
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
    from repro.kernels.fused_select import fused_select_pallas
    from repro.kernels.pairwise_sqdist import pairwise_stats_pallas
    return types.SimpleNamespace(jnp=jnp, api=api,
                                 fused_select=fused_select_pallas,
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
    (finalised once, after the sum over leaves)."""
    x = _x(5, 300, seed=1).astype(np.float64)
    raw, sq = ref.pairwise_stats_ref(_t(x))
    sq64 = np.sum(x * x, axis=1)
    _close(raw.numpy(), sq64[:, None] + sq64[None, :] - 2.0 * (x @ x.T))
    _close(sq.numpy(), sq64)
    assert np.any(np.diag(raw.numpy()) != 0.0)


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
    assert ops.launch_counts() == {"pairwise_stats": 0, "fused_select": 0}


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
