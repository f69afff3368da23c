"""Port parity for the Mamba-1 mixer (``repro_torch.models.ssm``) against
the JAX package's ``repro.models.ssm`` and a naive sequential recurrence
(``tests/test_ssm.py``'s oracle, here on the port's parameters).

The JAX mixer's parameters are carried across (``params_from_jax``) and
both sides get the same numpy input.  The port's doubling scan associates
the products in another order than ``lax.associative_scan``, so fp32
outputs agree within ``rtol=1e-4, atol=1e-5`` (the scan's states are
sums of up to 512 decayed terms), gradients within ``rtol=1e-3,
atol=1e-5``; against the fp64 recurrence JAX's own bound ``rtol=2e-2,
atol=2e-3``; the decode step against the full pass within ``1e-5``.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs.base import ArchConfig as JArch
from repro.configs.base import SSMConfig as JSSM
from repro.models import ssm as JS
from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.models import ssm as TS
from repro_torch.models.api import params_from_jax
from repro_torch.tree import tree_items, tree_leaves

torch.set_num_threads(1)

_KW = dict(name="t-ssm", family="ssm", n_layers=1, d_model=16, n_heads=1,
           n_kv_heads=1, d_ff=0, vocab_size=64)
_SSM = dict(d_state=4, d_conv=3, expand=2, dt_rank=4)
JCFG = JArch(**_KW, ssm=JSSM(**_SSM))
TCFG = ArchConfig(**_KW, ssm=SSMConfig(**_SSM), dtype="float32")


def _setup(seq, seed=0, batch=2):
    jp = jax.tree.map(np.asarray, JS.mamba_init(jax.random.key(seed), JCFG))
    x = (np.random.default_rng(seed + 1).normal(
        size=(batch, seq, JCFG.d_model)) * 0.5).astype(np.float32)
    return jp, x


def naive_mamba(p, x, cfg):
    """Step-by-step fp64 recurrence (``tests/test_ssm.py``'s oracle)."""
    ssm = cfg.ssm
    b, s, d = x.shape
    di = ssm.expand * d
    p = {k: (v if isinstance(v, dict) else np.asarray(v, np.float64))
         for k, v in p.items()}
    xz = x.astype(np.float64) @ np.asarray(p["in_proj"]["w"], np.float64)
    xr, z = xz[..., :di], xz[..., di:]
    w, bias = p["conv_w"], p["conv_b"]
    k = w.shape[0]
    xp = np.concatenate([np.zeros((b, k - 1, di)), xr], axis=1)
    conv = np.stack([sum(xp[:, t + i] * w[i] for i in range(k)) + bias
                     for t in range(s)], axis=1)
    xc = conv / (1 + np.exp(-conv))
    proj = xc @ np.asarray(p["x_proj"]["w"], np.float64)
    dtr = ssm.resolved_dt_rank(d)
    dt_low = proj[..., :dtr]
    bm = proj[..., dtr:dtr + ssm.d_state]
    cm = proj[..., dtr + ssm.d_state:]
    dt = np.logaddexp(0, dt_low @ np.asarray(p["dt_proj"]["w"], np.float64)
                      + np.asarray(p["dt_proj"]["b"], np.float64))
    a = -np.exp(p["A_log"])
    h = np.zeros((b, di, ssm.d_state))
    ys = []
    for t in range(s):
        h = np.exp(dt[:, t, :, None] * a[None]) * h + \
            dt[:, t, :, None] * bm[:, t, None, :] * xc[:, t, :, None]
        ys.append((h * cm[:, t, None, :]).sum(-1))
    y = (np.stack(ys, axis=1) + p["D"] * xc) * (z / (1 + np.exp(-z)))
    return y @ np.asarray(p["out_proj"]["w"], np.float64)


@pytest.mark.parametrize("seq", [7, 16, 256, 512])  # 512: two chunks
def test_mamba_apply_matches_jax(seq):
    jp, x = _setup(seq)
    want = np.asarray(JS.mamba_apply(jax.tree.map(jnp.asarray, jp),
                                     jnp.asarray(x), JCFG))
    got = TS.mamba_apply(params_from_jax(jp, device="cpu"),
                         torch.from_numpy(x), TCFG)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seq", [7, 512])
def test_mamba_apply_matches_naive_recurrence(seq):
    jp, x = _setup(seq, seed=2)
    got = TS.mamba_apply(params_from_jax(jp, device="cpu"),
                         torch.from_numpy(x), TCFG).numpy()
    np.testing.assert_allclose(got, naive_mamba(jp, x, TCFG), rtol=2e-2,
                               atol=2e-3)


@pytest.mark.parametrize("seq", [16, 512])
def test_mamba_gradients_match_jax(seq):
    jp, x = _setup(seq, seed=4)
    r = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    gj = jax.grad(lambda p: jnp.sum(JS.mamba_apply(
        p, jnp.asarray(x), JCFG) * jnp.asarray(r)))(
        jax.tree.map(jnp.asarray, jp))
    tp = params_from_jax(jp, device="cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    torch.sum(TS.mamba_apply(tp, torch.from_numpy(x), TCFG) *
              torch.from_numpy(r)).backward()
    for (path, t), j in zip(tree_items(tp), jax.tree.leaves(gj)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-3,
                                   atol=1e-5, err_msg="/".join(path))


def test_scan_chunk_is_the_recurrence():
    """The doubling scan against the loop ``h_t = d_t h_{t-1} + x_t`` from
    a non-zero start, over a chunk length that is not a power of 2."""
    g = torch.Generator().manual_seed(0)
    d = torch.rand((2, 37, 3, 4), generator=g)
    x = torch.randn((2, 37, 3, 4), generator=g)
    h0 = torch.randn((2, 3, 4), generator=g)
    h_all, h_last = TS._scan_chunk(h0, d, x)
    h = h0
    for t in range(37):
        h = d[:, t] * h + x[:, t]
        torch.testing.assert_close(h_all[:, t], h, rtol=1e-5, atol=1e-6)
    assert torch.equal(h_last, h_all[:, -1])


def test_mamba_step_matches_full():
    """Decode (``mamba_step``) from the empty cache equals the full pass at
    every position."""
    jp, x = _setup(10, seed=6, batch=1)
    p = params_from_jax(jp, device="cpu")
    full = TS.mamba_apply(p, torch.from_numpy(x), TCFG)
    cache = TS.init_mamba_cache(1, TCFG)
    for t in range(10):
        y, cache = TS.mamba_step(p, torch.from_numpy(x[:, t:t + 1]), cache,
                                 TCFG)
        torch.testing.assert_close(y[:, 0], full[:, t], rtol=1e-5,
                                   atol=1e-5)


def test_prefill_cache_matches_jax_and_continues_the_sequence():
    """``emit_cache``'s (conv, h) against JAX's ``_mamba_prefill_cache``,
    and decoding from it continues the full pass."""
    from repro.models import transformer as JT
    jp, x = _setup(13, seed=8)
    p = params_from_jax(jp, device="cpu")
    xt = torch.from_numpy(x)
    _, cache = TS.mamba_apply(p, xt[:, :12], TCFG, emit_cache=True)
    want = JT._mamba_prefill_cache(jax.tree.map(jnp.asarray, jp),
                                   jnp.asarray(x[:, :12]), JCFG)
    np.testing.assert_array_equal(cache["conv"].numpy(),
                                  np.asarray(want["conv"]))
    np.testing.assert_allclose(cache["h"].numpy(), np.asarray(want["h"]),
                               rtol=1e-4, atol=1e-5)
    y, _ = TS.mamba_step(p, xt[:, 12:13], cache, TCFG)
    full = TS.mamba_apply(p, xt, TCFG)
    torch.testing.assert_close(y[:, 0], full[:, 12], rtol=1e-5, atol=1e-5)


def test_mamba_causality():
    jp, x = _setup(12, seed=3, batch=1)
    p = params_from_jax(jp, device="cpu")
    y1 = TS.mamba_apply(p, torch.from_numpy(x), TCFG)
    x2 = x.copy()
    x2[:, 8:] = 9.9
    y2 = TS.mamba_apply(p, torch.from_numpy(x2), TCFG)
    torch.testing.assert_close(y1[:, :8], y2[:, :8], rtol=1e-5, atol=1e-5)


def test_init_tree_matches_jax():
    jp = JS.mamba_init(jax.random.key(0), JCFG)
    tp = TS.mamba_init(torch.Generator().manual_seed(0), TCFG)
    jpaths = [(tuple(k.key for k in path), tuple(v.shape)) for path, v in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    tpaths = [(path, tuple(v.shape)) for path, v in tree_items(tp)]
    assert tpaths == jpaths
    # softplus(b) spans [1e-3, 1e-1]; A_log = log(1..d_state)
    dt = torch.nn.functional.softplus(tp["dt_proj"]["b"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1001
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]))
