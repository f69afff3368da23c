"""Port parity for the paper's analytic quantities
(``repro_torch.core.theory``): the six functions of Lemmas 1-2, Theorem 1
and Definition 2 against the JAX package on a grid of (n, f, d, σ), the
cases of ``tests/test_theory.py``, and ``empirical_sigma`` within 1e-6
(relative) of JAX's on the same numpy stacks.  The scalar functions are
the same Python float arithmetic on both sides, so they are held to
equality."""
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import theory as JT
from repro_torch.core import theory as TT

GRID = [(n, f) for n in (7, 11, 15, 23, 64) for f in (0, 1, 2, 3, 5)
        if n - 2 * f - 2 > 0]


@pytest.mark.parametrize("n,f", GRID)
def test_scalar_theory_matches_jax(n, f):
    assert TT.eta(n, f) == JT.eta(n, f)
    assert TT.eta(n, f, m=n - f) == JT.eta(n, f, m=n - f)
    assert TT.multi_krum_slowdown(n, f) == JT.multi_krum_slowdown(n, f)
    assert TT.multi_bulyan_slowdown(n, f) == JT.multi_bulyan_slowdown(n, f)
    for d in (1, 64, 10_000, 1_543_503_872):
        assert TT.strong_leeway_bound(d) == JT.strong_leeway_bound(d)
        for sigma in (1e-4, 0.01, 0.05, 1.0, 10.0):
            for g_norm in (0.5, 1.0, 30.0):
                args = (n, f, d, sigma, g_norm)
                assert TT.sin_alpha(*args) == JT.sin_alpha(*args)
                assert TT.variance_condition(*args) \
                    == JT.variance_condition(*args)


@pytest.mark.parametrize("n,f", [(8, 3), (6, 2), (4, 1), (2, 0)])
def test_eta_rejects_like_jax(n, f):
    for mod in (TT, JT):
        with pytest.raises(ValueError, match="need n > 2f"):
            mod.eta(n, f)
    with pytest.raises(ValueError, match="need n > 2f"):
        TT.sin_alpha(n, f, 64, 0.1, 1.0)


# --------------------------------------------------- tests/test_theory.py
def test_eta_formula():
    n, f = 15, 3
    m = n - f - 2
    expect = math.sqrt(2 * (n - f + (f * m + f * f * (m + 1))
                            / (n - 2 * f - 2)))
    assert TT.eta(n, f) == pytest.approx(expect)


def test_eta_no_byzantine():
    # f = 0: η = sqrt(2n), the pure sampling-noise cone
    assert TT.eta(10, 0) == pytest.approx(math.sqrt(20))


def test_slowdowns():
    assert TT.multi_krum_slowdown(15, 3) == pytest.approx(10 / 15)
    assert TT.multi_bulyan_slowdown(15, 3) == pytest.approx(7 / 15)
    assert TT.multi_bulyan_slowdown(1000, 3) > 0.99


def test_variance_condition_monotone_in_sigma():
    assert TT.variance_condition(15, 3, 64, sigma=0.01, g_norm=1.0)
    assert not TT.variance_condition(15, 3, 64, sigma=10.0, g_norm=1.0)


def test_strong_leeway_bound_shrinks_as_one_over_sqrt_d():
    assert TT.strong_leeway_bound(1) == 1.0
    assert TT.strong_leeway_bound(10_000) == pytest.approx(0.01)


def test_empirical_sigma():
    rng = np.random.default_rng(0)
    G = rng.normal(scale=2.0, size=(64, 1000)).astype(np.float32)
    est = TT.empirical_sigma(torch.from_numpy(G))
    assert isinstance(est, float)
    assert est == pytest.approx(2.0, rel=0.1)


@pytest.mark.parametrize("seed,n,d,scale", [
    (0, 64, 1000, 2.0), (1, 11, 1, 0.5), (2, 5, 4096, 1e-3),
    (3, 15, 1000, 30.0), (4, 2, 7, 1.0)])
def test_empirical_sigma_matches_jax(seed, n, d, scale):
    rng = np.random.default_rng(seed)
    G = (1.0 + rng.normal(scale=scale, size=(n, d))).astype(np.float32)
    got = TT.empirical_sigma(torch.from_numpy(G))
    want = JT.empirical_sigma(jnp.asarray(G))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
