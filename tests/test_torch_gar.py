"""Port parity: ``repro_torch.core`` (gar, api, attacks, theory, config)
against the JAX registry and the numpy Algorithm 1 of ``core/reference.py``.

Both sides get the same numpy inputs.  Selection outputs (Krum masks,
``w_ext``/``w_agr``, winners) must match exactly, on inputs whose rows are
well apart so that an ulp cannot flip a near-tie; d-shaped values match
within fp32 ``atol=1e-5·scale, rtol=1e-5``.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import api as JA
from repro.core import attacks as JATK
from repro.core import gar as JG
from repro.core import reference as R
from repro.core import theory as JT
from repro_torch.configs import RobustConfig
from repro_torch.core import api as TA
from repro_torch.core import attacks as TATK
from repro_torch.core import gar as TG
from repro_torch.core import theory as TT

# the suite runs in several worker processes at once: one thread each
# keeps the port's many small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

RULES = ("average", "median", "trimmed_mean", "krum", "multi_krum",
         "bulyan", "multi_bulyan")

GRID = [(7, 1), (11, 2), (15, 3), (12, 2)]


def _stack(n, d, seed=0):
    """Rows with distinct spreads around a shared mean: pairwise distances
    and Krum scores are well apart."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(1, d))
    scale = (1.0 + 0.15 * rng.permutation(n))[:, None]
    return (mu + scale * rng.normal(size=(n, d))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _close(got, want, tol=1e-5):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.max(np.abs(want)))) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


# ---------------------------------------------------------------- gar
@pytest.mark.parametrize("n", [3, 7, 11])
@pytest.mark.parametrize("d", [1, 100, 257])
def test_pairwise_sqdist_matches_jax(n, d):
    G = _stack(n, d, seed=n * d)
    got = TG.pairwise_sqdist(_t(G)).numpy()
    want = np.asarray(JG.pairwise_sqdist(jnp.asarray(G)))
    _close(got, want)
    assert np.all(np.diag(got) == 0.0)


@pytest.mark.parametrize("n,f", GRID)
def test_krum_scores_and_masks_exact(n, f):
    G = _stack(n, 64, seed=n)
    dists = np.asarray(JG.pairwise_sqdist(jnp.asarray(G)))
    s_j = np.asarray(JG.krum_scores(jnp.asarray(dists), f))
    s_t = TG.krum_scores(_t(dists), f).numpy()
    _close(s_t, s_j)
    for m in (1, n - f - 2):
        np.testing.assert_array_equal(
            TG._select_smallest_mask(_t(s_j), m).numpy(),
            np.asarray(JG._select_smallest_mask(jnp.asarray(s_j), m)))


def test_select_smallest_mask_ties_go_to_lower_index():
    s = np.array([3.0, 1.0, 1.0, 2.0, 1.0], np.float32)
    np.testing.assert_array_equal(
        TG._select_smallest_mask(_t(s), 2).numpy(),
        np.asarray(JG._select_smallest_mask(jnp.asarray(s), 2)))
    assert TG._select_smallest_mask(_t(s), 2).tolist() == \
        [False, True, True, False, False]


@pytest.mark.parametrize("multi", [True, False])
@pytest.mark.parametrize("n,f", GRID)
def test_extraction_plan_exact(n, f, multi):
    G = _stack(n, 128, seed=7 * n + f)
    dists = np.asarray(JG.pairwise_sqdist(jnp.asarray(G)))
    theta = n - 2 * f - 2
    je, ja = JG.extraction_plan(jnp.asarray(dists), f, theta, multi=multi)
    te, ta = TG.extraction_plan(_t(dists), f, theta, multi=multi)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("theta,beta", [(7, 3), (6, 2), (5, 5), (4, 1)])
@pytest.mark.parametrize("d", [1, 100])
def test_bulyan_coordinate_phase_matches_jax(theta, beta, d):
    rng = np.random.default_rng(theta * 100 + d)
    ge = rng.normal(size=(theta, d)).astype(np.float32)
    ga = rng.normal(size=(theta, d)).astype(np.float32)
    got = TG.bulyan_coordinate_phase(_t(ge), _t(ga), beta).numpy()
    want = np.asarray(JG.bulyan_coordinate_phase(jnp.asarray(ge),
                                                 jnp.asarray(ga), beta))
    _close(got, want)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("n,f", GRID)
def test_rules_match_jax_registry(rule, n, f):
    if n < JA.get_aggregator(rule).min_n(f):
        pytest.skip("below the rule's resilience precondition")
    G = _stack(n, 257, seed=3 * n + f)
    G[:f] *= 25.0                         # far-out rows, like an attack
    want = np.asarray(JA.aggregate_matrix(jnp.asarray(G), f, rule))
    for use_kernels in (False, True):
        got = TA.aggregate_matrix(_t(G), f, rule,
                                  use_kernels=use_kernels).numpy()
        _close(got, want)


@pytest.mark.parametrize("n,f", [(11, 2), (15, 3)])
def test_bulyan_family_matches_numpy_algorithm1(n, f):
    G = _stack(n, 40, seed=n + 11 * f)
    for multi, rule in ((True, "multi_bulyan"), (False, "bulyan")):
        want = R.ref_multi_bulyan(G, f, multi=multi)
        _close(TA.aggregate_matrix(_t(G), f, rule).numpy(), want, 2e-5)


@pytest.mark.parametrize("n,f", [(7, 1), (11, 2)])
def test_krum_family_and_trimmed_mean_match_numpy(n, f):
    G = _stack(n, 40, seed=5 * n)
    winner, avg = R.ref_multi_krum(G, f)
    _close(TA.aggregate_matrix(_t(G), f, "multi_krum").numpy(), avg, 2e-5)
    _close(TA.aggregate_matrix(_t(G), f, "krum").numpy(), winner, 2e-5)
    _close(TA.aggregate_matrix(_t(G), f, "trimmed_mean").numpy(),
           R.ref_trimmed_mean(G, f), 2e-5)


def _tree(G):
    n = G.shape[0]
    return {"a": G[:, :120].reshape(n, 8, 15),
            "b": {"c": G[:, 120:200], "bias": G[:, 200:]}}


@pytest.mark.parametrize("rule", ["multi_bulyan", "multi_krum", "median"])
def test_aggregate_tree_matches_jax(rule):
    n, f = 11, 2
    G = _stack(n, 300, seed=99)
    G[:f] = -30.0 * G[f:].mean(axis=0)
    jt = {k: (jnp.asarray(v) if not isinstance(v, dict) else
              {kk: jnp.asarray(vv) for kk, vv in v.items()})
          for k, v in _tree(G).items()}
    tt = {k: (_t(v) if not isinstance(v, dict) else
              {kk: _t(vv) for kk, vv in v.items()})
          for k, v in _tree(G).items()}
    want = JA.aggregate_tree(jt, f, rule)
    for use_kernels in (False, True):
        got = TA.aggregate_tree(tt, f, rule, use_kernels=use_kernels)
        _close(got["a"].numpy(), np.asarray(want["a"]))
        _close(got["b"]["c"].numpy(), np.asarray(want["b"]["c"]))
        _close(got["b"]["bias"].numpy(), np.asarray(want["b"]["bias"]))


def test_stats_and_diagnostics_match_jax():
    n, f = 11, 2
    G = _stack(n, 300, seed=5)
    G[:f] *= 40.0
    js = JA.compute_stats({"a": jnp.asarray(G[:, :100]),
                           "b": jnp.asarray(G[:, 100:])}, f,
                          needs_dists=True, needs_norms=True)
    ts = TA.compute_stats({"a": _t(G[:, :100]), "b": _t(G[:, 100:])}, f,
                          needs_dists=True, needs_norms=True,
                          use_kernels=True)
    _close(ts.dists.numpy(), np.asarray(js.dists))
    _close(ts.sq_norms.numpy(), np.asarray(js.sq_norms))
    ts = TA.AggStats(n=n, f=f, dists=_t(np.asarray(js.dists)))
    jp = JA.get_aggregator("multi_bulyan").plan(js)
    tp = TA.get_aggregator("multi_bulyan").plan(ts)
    jd, td = jp.diagnostics(js), tp.diagnostics(ts)
    assert set(td) == set(jd)
    np.testing.assert_array_equal(td["selection"].numpy(),
                                  np.asarray(jd["selection"]))
    assert float(td["byz_mass"]) == float(jd["byz_mass"]) == 0.0
    for k in ("score_spectrum", "score_gap", "mean_dist"):
        _close(td[k].numpy(), np.asarray(jd[k]))


def test_inf_attack_nan_inf_plan_matches_jax():
    """1e30 rows: byzantine-byzantine distances are NaN (diagonal too),
    byzantine-honest ones inf; the plan still gives the byzantine rows
    zero mass, identically on both sides."""
    n, f, d = 11, 2, 1000
    correct = _stack(n - f, d, seed=1)
    stack = np.asarray(JATK.apply_attack(jnp.asarray(correct), f, "inf",
                                         None))
    np.testing.assert_array_equal(
        TATK.apply_attack(_t(correct), f, "inf").numpy(), stack)
    js = JA.compute_stats(jnp.asarray(stack), f, needs_dists=True)
    jd = np.asarray(js.dists)
    assert np.isnan(jd[:f, :f]).all() and np.isinf(jd[:f, f:]).all()
    jp = JA.get_aggregator("multi_bulyan").plan(js)
    want = np.asarray(JA.aggregate_matrix(jnp.asarray(stack), f,
                                          "multi_bulyan"))
    for use_kernels in (False, True):
        ts = TA.compute_stats(_t(stack), f, needs_dists=True,
                              use_kernels=use_kernels)
        td = ts.dists.numpy()
        np.testing.assert_array_equal(np.isnan(td), np.isnan(jd))
        np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
        fin = np.isfinite(jd)
        _close(td[fin], jd[fin])
        tp = TA.get_aggregator("multi_bulyan").plan(ts)
        np.testing.assert_array_equal(tp.w_ext.numpy(), np.asarray(jp.w_ext))
        np.testing.assert_array_equal(tp.w_agr.numpy(), np.asarray(jp.w_agr))
        assert float(torch.sum(tp.selection_weights()[:f])) == 0.0
        got = TA.aggregate_matrix(_t(stack), f, "multi_bulyan",
                                  use_kernels=use_kernels).numpy()
        assert np.isfinite(got).all()
        _close(got, want)


# ------------------------------------------------------------- attacks
@pytest.mark.parametrize("spec", ["none", "sign_flip", "sign_flip:scale=3",
                                  "inf", "little_is_enough",
                                  "little_is_enough:z=2.0", "mimic",
                                  "omniscient"])
def test_attacks_match_jax(spec):
    G = _stack(9, 50, seed=4)
    want = np.asarray(JATK.get_attack(spec)(jnp.asarray(G), 2, None))
    got = TATK.get_attack(spec)(_t(G), 2, None).numpy()
    _close(got, want, 1e-6)


def test_gaussian_attack_shape_and_scale():
    gen = torch.Generator().manual_seed(0)
    out = TATK.get_attack("gaussian:sigma=3")(torch.zeros(9, 20000), 2, gen)
    assert out.shape == (2, 20000)
    assert abs(float(out.std()) - 3.0) < 0.05


def test_attack_spec_errors_match_jax():
    assert TATK.parse_spec("sign_flip:scale=5") == \
        JATK.parse_spec("sign_flip:scale=5")
    with pytest.raises(KeyError, match="unknown attack"):
        TATK.get_attack("nope")
    with pytest.raises(ValueError, match="no parameter"):
        TATK.get_attack("sign_flip:zz=1")
    with pytest.raises(ValueError, match="bad spec item"):
        TATK.parse_spec("sign_flip:scale")


# ------------------------------------------------------ theory / config
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("f", [0, 1, 3])
def test_theory_levels_match_jax(rule, f):
    assert TT.min_workers(rule, f) == JT.min_workers(rule, f)
    agg = TA.get_aggregator(rule)
    need = agg.min_n(f)
    assert need == JA.get_aggregator(rule).min_n(f)
    agg.validate(need, f)
    if need > 1:
        with pytest.raises(ValueError, match="requires n >="):
            agg.validate(need - 1, f)


def test_theory_scalars_match_jax():
    assert TT.multi_bulyan_slowdown(11, 2) == JT.multi_bulyan_slowdown(11, 2)
    a = np.random.default_rng(0).normal(size=64).astype(np.float32)
    b = a + 0.1
    assert abs(TT.cone_cosine(_t(a), _t(b))
               - JT.cone_cosine(jnp.asarray(a), jnp.asarray(b))) < 1e-6


def test_robust_config_fail_fast():
    with pytest.raises(ValueError, match=r"multi_bulyan requires n >= 4f\+3"):
        RobustConfig(n_workers=10, f=2, gar="multi_bulyan")
    with pytest.raises(ValueError, match="available") as e:
        RobustConfig(n_workers=11, f=2, gar="multi_bulyn")
    for rule in RULES:
        assert rule in str(e.value)
    assert RobustConfig(n_workers=11, f=2).use_kernels is True
    assert TA.available_gars() == tuple(sorted(JA.available_gars()))
