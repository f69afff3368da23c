"""Port parity for the closed-loop load model (``repro_torch.serve.loadgen``)
against the JAX package on the CPU.

The latency model, the deadline and the arrival masks are numpy in both
packages and must be equal exactly; the buffer's accounting of one
arrival schedule (``replay_buffer``) exactly equal; ``run_closed_loop``
returns JAX's keys in both modes (its times are this machine's clock, so
only their signs and order are checked).
"""
import numpy as np
import pytest

from repro.serve import loadgen as JLG
from repro_torch.serve import loadgen as TLG

import torch

torch.set_num_threads(1)

CONFIGS = [dict(), dict(seed=3, stragglers=0), dict(n=7, f=1, rounds=12,
                                                     jitter=0.5),
           dict(tau=2, straggler_mult=2.5, deadline_quantile=0.5)]


def _pair(kw, **more):
    kw = {**kw, **more}
    return TLG.LoadConfig(**kw), JLG.LoadConfig(**kw)


def test_load_config_defaults_match_jax():
    t, j = TLG.LoadConfig(), JLG.LoadConfig()
    assert [(f, getattr(t, f)) for f in t.__dataclass_fields__] == \
        [(f, getattr(j, f)) for f in j.__dataclass_fields__]


@pytest.mark.parametrize("kw", CONFIGS)
def test_latencies_deadline_and_masks_match_jax(kw):
    t, j = _pair(kw)
    lat_t, lat_j = TLG.worker_latencies(t), JLG.worker_latencies(j)
    np.testing.assert_array_equal(lat_t, lat_j)
    cut = TLG.deadline_ms(t, lat_t)
    assert cut == JLG.deadline_ms(j, lat_j)
    for wall in (cut, cut + 0.37, 2.0 * cut):
        np.testing.assert_array_equal(TLG.arrival_masks(t, lat_t, wall, cut),
                                      JLG.arrival_masks(j, lat_j, wall, cut))


@pytest.mark.parametrize("kw", CONFIGS)
def test_replay_buffer_accounting_matches_jax(kw):
    """The same arrival schedule through both buffers: the accounting
    exactly equal, one aggregation time a round."""
    t, j = _pair(kw, d=64)
    lat = TLG.worker_latencies(t)
    cut = TLG.deadline_ms(t, lat)
    fresh = TLG.arrival_masks(t, lat, cut + 0.5, cut)
    got, got_us = TLG.replay_buffer(t, fresh, device="cpu")
    want, want_us = JLG.replay_buffer(j, fresh)
    assert got == want
    assert got_us.shape == want_us.shape == (t.rounds,)
    assert np.all(got_us > 0)


def test_replay_rounds_are_the_service_arithmetic():
    """Per round, the overstale count, the reuse flag and the haircut the
    replay records follow the staleness budget of the ages the schedule
    gives."""
    t = TLG.LoadConfig(d=32, rounds=8)
    fresh = np.ones((t.rounds, t.n), bool)
    fresh[1:4, -3:] = False                      # 3 late workers, 3 rounds
    rec = TLG.replay_rounds(t, fresh, device="cpu")
    age = np.zeros(t.n, int)
    for r in range(t.rounds):
        age = np.where(fresh[r], 0, age + 1)
        k = int(np.sum(age > t.tau))
        assert rec["n_overstale"][r] == k
        assert rec["plan_reused"][r] == (k > t.f)
        assert rec["f_defended"][r] == max(t.f - min(k, t.f), 0)
    assert rec["plan_reused"].tolist() == [0, 0, 1, 1, 0, 0, 0, 0]


def test_round_grads_depend_on_seed_and_round_only():
    t = TLG.LoadConfig(d=16)
    a, b = TLG.round_grads(t, 3, "cpu"), TLG.round_grads(t, 3, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, TLG.round_grads(t, 4, "cpu"))
    assert a.shape == (t.n, t.d) and a.dtype == torch.float32


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_run_closed_loop_returns_jax_keys(mode):
    t, j = _pair({}, d=64, rounds=6)
    got = TLG.run_closed_loop(t, mode, device="cpu")
    want = JLG.run_closed_loop(j, mode)
    assert sorted(got) == sorted(want)
    for k in ("stale_rounds", "reused_rounds", "n_overstale_max"):
        assert isinstance(got[k], int)
    assert got["qps"] > 0
    assert got["round_us_p50"] <= got["round_us_p95"] <= got["round_us_p99"]
    if mode == "sync":
        for k in ("stale_rounds", "reused_rounds", "n_overstale_max",
                  "f_defended_mean", "admitted_frac"):
            assert got[k] == want[k]


def test_run_closed_loop_refuses_a_mode_as_jax():
    t, j = _pair({}, d=8, rounds=2)
    with pytest.raises(ValueError) as et:
        TLG.run_closed_loop(t, "burst", device="cpu")
    with pytest.raises(ValueError) as ej:
        JLG.run_closed_loop(j, "burst")
    assert str(et.value) == str(ej.value)
