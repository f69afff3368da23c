"""Closed-loop throughput model of the async aggregation service (cf.
``repro.serve.loadgen``).

The question: at a fixed in-flight request budget, does the
bounded-staleness buffer sustain more requests a second than the
synchronous lockstep round under straggler latency?

Worker *arrival latencies* are drawn from a seeded lognormal straggler
model (numpy; this module never sleeps), while the aggregation compute of
a round is **measured** by timing the real ``AsyncAggService.round`` on
an (n, d) fp32 stack (K1 and K2 once a round under the kernels), and the
stale-admission accounting comes from replaying the arrival schedule
through the **real** buffer (``serve.buffer``).

* synchronous round: wall = slowest worker's latency + aggregation;
* async round: wall = the admission deadline + aggregation; workers that
  miss deliver into a later round (their slot goes stale, the haircut
  applies).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.device import resolve_device
from repro_torch.serve.service import AsyncAggService


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """One closed-loop serving experiment.

    Latency model: per round each worker's gradient takes
    ``mean_ms · LogNormal(0, jitter)``, except the last ``stragglers``
    (honest) workers, slowed by ``straggler_mult``; the async deadline is
    the ``deadline_quantile`` of the non-straggler latencies.
    ``microbatch`` requests are served per completed round.
    """

    n: int = 11
    f: int = 2
    d: int = 4096
    tau: int = 1
    rounds: int = 40
    microbatch: int = 8
    gar: str = "multi_bulyan"
    seed: int = 0
    mean_ms: float = 20.0
    jitter: float = 0.25
    stragglers: int = 2
    straggler_mult: float = 4.0
    deadline_quantile: float = 0.9


def worker_latencies(cfg: LoadConfig) -> np.ndarray:
    """(rounds, n) per-gradient compute latencies in ms (seeded)."""
    rng = np.random.default_rng(cfg.seed)
    lat = cfg.mean_ms * rng.lognormal(0.0, cfg.jitter,
                                      size=(cfg.rounds, cfg.n))
    if cfg.stragglers:
        # stragglers sit on the last rows: byzantine rows come first by
        # the inject_byzantine convention, and a straggling *honest*
        # worker is the interesting case for the staleness haircut
        lat[:, cfg.n - cfg.stragglers:] *= cfg.straggler_mult
    return lat


def deadline_ms(cfg: LoadConfig, lat: np.ndarray) -> float:
    """Admission deadline: a quantile of the non-straggler latencies."""
    fast = lat[:, : cfg.n - cfg.stragglers] if cfg.stragglers else lat
    return float(np.quantile(fast, cfg.deadline_quantile))


def arrival_masks(cfg: LoadConfig, lat: np.ndarray, round_wall_ms: float,
                  cut_ms: float) -> np.ndarray:
    """(rounds, n) bool delivery masks of the closed arrival loop.

    Round ``r`` spans ``[r·wall, (r+1)·wall)``; a worker delivers into
    round ``r`` when its in-flight gradient finishes by ``r·wall + cut``.
    On delivery it immediately starts the next gradient, so a worker
    slower than the cut delivers every second (third, …) round.
    """
    fresh = np.zeros((cfg.rounds, cfg.n), dtype=bool)
    finish = lat[0].copy()                       # first gradients start at 0
    job = np.zeros(cfg.n, dtype=int)
    for r in range(cfg.rounds):
        cut = r * round_wall_ms + cut_ms
        for w in range(cfg.n):
            if finish[w] <= cut:
                fresh[r, w] = True
                job[w] = min(job[w] + 1, cfg.rounds - 1)
                finish[w] = max(finish[w], r * round_wall_ms) + \
                    lat[job[w], w]
    return fresh


def round_grads(cfg: LoadConfig, r: int, device) -> torch.Tensor:
    """Round ``r``'s (n, d) fp32 gradients: normal draws from a generator
    seeded by (seed, r) alone (the counterpart of ``fold_in(key, r)``),
    the first f rows x 5 so the selection is not trivial."""
    gen = torch.Generator(device=device)
    words = np.random.SeedSequence((cfg.seed, r)).generate_state(1, np.uint64)
    gen.manual_seed(int(words[0]))
    g = torch.randn((cfg.n, cfg.d), generator=gen, device=device)
    g[: cfg.f] *= 5.0
    return g


def replay_rounds(cfg: LoadConfig, fresh: np.ndarray, device=None
                  ) -> Dict[str, np.ndarray]:
    """Replay an arrival schedule through the real service round on
    ``device`` (``cuda`` unless asked otherwise).

    Returns per-round ``(rounds,)`` arrays: ``n_overstale``,
    ``plan_reused``, ``f_defended`` and ``agg_us``, the round's host-clock
    microseconds (the gradients drawn before the clock starts; on a card
    the clock stops after a synchronisation), after one warm-up round on
    round 0's inputs that is not kept.
    """
    dev = resolve_device(device)
    svc = AsyncAggService(backend=api.AggregatorBackend(gar=cfg.gar,
                                                        f=cfg.f),
                          tau=cfg.tau)
    state = svc.init_state(torch.zeros((cfg.n, cfg.d), device=dev))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        svc.round(state, round_grads(cfg, 0, dev), fresh[0])
        out = {k: np.zeros(cfg.rounds) for k in
               ("n_overstale", "plan_reused", "f_defended", "agg_us")}
        for r in range(cfg.rounds):
            g = round_grads(cfg, r, dev)
            mask = torch.as_tensor(fresh[r]).to(dev)
            sync()
            t0 = time.perf_counter()
            _, state, info = svc.round(state, g, mask)
            sync()
            out["agg_us"][r] = (time.perf_counter() - t0) * 1e6
            out["n_overstale"][r] = int(info["n_overstale"])
            out["plan_reused"][r] = bool(info["plan_reused"])
            out["f_defended"][r] = int(info["f_defended"])
    return out


def replay_buffer(cfg: LoadConfig, fresh: np.ndarray, device=None
                  ) -> Tuple[Dict[str, float], np.ndarray]:
    """Replay an arrival schedule through the real buffer
    (:func:`replay_rounds`).  Returns (the accounting, the measured
    per-round aggregation µs, a ``(rounds,)`` array): per-round samples,
    not a mean, so the benchmark can report the round latency's tail."""
    rec = replay_rounds(cfg, fresh, device)
    n_over, reused, f_def = (rec["n_overstale"], rec["plan_reused"],
                             rec["f_defended"])
    acct = {
        "stale_rounds": int(np.sum(n_over > 0)),
        "reused_rounds": int(np.sum(reused)),
        "n_overstale_max": int(np.max(n_over)),
        "f_defended_mean": float(np.mean(f_def)),
        "admitted_frac": float(np.mean(fresh)),
    }
    return acct, rec["agg_us"]


def run_closed_loop(cfg: LoadConfig, mode: str, device=None
                    ) -> Dict[str, float]:
    """One (mode, tau, f) cell of the serving model, on ``device``.

    ``round_us`` is the per-round mean; ``round_us_p50/p95/p99`` are
    percentiles over the per-round latencies: in sync mode each round's
    wall is its slowest worker plus that round's measured aggregation, in
    async mode the fixed admission deadline plus the round's measured
    aggregation.
    """
    if mode not in ("sync", "async"):
        raise ValueError(f"mode must be sync|async, got {mode!r}")
    lat = worker_latencies(cfg)
    if mode == "sync":
        # lockstep: every round waits for the slowest worker; everyone
        # is always fresh, the buffer degenerates to pass-through
        fresh = np.ones((cfg.rounds, cfg.n), dtype=bool)
        acct, agg_us = replay_buffer(cfg, fresh, device)
        waits_ms = np.max(lat, axis=1)
        round_us = waits_ms * 1000.0 + agg_us
    else:
        cut = deadline_ms(cfg, lat)
        # the round wall needs agg_us: measured once on an all-fresh
        # replay, then the actual arrival schedule replayed for the
        # accounting
        _, warm_us = replay_buffer(cfg, np.ones((cfg.rounds, cfg.n), bool),
                                   device)
        wall_ms = cut + float(np.mean(warm_us)) / 1000.0
        fresh = arrival_masks(cfg, lat, wall_ms, cut)
        acct, agg_us = replay_buffer(cfg, fresh, device)
        round_us = cut * 1000.0 + agg_us
    total_s = float(np.sum(round_us)) / 1e6
    p50, p95, p99 = np.percentile(round_us, [50.0, 95.0, 99.0])
    return {
        "qps": cfg.microbatch * cfg.rounds / total_s,
        "round_us": float(np.mean(round_us)),
        "round_us_p50": float(p50),
        "round_us_p95": float(p95),
        "round_us_p99": float(p99),
        "agg_us": float(np.mean(agg_us)),
        **acct,
    }
