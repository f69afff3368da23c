"""Host-side drain (cf. ``repro.obs.export``): ``obs.v1`` snapshots,
serve percentiles, campaign phase digests.

Everything here runs after the device work, on numpy: it consumes the
registry and ring (``MetricsState`` / drained ``TraceState`` records),
kernel profiler records and host span lists, and produces the ``obs.v1``
JSON snapshot that ``launch/obs_report.py`` prints and validates.  The
record ops of ``obs.metrics`` / ``obs.trace`` never read back to the host;
this module is where the registry crosses to it.

:func:`phase_summary` turns a campaign trace (field name -> (steps, ...)
numpy array) into the per-phase digest of a ``sim.campaign.v1`` report.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

SCHEMA = "obs.v1"


def _host(t) -> np.ndarray:
    """A registry tensor (or array) as a numpy array on the host."""
    return t.detach().cpu().numpy() if hasattr(t, "detach") \
        else np.asarray(t)


# ------------------------------------------------------------- percentiles
def percentiles(xs) -> Dict[str, float]:
    """p50/p95/p99 of a sample vector (linear interpolation, numpy)."""
    xs = np.asarray(xs, np.float64)
    if xs.size == 0:
        raise ValueError("percentiles of an empty sample")
    p50, p95, p99 = np.percentile(xs, [50.0, 95.0, 99.0])
    return {"p50": float(p50), "p95": float(p95), "p99": float(p99)}


# ---------------------------------------------------------- registry drain
def metrics_to_json(mstate) -> Optional[Dict[str, Any]]:
    """Drain a ``MetricsState`` to plain JSON (floats/ints/lists).

    Histograms carry their spec edges alongside the counts so the
    snapshot is self-describing — a reader never needs the producing
    code to interpret the buckets.
    """
    if mstate is None:
        return None
    return {
        "counters": {k: float(_host(v))
                     for k, v in sorted(mstate.counters.items())},
        "gauges": {k: _host(v).astype(np.float64).tolist()
                   for k, v in sorted(mstate.gauges.items())},
        "hists": {k: {"edges": list(mstate.spec.hist_edges(k)),
                      "counts": _host(v).astype(np.int64).tolist()}
                  for k, v in sorted(mstate.hists.items())},
    }


def serve_metrics(round_us, *, agg_us=None,
                  ages=None, tau: Optional[int] = None,
                  counters: Optional[Dict[str, float]] = None
                  ) -> Dict[str, Any]:
    """Per-round serve digest: latency/QPS percentiles + staleness.

    ``round_us`` is the loadgen's per-round delivery schedule (one entry
    per completed round); QPS percentiles are the per-round reciprocal,
    so qps.p50 is the median *rate*, not 1/median latency of a mean.
    """
    round_us = np.asarray(round_us, np.float64)
    out: Dict[str, Any] = {
        "rounds": int(round_us.size),
        "round_us": percentiles(round_us),
        "round_us_mean": float(round_us.mean()),
        "qps": percentiles(1e6 / round_us),
        "qps_mean": float(round_us.size / (round_us.sum() / 1e6)),
    }
    if agg_us is not None:
        out["agg_us"] = percentiles(agg_us)
    if ages is not None:
        ages = np.asarray(ages)
        hi = int(tau) + 1 if tau is not None else int(ages.max()) + 1
        edges = [i + 0.5 for i in range(hi)]
        counts = np.bincount(
            np.searchsorted(edges, ages.ravel(), side="right"),
            minlength=len(edges) + 1)
        out["staleness"] = {"edges": edges, "counts": counts.tolist()}
    if counters:
        out["counters"] = {k: float(v) for k, v in sorted(counters.items())}
    return out


# -------------------------------------------------------------- snapshot
def snapshot(*, metrics=None, trace_records: Sequence[Dict] = (),
             kernels: Sequence[Dict] = (), serve: Optional[Dict] = None,
             meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble the ``obs.v1`` structured snapshot."""
    return {
        "schema": SCHEMA,
        "meta": dict(meta or {}),
        "metrics": metrics_to_json(metrics) if not isinstance(metrics, dict)
        else metrics,
        "trace": {"records": list(trace_records),
                  "n_records": len(trace_records)},
        "kernels": list(kernels),
        "serve": serve,
    }


def validate_snapshot(snap: Any) -> List[str]:
    """Schema problems of an ``obs.v1`` snapshot ([] when valid)."""
    problems: List[str] = []
    if not isinstance(snap, dict):
        return [f"snapshot: expected object, got {type(snap).__name__}"]
    if snap.get("schema") != SCHEMA:
        problems.append(
            f"schema: expected {SCHEMA!r}, got {snap.get('schema')!r}")
    for key in ("meta", "trace", "kernels"):
        if key not in snap:
            problems.append(f"missing key {key!r}")
    m = snap.get("metrics")
    if m is not None:
        if not isinstance(m, dict):
            problems.append("metrics: expected object or null")
        else:
            for sect in ("counters", "gauges", "hists"):
                if sect not in m:
                    problems.append(f"metrics: missing {sect!r}")
            for name, h in (m.get("hists") or {}).items():
                if "edges" not in h or "counts" not in h:
                    problems.append(
                        f"metrics.hists[{name}]: needs edges + counts")
                elif len(h["counts"]) != len(h["edges"]) + 1:
                    problems.append(
                        f"metrics.hists[{name}]: {len(h['counts'])} counts "
                        f"for {len(h['edges'])} edges (want edges+1)")
    tr = snap.get("trace")
    if isinstance(tr, dict):
        recs = tr.get("records")
        if not isinstance(recs, list):
            problems.append("trace.records: expected list")
        else:
            seqs = [r.get("seq") for r in recs]
            if seqs != sorted(seqs):
                problems.append("trace.records: not in seq order")
            for r in recs:
                for key in ("seq", "round", "phase", "payload"):
                    if key not in r:
                        problems.append(f"trace record missing {key!r}")
                        break
    if not isinstance(snap.get("kernels", []), list):
        problems.append("kernels: expected list")
    sv = snap.get("serve")
    if sv is not None and isinstance(sv, dict):
        for key in ("round_us", "qps"):
            if key in sv:
                for p in ("p50", "p95", "p99"):
                    if p not in sv[key]:
                        problems.append(f"serve.{key}: missing {p}")
    return problems


def write_snapshot(path: str, snap: Dict[str, Any]) -> None:
    with open(path, "w") as f:
        json.dump(snap, f, indent=1, sort_keys=True)
        f.write("\n")


# ------------------------------------------------- campaign phase digest
def phase_summary(trace: Dict[str, np.ndarray], scenario,
                  start_step: int = 0,
                  wire: "Dict[str, Any] | None" = None) -> Dict[str, Any]:
    """Host-side per-phase digest of a campaign trace.

    Per phase: loss at entry/exit, mean/max honest-mean deviation, mean
    byzantine selection mass, the per-worker mean selection vector and the
    final suspicion vector.  The acceptance assertions
    (``launch/simulate.py --smoke``) read these.  ``start_step`` offsets
    the schedule against a resumed run's trace (which only covers
    executed steps).  ``wire`` (a ``repro_torch.comm.WireStats`` dict) is
    repeated per phase — byte accounting is shape-static, so every phase
    of a campaign pays the same wire.

    The JAX package's digest, line for line: the port's reports carry
    the same ``sim.campaign.v1`` summary (``tests/test_torch_sim.py``).
    """
    phases = []
    for i, ((start, stop), p) in enumerate(
            zip(scenario.schedule.bounds(), scenario.schedule.phases)):
        start, stop = start - start_step, stop - start_step
        if stop <= 0:
            continue  # phase ran before the resume point
        stop = min(stop, len(trace["loss"]))
        if start >= stop:
            break
        sl = slice(start, stop)
        ph: Dict[str, Any] = {
            "phase": i,
            "attack": p.attack,
            "f": scenario.phase_f(p),
            "steps": stop - start,
            "loss_first": float(trace["loss"][start]),
            "loss_last": float(trace["loss"][stop - 1]),
            "loss_mean": float(np.mean(trace["loss"][sl])),
        }
        for k in ("honest_dev", "byz_mass", "score_gap", "mean_dist",
                  "n_overstale", "f_defended", "plan_reused"):
            if k in trace:
                ph[f"{k}_mean"] = float(np.mean(trace[k][sl]))
                ph[f"{k}_max"] = float(np.max(trace[k][sl]))
        if "selection" in trace:
            ph["selection_mean"] = np.mean(
                trace["selection"][sl], axis=0).tolist()
        # async staleness accounting: which workers were admitted on time
        # vs sat overstale (haircut) this phase — repro.serve telemetry
        if "admitted" in trace:
            ph["admitted_mean"] = np.mean(
                trace["admitted"][sl], axis=0).tolist()
        if "overstale" in trace:
            ph["overstale_mean"] = np.mean(
                trace["overstale"][sl], axis=0).tolist()
        if "staleness_ema" in trace:
            ph["staleness_ema_last"] = \
                trace["staleness_ema"][stop - 1].tolist()
        if "suspicion" in trace:
            ph["suspicion_last"] = trace["suspicion"][stop - 1].tolist()
        if "group_selection" in trace:
            ph["group_selection_mean"] = np.mean(
                trace["group_selection"][sl], axis=0).tolist()
        if "group_suspicion" in trace:
            ph["group_suspicion_last"] = \
                trace["group_suspicion"][stop - 1].tolist()
        if wire is not None:
            ph["wire"] = wire
        phases.append(ph)
    out: Dict[str, Any] = {
        "total_steps": int(len(trace["loss"])),
        "final_loss": float(trace["loss"][-1]),
        "phases": phases,
    }
    if "honest_dev" in trace:
        out["honest_dev_max"] = float(np.max(trace["honest_dev"]))
    if "byz_mass" in trace:
        out["byz_mass_mean"] = float(np.mean(trace["byz_mass"]))
    if wire is not None:
        out["wire"] = wire
    return out
