"""Host-side campaign digest (cf. ``repro.obs.export``).

:func:`phase_summary` turns a campaign trace (field name -> (steps, ...)
numpy array) into the per-phase digest of a ``sim.campaign.v1`` report.
It runs after the device work, on numpy only.  The ``obs.v1`` snapshot
export, the serve percentiles and the registry drain of the JAX module
are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


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
