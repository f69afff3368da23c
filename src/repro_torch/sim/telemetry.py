"""Campaign telemetry (cf. ``repro.sim.telemetry``): per-step trace
records and the cross-step suspicion EMA.

The per-step plan diagnostics come from ``AggPlan.diagnostics`` through the
trainers' ``telemetry=True`` metrics (``selection``, ``byz_mass``,
``score_spectrum``, ``score_gap``, ``mean_dist``, ``honest_dev``).  This
module owns the record schema (:func:`step_record`), the JAX package's
field for field, and the host-side trace concatenation; the suspicion EMA
and the per-phase digest live in ``repro_torch.obs`` and are re-exported
here.  A record is CPU numpy once its step ends: the campaign's trace
never holds device memory.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.obs.export import phase_summary as _phase_summary
from repro_torch.obs.metrics import (init_suspicion, update_ema,  # noqa: F401
                                     update_suspicion)


def _host(value, dtype) -> np.ndarray:
    """A tensor or a Python number as a numpy array of ``dtype``."""
    if isinstance(value, torch.Tensor):
        value = value.detach().float().cpu().numpy()
    return np.asarray(value, dtype)


def step_record(metrics: Dict[str, Any], susp: torch.Tensor,
                phase_idx: int, gsusp: Optional[torch.Tensor] = None,
                stale: Optional[torch.Tensor] = None
                ) -> Dict[str, np.ndarray]:
    """One step's trace record from the trainer metrics: fp32 numpy
    arrays (``phase`` int32) on the host.

    ``gsusp`` — the per-*group* suspicion EMA carried by hierarchical
    campaigns — rides along as ``group_suspicion`` when present (the
    per-group selection itself arrives through the diagnostics dict as
    ``group_selection``); ``stale``, the async campaigns' overstale EMA, as
    ``staleness_ema``.
    """
    diag = metrics["telemetry"]
    rec = {
        "loss": _host(metrics["loss"], np.float32),
        "loss_per_worker": _host(metrics["loss_per_worker"], np.float32),
        "lr": _host(metrics["lr"], np.float32),
        "agg_grad_norm": _host(metrics["agg_grad_norm"], np.float32),
        "suspicion": _host(susp, np.float32),
        "phase": np.asarray(phase_idx, np.int32),
    }
    if gsusp is not None:
        rec["group_suspicion"] = _host(gsusp, np.float32)
    if stale is not None:
        rec["staleness_ema"] = _host(stale, np.float32)
    for k, v in diag.items():
        rec[k] = _host(v, np.float32)
    return rec


def stack_records(records: Sequence[Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    """Per-step records -> one phase's trace, (steps, ...) per field."""
    if not records:
        return {}
    return {k: np.stack([r[k] for r in records]) for k in records[0]}


def concat_traces(traces: Sequence[Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    """Concatenate per-phase stacked traces along the step axis (host-side)."""
    traces = [t for t in traces if t]
    if not traces:
        return {}
    keys = set(traces[0])
    for t in traces[1:]:
        keys &= set(t)
    return {k: np.concatenate([np.asarray(t[k]) for t in traces], axis=0)
            for k in sorted(keys)}


def summarize(trace: Dict[str, np.ndarray], scenario,
              start_step: int = 0,
              wire: "Dict[str, Any] | None" = None) -> Dict[str, Any]:
    """Host-side per-phase digest of a campaign trace
    (``repro_torch.obs.export.phase_summary``): loss at entry/exit,
    mean/max honest-mean deviation, mean byzantine selection mass, the
    per-worker mean selection vector and the final suspicion vector.
    ``start_step`` offsets the schedule against a resumed run's trace;
    ``wire`` (a ``WireStats`` dict) is repeated per phase."""
    return _phase_summary(trace, scenario, start_step, wire=wire)
