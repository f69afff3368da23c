"""repro_torch.obs — runtime observability (cf. ``repro.obs``; the JAX
package's DESIGN.md section 14).

Four pieces, one contract:

* :mod:`~repro_torch.obs.metrics` — the device-resident registry
  (counters, gauges, histograms) whose record ops are tensor updates
  that never read back to the host, and the campaigns' suspicion EMA;
* :mod:`~repro_torch.obs.trace` — the stats→plan→apply→select_plan span
  ring, Chrome-trace / Perfetto export at drain;
* :mod:`~repro_torch.obs.profile` — one record per kernel wrapper call:
  the tile policy chosen and ptxas's report of the launched kernel;
* :mod:`~repro_torch.obs.export` — the host-side drain: ``obs.v1``
  snapshots, serve percentiles, campaign phase digests.

Step code may accumulate into the registry and ring; only the export
layer copies to the host.  ``ObsConfig(enabled=False)`` (or ``obs=None``)
makes every instrumented step builder dispatch the ops of the
uninstrumented step, in the same order: observability is free until
switched on.

The observed state rides in ``TrainerState.mstate`` as a plain dict
``{"m": MetricsState, "t": TraceState | None}`` and checkpoints under the
JAX package's keys (:func:`init_obs_state` seeds it; the step builders
seed it on their first step when the slot is still ``None``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.obs.export import (SCHEMA, metrics_to_json, percentiles,
                                    phase_summary, serve_metrics, snapshot,
                                    validate_snapshot, write_snapshot)
from repro_torch.obs.metrics import (GRAD_NORM_EDGES, MetricsSpec,
                                     MetricsState, ObsConfig, ema_gauge, inc,
                                     init_metrics, init_suspicion, obs_on,
                                     observe, serve_spec, set_gauge,
                                     train_spec, update_ema, update_suspicion)
from repro_torch.obs.profile import (KernelProfiler, KernelRecord,
                                     profile_points, record_kernel)
from repro_torch.obs.trace import (PH_APPLY, PH_PLAN, PH_SELECT_PLAN,
                                   PH_STATS, PHASES, SpanTracer, TraceState,
                                   drain, export_chrome_trace, init_trace,
                                   record)

__all__ = [
    "GRAD_NORM_EDGES", "KernelProfiler", "KernelRecord", "MetricsSpec",
    "MetricsState", "ObsConfig", "PHASES", "PH_APPLY", "PH_PLAN",
    "PH_SELECT_PLAN", "PH_STATS", "SCHEMA", "SpanTracer", "TraceState",
    "drain", "ema_gauge", "export_chrome_trace", "inc", "init_metrics",
    "init_obs_state", "init_serve_obs", "init_suspicion", "init_trace",
    "init_train_obs", "metrics_to_json", "mstate_from_jax", "obs_on",
    "observe", "percentiles", "phase_summary", "profile_points", "record",
    "record_kernel", "serve_metrics", "serve_spec", "set_gauge",
    "snapshot", "train_spec", "update_ema", "update_suspicion",
    "validate_snapshot", "write_snapshot",
]

Device = Optional[Union[str, torch.device]]


def init_obs_state(obs: Optional[ObsConfig], spec: MetricsSpec, *,
                   device: Device = None) -> Optional[Dict[str, Any]]:
    """The ``mstate`` slot on ``device``: ``None`` when obs is off."""
    if not obs_on(obs):
        return None
    return {"m": init_metrics(spec, device=device),
            "t": init_trace(obs.ring, device=device) if obs.trace else None}


def init_train_obs(obs: Optional[ObsConfig], n_workers: int, *,
                   telemetry: bool = False,
                   device: Device = None) -> Optional[Dict[str, Any]]:
    """Seed the mstate both synchronous trainers expect (the sim engine
    seeds it before its phase loop; the trainers on their first step)."""
    return init_obs_state(obs, train_spec(n_workers, telemetry=telemetry),
                          device=device)


def init_serve_obs(obs: Optional[ObsConfig], n_workers: int, tau: int, *,
                   telemetry: bool = False,
                   device: Device = None) -> Optional[Dict[str, Any]]:
    """Seed the mstate the async service step expects."""
    return init_obs_state(
        obs, serve_spec(n_workers, tau, telemetry=telemetry), device=device)


def mstate_from_jax(tree, *, device: Device = None
                    ) -> Optional[Dict[str, Any]]:
    """The port's ``mstate`` from a JAX one whose leaves are numpy arrays
    (``jax.tree.map(np.asarray, mstate)``): the spec, counters, gauges and
    histograms, and the ring's capacity, slots and head, on ``device``
    (cf. ``models.params_from_jax``).  Read by attribute, so nothing of
    the JAX package is imported."""
    if tree is None:
        return None

    def put(a, dtype):
        return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)

    jm, jt = tree["m"], tree.get("t")
    spec = MetricsSpec(
        counters=tuple(jm.spec.counters),
        gauges=tuple((n, tuple(s)) for n, s in jm.spec.gauges),
        hists=tuple((n, tuple(float(e) for e in edges))
                    for n, edges in jm.spec.hists))
    m = dataclasses.replace(
        init_metrics(spec, device=device),
        counters={k: put(v, torch.float32) for k, v in jm.counters.items()},
        gauges={k: put(v, torch.float32) for k, v in jm.gauges.items()},
        hists={k: put(v, torch.int32) for k, v in jm.hists.items()})
    t = None if jt is None else TraceState(
        capacity=int(jt.capacity), slots=put(jt.slots, torch.float32),
        head=put(jt.head, torch.int32).reshape(()))
    return {"m": m, "t": t}
