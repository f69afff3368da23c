"""Campaign reports (cf. ``repro.sim.report``): JSON (machine) and CSV
(spreadsheet) serialisation, in the JAX package's schema and rounding.

JSON schema (``sim.campaign.v1``)::

    {
      "schema":   "sim.campaign.v1",
      "scenario": {...},            # Scenario.to_json()
      "summary":  {...},            # telemetry.summarize() per-phase digest
      "per_step": {field: [...]}    # scalar trace fields, one list per field
    }

Vector trace fields (``selection``, ``suspicion``, ``score_spectrum``,
``loss_per_worker``) are summarised per phase in ``summary`` and kept out of
``per_step`` to bound report size; pass ``full_trace=True`` to embed them.
A campaign run with ``obs=`` adds its ``obs.v1`` snapshot under ``"obs"``.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict

import numpy as np


SCHEMA = "sim.campaign.v1"


def result_to_json(result, *, full_trace: bool = False) -> Dict[str, Any]:
    per_step: Dict[str, Any] = {}
    for k, v in result.trace.items():
        arr = np.asarray(v)
        if arr.ndim == 1 or full_trace:
            per_step[k] = np.round(arr.astype(np.float64), 6).tolist()
    out = {
        "schema": SCHEMA,
        "scenario": result.scenario.to_json(),
        "start_step": int(result.start_step),
        "wall_s": round(float(result.wall_s), 3),
        "summary": result.summary,
        "per_step": per_step,
    }
    # the snapshot rides along only when the campaign ran with obs: a
    # report without it is the report written before obs was ported
    if getattr(result, "obs", None) is not None:
        out["obs"] = result.obs
    return out


def write_json(path: str, result, *, full_trace: bool = False) -> str:
    payload = result_to_json(result, full_trace=full_trace)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return path


def write_csv(path: str, result) -> str:
    """One row per step, one column per scalar trace field."""
    scalars = {k: np.asarray(v) for k, v in result.trace.items()
               if np.asarray(v).ndim == 1}
    fields = sorted(scalars)
    steps = len(next(iter(scalars.values()))) if scalars else 0
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["step"] + fields)
        for i in range(steps):
            w.writerow([i + result.start_step] +
                       [f"{float(scalars[k][i]):.6g}" for k in fields])
    os.replace(tmp, path)
    return path
