"""Span tracing of the stats→plan→apply→select_plan pipeline (cf.
``repro.obs.trace``).

A step records *logical* spans: each record is (seq, round, phase,
payload), written into a fixed-capacity ring on the device
(:class:`TraceState`) without a read back to the host.  ``seq`` is the
monotone record counter, which orders records across wraparound;
``round`` is the optimizer step the span belongs to; ``phase`` indexes
:data:`PHASES`; ``payload`` is one phase-specific scalar (selection mass,
grad norm, plan_reused flag, ...).

Wall-clock time is attached on the host: the launch layer wraps each step
in a :class:`SpanTracer` span (``perf_counter`` around the step and a
``torch.cuda.synchronize()``), and :func:`export_chrome_trace` lays the
drained logical records out against those anchors.  The device pipeline's
structure comes from the ring, its duration from the host clock; an
in-ring number is never a time.

The exported JSON is the Chrome trace-event format, the JAX module's
document for the same records and spans: load it at
https://ui.perfetto.dev (or chrome://tracing).
"""
from __future__ import annotations

import dataclasses
import json
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.obs.metrics import STATIC, to_f32

Tensor = torch.Tensor

#: Pipeline phases, in program order.  ``select_plan`` is the async
#: degradation branch; synchronous trainers record the first three.
PHASES = ("stats", "plan", "apply", "select_plan")
PH_STATS, PH_PLAN, PH_APPLY, PH_SELECT_PLAN = range(len(PHASES))

_COLS = 4  # (seq, round, phase, payload)


@dataclasses.dataclass(frozen=True)
class TraceState:
    """Fixed-capacity span ring: ``slots`` is (capacity, 4) fp32.

    ``head`` (0-d int32) counts records ever written; the live window is
    the last ``min(head, capacity)`` records and ``head % capacity`` is
    the next write position.  seq stored as fp32 is exact up to 2^24
    records.  ``capacity`` is static: the checkpoint store writes
    ``...|head`` and ``...|slots``, JAX's keys.
    """

    capacity: int = dataclasses.field(metadata=STATIC)
    slots: Tensor
    head: Tensor


def init_trace(capacity: int, *,
               device: Optional[Union[str, torch.device]] = None
               ) -> TraceState:
    return TraceState(
        capacity=int(capacity),
        slots=torch.zeros((int(capacity), _COLS), dtype=torch.float32,
                          device=device),
        head=torch.zeros((), dtype=torch.int32, device=device))


def record(trace: Optional[TraceState], phase: int, round_idx,
           payload=0.0) -> Optional[TraceState]:
    """Append one span record (``None`` passes through).

    ``phase`` is an int of :data:`PHASES`; ``round_idx`` and ``payload``
    are Python numbers or tensors.  Writes row ``head % capacity`` of a
    copy of ``slots`` from device tensors alone.
    """
    if trace is None:
        return trace
    pos = torch.remainder(trace.head, trace.capacity).to(torch.int64)
    # a CPU payload (an averaging plan's selection) is copied to the ring
    row = torch.stack([trace.head.to(torch.float32)] + [
        to_f32(v, trace.slots).reshape(()) for v in (round_idx, phase,
                                                   payload)])
    return dataclasses.replace(
        trace,
        slots=trace.slots.index_copy(0, pos.reshape(1), row.reshape(1, -1)),
        head=trace.head + 1)


def drain(trace: Optional[TraceState]) -> List[Dict[str, Any]]:
    """On the host: the live window, oldest first (wraparound-safe).

    The only place the ring is copied to the host.  Records evicted by
    ring overwrite are gone: the ring bounds memory, the drain returns
    whatever survived, in seq order.
    """
    if trace is None:
        return []
    slots = trace.slots.detach().cpu().numpy()
    head = int(trace.head)
    n = min(head, trace.capacity)
    if n == 0:
        return []
    live = slots[np.argsort(slots[:, 0])] if head > trace.capacity \
        else slots[:n]
    out = []
    for seq, rnd, ph, payload in live:
        out.append({
            "seq": int(seq),
            "round": int(rnd),
            "phase": PHASES[int(ph)],
            "payload": float(payload),
        })
    return out


class SpanTracer:
    """Host-side wall-clock spans (``perf_counter``, microseconds).

    The launch layer brackets each step call::

        tracer = SpanTracer()
        with tracer.span("step", round=i):
            params, state, metrics = step(params, state, batch, seed)
            torch.cuda.synchronize()

    These anchor the logical device records in the exported trace.
    """

    def __init__(self):
        self.spans: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()

    @contextmanager
    def span(self, name: str, **args):
        start = time.perf_counter()
        try:
            yield
        finally:
            end = time.perf_counter()
            self.spans.append({
                "name": name,
                "ts_us": (start - self._t0) * 1e6,
                "dur_us": (end - start) * 1e6,
                "args": {k: _jsonable(v) for k, v in args.items()},
            })


def _jsonable(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    return str(v)


def export_chrome_trace(path: str, *,
                        device_records: Sequence[Dict[str, Any]] = (),
                        host_spans: Sequence[Dict[str, Any]] = (),
                        meta: Optional[Dict[str, Any]] = None) -> int:
    """Write a Chrome-trace/Perfetto JSON file; returns the event count.

    Host spans become pid 0 / tid 0 duration events at their measured
    wall-clock offsets.  Logical device records become pid 1 duration
    events on one track per phase: each round is laid out inside its
    host ``step`` span when one with a matching ``round`` arg exists
    (phases split the span evenly, in pipeline order), else on a uniform
    1 ms/round grid.  The layout is reconstruction, not measurement —
    ``args.logical`` is set on every device event to say so.
    """
    events: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": 0,
         "args": {"name": "host (wall clock)"}},
        {"name": "process_name", "ph": "M", "pid": 1,
         "args": {"name": "device pipeline (logical, host-anchored)"}},
    ]
    for s in host_spans:
        events.append({
            "name": s["name"], "ph": "X", "pid": 0, "tid": 0,
            "ts": round(float(s["ts_us"]), 3),
            "dur": round(float(s["dur_us"]), 3),
            "cat": "host", "args": dict(s.get("args", {})),
        })

    anchors = {}
    for s in host_spans:
        rnd = s.get("args", {}).get("round")
        if rnd is not None:
            anchors[int(rnd)] = (float(s["ts_us"]), float(s["dur_us"]))

    by_round: Dict[int, List[Dict[str, Any]]] = {}
    for r in device_records:
        by_round.setdefault(int(r["round"]), []).append(r)
    for rnd, recs in sorted(by_round.items()):
        recs = sorted(recs, key=lambda r: r["seq"])
        ts0, dur = anchors.get(rnd, (rnd * 1000.0, 1000.0))
        slot = dur / max(len(recs), 1)
        for k, r in enumerate(recs):
            events.append({
                "name": r["phase"], "ph": "X", "pid": 1,
                "tid": PHASES.index(r["phase"]),
                "ts": round(ts0 + k * slot, 3),
                "dur": round(slot, 3),
                "cat": "device-logical",
                "args": {"seq": r["seq"], "round": r["round"],
                         "payload": r["payload"], "logical": True,
                         "anchored": rnd in anchors},
            })
    for tid, phase in enumerate(PHASES):
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid, "args": {"name": phase}})

    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "exporter": "repro_torch.obs.trace",
            "note": ("device events are logical ring records laid out "
                     "against host wall-clock anchors; XLA has no "
                     "in-graph clock"),
            **(meta or {}),
        },
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return len(events)
