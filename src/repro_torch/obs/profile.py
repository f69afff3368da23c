"""Kernel profiling hooks (cf. ``repro.obs.profile``): what did each kernel
wrapper choose, and what did the compiler make of the kernel it launched?

The five public wrappers that the JAX package hooks
(``kernels/ops.py``: ``pairwise_stats``, ``dequant_stats``,
``pairwise_stats_rect``, ``dequant_stats_rect``, ``fused_select``) call
:func:`record_kernel` on both routes.  With a :class:`KernelProfiler`
installed, each call appends one :class:`KernelRecord`: the Hopper tile
policy the wrapper chose (K1 / K5: ``kernels.pairwise_sqdist.launch_config``'s
row tile and chunk count and the grid they give; K2: the kernel variant of
its θ; K6 / K7: the square, view or rectangular grid), the shared memory
``analysis/smem.py`` predicts a block of the functions that configuration
launches, and the resources ptxas reported for them.  The configuration
and the functions are the estimator's (``smem.estimate_call``).

Three differences from the JAX module, all deliberate:

* **one record per wrapper call.**  The JAX hooks fire at trace time,
  once per launch shape; the port has no trace, so every call records;
* **the "measured" side is ptxas's report** (registers, static shared
  memory, stack frame, spills; ``kernels.build.ptxas_report``) in place
  of XLA's ``memory_analysis()``.  It is ``None``, never 0, where there is
  no report: on the plain route (a CPU tensor) and for a library built
  before reports were kept;
* **``vmem_predicted`` is shared memory a block**: the most, static and
  dynamic, of the kernel functions the call launches, from
  ``analysis/smem.py``, on both routes (the JAX package's is the VMEM
  working set of ``analysis/vmem.py``).

No profiler installed (the default): :func:`record_kernel` returns after
one check.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional

from repro_torch.analysis import smem
from repro_torch.kernels.build import ptxas_report

_ACTIVE: List["KernelProfiler"] = []


@dataclasses.dataclass(frozen=True)
class KernelRecord:
    """One wrapper call: the kernel, its route (``cuda``: the kernel was
    launched; ``plain``: its plain version ran on a CPU tensor), the
    stack's rows and columns, the launch configuration the wrapper chose
    (the same on both routes) and, on the ``cuda`` route, ptxas's report
    of each kernel function that configuration launches (mangled name ->
    ``registers``, ``smem_bytes``, ``stack_frame``, ``spill_stores``,
    ``spill_loads``)."""

    kernel: str
    route: str
    n: int
    d: int
    config: Dict[str, Any]
    vmem_predicted: Optional[int] = None
    ptxas: Optional[Dict[str, Dict[str, int]]] = None

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class KernelProfiler:
    """Installable sink for wrapper launch records (context manager)."""

    def __init__(self):
        self.records: List[KernelRecord] = []

    def __enter__(self) -> "KernelProfiler":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)


def launched_resources(library: str, patterns: List[str]
                       ) -> Optional[Dict[str, Dict[str, int]]]:
    """ptxas's report of the functions of ``library`` whose mangled names
    match one of ``patterns``; None where the library has no report."""
    report = ptxas_report(library)
    if report is None:
        return None
    return {name: res for name, res in sorted(report.items())
            if any(re.search(p, name) for p in patterns)}


def record_kernel(kernel: str, route: str, *args, **kwargs) -> None:
    """Called by the ``kernels/ops.py`` wrappers with their own arguments;
    a cheap no-op unless a profiler is installed."""
    if not _ACTIVE:
        return
    est = smem.estimate_call(kernel, *args, **kwargs)
    rec = KernelRecord(
        kernel=kernel, route=route, n=int(est.n), d=int(est.d),
        config=est.config, vmem_predicted=est.smem_per_block,
        ptxas=launched_resources(kernel, [launch.pattern for launch
                                          in est.launches])
        if route == "cuda" else None)
    for profiler in _ACTIVE:
        profiler.records.append(rec)


def f_for_bench(n: int) -> int:
    """The JAX package's benchmark grid f convention
    (``analysis/vmem.py::f_for_bench``)."""
    return max(1, (n - 3) // 4)


def profile_points(points, *, device="cuda",
                   f_fn: Optional[Callable[[int], int]] = None
                   ) -> List[Dict[str, Any]]:
    """Run K1, K5 and K2 (``ops.pairwise_stats``, ``ops.dequant_stats``,
    ``ops.fused_select``) at each (n, d) point on ``device`` under a
    profiler and return the record dicts, one a call.  The inputs are
    drawn from ``np.random.default_rng(0)`` as the JAX function draws
    them (an fp32 stack, (θ, n) plan weights, an int8 payload with unit
    multipliers).  Used by ``launch/obs_report.py --kernels``; on a CPU
    device the plain versions run and the records have no ptxas report.
    """
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    out: List[Dict[str, Any]] = []
    for n, d in points:
        f = f_for_bench(n) if f_fn is None else f_fn(n)
        theta = n - 2 * f - 2
        rng = np.random.default_rng(0)

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dtype)

        x = put(rng.standard_normal((n, d)), torch.float32)
        w = put(rng.random((theta, n)), torch.float32)
        payload = put(rng.integers(-127, 127, size=(n, d)), torch.int8)
        mult = torch.ones((n,), dtype=torch.float32, device=device)
        with KernelProfiler() as prof:
            ops.pairwise_stats(x)
            ops.dequant_stats(payload, mult)
            ops.fused_select(x, w, w, beta=max(theta - 2 * f, 1))
        out.extend(rec.to_json() for rec in prof.records)
    return out
