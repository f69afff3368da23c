"""Kernel profiling hooks (cf. ``repro.obs.profile``): what did each kernel
wrapper choose, and what did the compiler make of the kernel it launched?

The five public wrappers that the JAX package hooks
(``kernels/ops.py``: ``pairwise_stats``, ``dequant_stats``,
``pairwise_stats_rect``, ``dequant_stats_rect``, ``fused_select``) call
:func:`record_kernel` on both routes.  With a :class:`KernelProfiler`
installed, each call appends one :class:`KernelRecord`: the Hopper tile
policy the wrapper chose (K1 / K5: ``kernels.pairwise_sqdist.launch_config``'s
row tile and chunk count and the grid they give; K2: the kernel variant of
its θ; K6 / K7: the square, view or rectangular grid) and the resources
ptxas reported for the kernel functions that configuration launches.

Three differences from the JAX module, all deliberate:

* **one record per wrapper call.**  The JAX hooks fire at trace time,
  once per launch shape; the port has no trace, so every call records;
* **the "measured" side is ptxas's report** (registers, static shared
  memory, stack frame, spills; ``kernels.build.ptxas_report``) in place
  of XLA's ``memory_analysis()``.  It is ``None``, never 0, where there is
  no report: on the plain route (a CPU tensor) and for a library built
  before reports were kept;
* **``vmem_predicted`` is ``None``**: the JAX package predicts it with
  ``analysis/vmem.py``, which the port does not have.

No profiler installed (the default): :func:`record_kernel` returns after
one check.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.kernels import fused_select as FS
from repro_torch.kernels import pairwise_sqdist as PS
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


# ------------------------------------------------ each wrapper's configuration
#: the row loader K1's stats kernel is instantiated with, and K5's by
#: payload type (the mangled template argument)
_F32_ROWS = r"\w*F32Rows"
_DEQUANT_ROWS = {"float32": r"\w*DequantRowsIfE",
                 "int8": r"\w*DequantRowsIaE",
                 "bfloat16": r"\w*DequantRowsI13__nv_bfloat16E"}


def _stats(n: int, d: int, rows: str = r"\w*"
           ) -> Tuple[Dict[str, Any], List[str]]:
    """K1's and K5's configuration and the kernel functions it launches
    (``stats_tile::launch_stats``: ``partial_gram*<row_tile, single,
    rows>``, then ``finalize_kernel``); ``rows`` matches the row loader's
    mangled name."""
    row_tile, chunks = PS.launch_config(n, d)
    tiles = -(-n // row_tile)
    pairs = tiles * (tiles + 1) // 2
    gy = min(pairs, 65535)
    single = int(n <= row_tile)
    return ({"row_tile": row_tile, "chunks": chunks,
             "grid": [chunks, gy, -(-pairs // gy)]},
            [rf"partial_gram\w*ILi{row_tile}ELb{single}E{rows}",
             r"\dfinalize_kernel"])


def _dtype(t) -> str:
    return str(t.dtype)[len("torch."):]


def _pairwise_stats(x) -> Tuple[int, int, Dict[str, Any], List[str]]:
    n, d = x.shape
    return (n, d) + _stats(n, d, _F32_ROWS)


def _dequant_stats(payload, mult):
    n, d = payload.shape
    config, fns = _stats(n, d, _DEQUANT_ROWS[_dtype(payload)])
    return n, d, {**config, "dtype": _dtype(payload)}, fns


def _rect(x_loc, x_full, n, square: bool, view: bool):
    """K6's and K7's configuration: K1's symmetric grid when the block is
    the stack, else the rectangular grid (K6's view path for a block that
    is rows of a stack of at most 16 rows)."""
    n = x_full.shape[0] if n is None else int(n)
    (n_loc, d), n_full = x_loc.shape, x_full.shape[0]
    if square:
        config, fns = _stats(n, d)
        return n_full, d, {**config, "grid_kind": "square", "n_loc": n_loc}, \
            fns
    chunks = PS.launch_config(n, d)[1]
    tl, tf = PS.rect_tiles(n_loc, n_full)
    kind = "view" if view and PS.rect_view_arg(
        x_loc, x_full, (tl, tf, 0)) >= 0 else "rect"
    fns = [rf"rect_view_kernelILi{tl}ELi{tf}E", r"rect_finalize_staged"] \
        if kind == "view" else [rf"rect_gram_kernelILi{tl}ELi{tf}E",
                                r"\drect_finalize_kernel"]
    return n_full, d, {"grid_kind": kind, "n_loc": n_loc, "chunks": chunks,
                       "tiles": [tl, tf]}, fns


def _pairwise_stats_rect(x_loc, x_full, n=None):
    n_true = x_full.shape[0] if n is None else int(n)
    return _rect(x_loc, x_full, n, PS.is_whole(x_loc, x_full, n_true), True)


def _dequant_stats_rect(p_loc, m_loc, p_full, m_full, n=None):
    n_true = p_full.shape[0] if n is None else int(n)
    square = PS.is_whole(p_loc, p_full, n_true) and \
        PS.is_whole(m_loc, m_full, n_true)
    n_full, d, config, fns = _rect(p_loc, p_full, n, square, False)
    return n_full, d, {**config, "dtype": _dtype(p_full)}, fns


def _fused_select(x, w_ext, w_agr, beta):
    theta = w_ext.shape[0]
    variant = FS.variant_name(theta)
    if theta <= FS.MAX_EXACT_THETA:
        fns = [rf"fused_select_kernelILi{theta}E"]
    elif theta <= FS.MAX_THETA:
        fns = [rf"fused_select_kernelILi{FS.MAX_THETA}E"]
    elif theta <= FS.MAX_WIDE_THETA:
        fns = [r"fused_select_wide_kernel"]
    else:
        fns = [r"fused_select_count_kernel"]
    n, d = x.shape
    return n, d, {"theta": theta, "beta": int(beta), "variant": variant}, fns


#: wrapper name (its library's too) -> the configuration of its arguments
_CONFIGS: Dict[str, Callable] = {
    "pairwise_stats": _pairwise_stats,
    "dequant_stats": _dequant_stats,
    "pairwise_stats_rect": _pairwise_stats_rect,
    "dequant_stats_rect": _dequant_stats_rect,
    "fused_select": _fused_select,
}


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
    n, d, config, patterns = _CONFIGS[kernel](*args, **kwargs)
    rec = KernelRecord(
        kernel=kernel, route=route, n=int(n), d=int(d), config=config,
        ptxas=launched_resources(kernel, patterns) if route == "cuda"
        else None)
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
