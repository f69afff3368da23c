"""The pairwise statistics kernels of one stack (CUDA).

* K1 (``csrc/pairwise_stats.cu``) replaces
  ``repro/kernels/pairwise_sqdist.py::pairwise_stats_pallas``: (n, d) fp32
  stack -> raw (n, n) ``sq_i + sq_j - 2 gram`` (unclamped, diagonal kept)
  and (n,) squared norms, one read of the stack.  Plain version:
  ``kernels/ref.py::pairwise_stats_ref``.
* K6 (``csrc/pairwise_stats_rect.cu``) replaces ``pairwise_stats_rect_pallas``:
  one mesh rank's (n_loc, d) row block against the gathered (n, d) stack
  -> the raw (n_loc, n) block and the (n,) norms, equal to K1's matching
  rows bit for bit, on K1's symmetric grid when the block is the stack,
  else on the rectangular grid, whose view path serves a block that is a
  view of a stack of at most 16 rows.  Plain version:
  ``ref.pairwise_stats_rect_ref``.
* K4 (``csrc/pairwise_sqdist.cu``) replaces ``pairwise_sqdist_pallas``: the
  finalised (n, n) distances of an fp32 or bf16 stack, equal to
  ``core.api.finalize_dists`` of K1's raw output bit for bit.  Plain
  version: ``ref.pairwise_sqdist_ref``.

Each kernel's header says what bounds it and how its design meets that.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

#: blocks the partial-gram grid aims for (132 SMs x 8 on an H100; only the
#: chunk count, and with it the fp32 summation order, depends on it)
TARGET_BLOCKS = 1056
#: cap on the (chunks, n, n) fp32 scratch buffer
MAX_SCRATCH_BYTES = 1 << 28
_COLS_PER_BLOCK = 256


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build.library("pairwise_stats").pairwise_stats_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_config(n: int, d: int) -> Tuple[int, int]:
    """(row_tile, chunks) for an (n, d) stack.

    One diagonal tile of 8, 12 or 16 rows covers n <= 16 (n = 11: 78
    register accumulators a thread); larger n is cut into 8-row tiles whose
    pairs form the grid's y axis.  The d axis is cut into as many chunks as fill the card, at
    most one per 256 columns and at most what the scratch cap allows.
    """
    row_tile = next((r for r in (8, 12, 16) if n <= r), 8)
    tiles = -(-n // row_tile)
    pairs = tiles * (tiles + 1) // 2
    chunks = min(-(-d // _COLS_PER_BLOCK), max(1, -(-TARGET_BLOCKS // pairs)),
                 max(1, MAX_SCRATCH_BYTES // (4 * n * n)))
    return row_tile, chunks


def pairwise_stats_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on a contiguous (n, d) fp32 CUDA tensor.

    Returns (raw (n, n) distances, (n,) squared norms), both fp32, computed
    on the current stream.  Raises on any input the kernel does not take.
    """
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("pairwise_stats_cuda needs a CUDA tensor")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"pairwise_stats_cuda needs a contiguous (n, d) "
                         f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    n, d = x.shape
    if n == 0 or d == 0:
        raise ValueError(f"empty stack {tuple(x.shape)}")
    row_tile, chunks = launch_config(n, d)
    partial = torch.empty((chunks, n, n), dtype=torch.float32, device=x.device)
    dists = torch.empty((n, n), dtype=torch.float32, device=x.device)
    norms = torch.empty((n,), dtype=torch.float32, device=x.device)
    fn = _launch_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), partial.data_ptr(), dists.data_ptr(),
                 norms.data_ptr(), n, d, chunks, row_tile, stream)
    if err != 0:
        raise RuntimeError(f"pairwise_stats kernel launch failed "
                           f"(cudaError {err}) for shape {tuple(x.shape)}")
    pairwise_stats_cuda.launches += 1
    return dists, norms


pairwise_stats_cuda.launches = 0


@functools.lru_cache(maxsize=None)
def _rect_launch_fn():
    fn = build.library("pairwise_stats_rect").pairwise_stats_rect_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 8 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rect_tiles(n_loc: int, n_full: int) -> Tuple[int, int]:
    """(local, full) register tiles of the rectangular kernels: 4 local
    rows for a block of at most 4 (a 4-rank block of 11 workers: 3), else
    8; one full tile of 8, 12 or 16 rows up to 16, else 8-row tiles.  Only
    the work split depends on them, not the result."""
    tile_full = next((r for r in (8, 12, 16) if n_full <= r), 8)
    return (4 if n_loc <= 4 else 8), tile_full


def check_rect_args(x_loc: torch.Tensor, x_full: torch.Tensor,
                    n: Optional[int]) -> int:
    """The shape contract of the rectangular kernels; returns the worker
    count whose chunk count they take (``x_full``'s rows by default)."""
    if x_loc.ndim != 2 or x_full.ndim != 2:
        raise ValueError(f"need 2-d operands, got {tuple(x_loc.shape)} / "
                         f"{tuple(x_full.shape)}")
    if x_loc.shape[1] != x_full.shape[1]:
        raise ValueError(f"lane axes differ: {x_loc.shape[1]} vs "
                         f"{x_full.shape[1]}")
    n_full = x_full.shape[0]
    n = n_full if n is None else int(n)
    if not 1 <= n <= n_full:
        raise ValueError(f"n={n} must lie in [1, {n_full}] (the stack's "
                         f"rows, padding included)")
    return n


def rect_scratch(x_loc: torch.Tensor, x_full: torch.Tensor, n: int,
                 square: bool):
    """(chunks, (local tile, full tile, square tile), scratch, outputs) of
    one rectangular launch: K1's chunk count for ``n`` workers, so each
    element repeats K1's sum.  ``square``: the block is the whole stack
    (the same tensor, no padding), so the kernel runs K1's symmetric grid
    with K1's row tile; that grid keeps the self products on the gram's
    diagonal, so the (chunks, n_loc) and (chunks, n_full) self-product
    scratch is then None (a null pointer to the kernel)."""
    n_loc, d = x_loc.shape
    n_full = x_full.shape[0]
    if n_loc == 0 or d == 0:
        raise ValueError(f"empty block {tuple(x_loc.shape)}")
    row_tile, chunks = launch_config(n, d)
    dev = x_full.device

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    selfs = (None, None) if square else (f32(chunks, n_loc),
                                         f32(chunks, n_full))
    scratch = (f32(chunks, n_loc, n_full),) + selfs
    tiles = rect_tiles(n_loc, n_full) + (row_tile if square else 0,)
    return chunks, tiles, scratch, (f32(n_loc, n_full), f32(n_full))


def data_ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """``t``'s device address, None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def is_whole(part: torch.Tensor, whole: torch.Tensor, n: int) -> bool:
    """``part`` is ``whole`` itself (same memory and shape) and ``whole``
    has no padding rows: the condition on which K6 and K7 run the square
    kernel's symmetric grid instead of the rectangular one.  A copy of the
    stack is not ``whole`` and takes the rectangular grid (the same values,
    each product formed twice)."""
    return part.data_ptr() == whole.data_ptr() and \
        part.shape == whole.shape and whole.shape[0] == n


def view_row(part: torch.Tensor, whole: torch.Tensor) -> Optional[int]:
    """The row offset r0 when ``part`` is rows [r0, r0 + n_loc) of ``whole``
    (the same memory: a mesh rank's block of the gathered stack), else
    None.  Both must be contiguous (n, d) fp32 tensors of one storage on
    one device, ``part`` a whole number of rows into ``whole`` and inside
    it.  A copy, a column slice, a non-contiguous block, a start between
    rows or rows outside ``whole`` give None."""
    if part.ndim != 2 or whole.ndim != 2 or part.shape[1] != whole.shape[1] \
            or part.dtype != torch.float32 or whole.dtype != torch.float32 \
            or part.device != whole.device or not part.is_contiguous() \
            or not whole.is_contiguous() or part.shape[1] == 0:
        return None
    if part.untyped_storage().data_ptr() != \
            whole.untyped_storage().data_ptr():
        return None
    offset = part.data_ptr() - whole.data_ptr()
    row_bytes = 4 * whole.shape[1]
    if offset < 0 or offset % row_bytes:
        return None
    r0 = offset // row_bytes
    return r0 if r0 + part.shape[0] <= whole.shape[0] else None


def rect_view_arg(x_loc: torch.Tensor, x_full: torch.Tensor, tiles) -> int:
    """K6's ``view_row`` argument for ``rect_scratch``'s ``tiles``: the
    block's row offset when the view path runs (not the symmetric grid,
    the stack within one full tile, the block a view of it), else -1."""
    square_tile, tile_full = tiles[2], tiles[1]
    if square_tile > 0 or x_full.shape[0] > tile_full:
        return -1
    r0 = view_row(x_loc, x_full)
    return -1 if r0 is None else r0


def pairwise_stats_rect_cuda(x_loc: torch.Tensor, x_full: torch.Tensor, *,
                             n: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K6 on a contiguous (n_loc, d) fp32 row block and the (n_full,
    d) fp32 stack on one CUDA device.  ``n`` is the true worker count when
    the stack carries padding rows (default: all its rows); the chunk count
    is K1's for it.  Returns (raw (n_loc, n_full) block, (n_full,) squared
    norms), fp32, on the current stream.  Raises on any input the kernel
    does not take."""
    n = check_rect_args(x_loc, x_full, n)
    for name, t in (("x_loc", x_loc), ("x_full", x_full)):
        if t.device.type != "cuda" or t.device != x_full.device:
            raise ValueError(f"pairwise_stats_rect_cuda needs {name} on the "
                             f"CUDA device of x_full, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"pairwise_stats_rect_cuda needs a contiguous "
                             f"float32 {name}, got {t.dtype}")
    square = is_whole(x_loc, x_full, n)
    chunks, tiles, scratch, (dists, norms) = rect_scratch(
        x_loc, x_full, n, square)
    r0 = rect_view_arg(x_loc, x_full, tiles)
    (n_loc, d), n_full = x_loc.shape, x_full.shape[0]
    fn = _rect_launch_fn()
    with torch.cuda.device(x_full.device):
        stream = torch.cuda.current_stream(x_full.device).cuda_stream
        err = fn(x_loc.data_ptr(), x_full.data_ptr(),
                 *(data_ptr(t) for t in scratch), dists.data_ptr(),
                 norms.data_ptr(), n_loc, n_full, d, chunks, *tiles, r0,
                 stream)
    if err != 0:
        raise RuntimeError(f"pairwise_stats_rect kernel launch failed "
                           f"(cudaError {err}) for {tuple(x_loc.shape)} x "
                           f"{tuple(x_full.shape)}")
    pairwise_stats_rect_cuda.launches += 1
    pairwise_stats_rect_cuda.square_launches += square
    pairwise_stats_rect_cuda.view_launches += r0 >= 0
    return dists, norms


pairwise_stats_rect_cuda.launches = 0
#: of those launches, the ones that ran K1's symmetric grid (is_whole)
pairwise_stats_rect_cuda.square_launches = 0
#: and the ones that ran the rectangular grid's view path (rect_view_arg)
pairwise_stats_rect_cuda.view_launches = 0

#: stack types K4 reads, by the code its C entry point takes
SQDIST_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 2}


@functools.lru_cache(maxsize=None)
def _sqdist_launch_fn():
    fn = build.library("pairwise_sqdist").pairwise_sqdist_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 2 \
        + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pairwise_sqdist_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch K4 on a contiguous (n, d) fp32 or bf16 CUDA tensor: the
    finalised (n, n) fp32 squared distances (clamped at 0, diagonal
    zeroed), on the current stream.  Raises on any input the kernel does
    not take."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError("pairwise_sqdist_cuda needs a CUDA tensor")
    if x.dtype not in SQDIST_DTYPE_CODES or x.ndim != 2 or \
            not x.is_contiguous():
        raise ValueError(f"pairwise_sqdist_cuda needs a contiguous (n, d) "
                         f"float32 or bfloat16 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    n, d = x.shape
    if n == 0 or d == 0:
        raise ValueError(f"empty stack {tuple(x.shape)}")
    row_tile, chunks = launch_config(n, d)
    partial = torch.empty((chunks, n, n), dtype=torch.float32, device=x.device)
    dists = torch.empty((n, n), dtype=torch.float32, device=x.device)
    fn = _sqdist_launch_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), SQDIST_DTYPE_CODES[x.dtype], partial.data_ptr(),
                 dists.data_ptr(), n, d, chunks, row_tile, stream)
    if err != 0:
        raise RuntimeError(f"pairwise_sqdist kernel launch failed "
                           f"(cudaError {err}) for {x.dtype} "
                           f"{tuple(x.shape)}")
    pairwise_sqdist_cuda.launches += 1
    return dists


pairwise_sqdist_cuda.launches = 0
