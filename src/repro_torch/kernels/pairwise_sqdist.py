"""K1: the single-pass pairwise statistics kernel (CUDA, ``csrc/pairwise_stats.cu``).

Replaces ``repro/kernels/pairwise_sqdist.py::pairwise_stats_pallas``:
(n, d) fp32 stack -> raw (n, n) ``sq_i + sq_j - 2 gram`` (unclamped,
diagonal kept) and (n,) squared norms, one read of the stack.  The
kernel's header says what bounds it and how its design meets that; its
plain version is ``kernels/ref.py::pairwise_stats_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

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
