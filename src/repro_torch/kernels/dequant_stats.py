"""K5 and K7: the fused dequantize -> statistics kernels (CUDA,
``csrc/dequant_stats.cu`` and ``csrc/dequant_stats_rect.cu``).

Replaces ``repro/kernels/dequant_stats.py::dequant_stats_pallas``: an
(n, d) int8 or bf16 wire payload (fp32 accepted) + (n,) fp32 row
multipliers -> K1's raw (n, n) distances and (n,) squared norms of the
decoded rows ``payload.float() * mult[:, None]``, without the decoded fp32
stack in device memory.  The kernel is K1's template with a widening
loader (``csrc/dequant_rows.cuh``: 4-byte payload words shared across the
warp, where every row starts on a word), launched with K1's
:func:`launch_config`, so on the card it equals K1 on the decoded stack
bit for bit.  Its plain version is ``kernels/ref.py::dequant_stats_ref``.

K7 replaces ``dequant_stats_rect_pallas``: one mesh rank's (n_loc, d)
payload block and multipliers against the gathered payload, K6's
rectangular template with K5's loader, equal to K5's matching rows bit for
bit.  Its plain version is ``ref.dequant_stats_rect_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.pairwise_sqdist import (check_rect_args, data_ptr,
                                                 is_whole, launch_config,
                                                 rect_scratch)

#: payload types the kernel reads, by the code its C entry point takes
DTYPE_CODES = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build.library("dequant_stats").dequant_stats_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_dequant_args(payload: torch.Tensor, mult: torch.Tensor) -> None:
    """The shape contract of the fused dequantize -> stats kernel."""
    if payload.ndim != 2:
        raise ValueError(f"payload must be (n, d), got shape "
                         f"{tuple(payload.shape)}")
    n = payload.shape[0]
    if tuple(mult.shape) != (n,):
        raise ValueError(f"mult must be ({n},), got {tuple(mult.shape)}")
    if payload.dtype not in DTYPE_CODES:
        raise ValueError(f"payload must be int8, bfloat16 or float32, got "
                         f"{payload.dtype}")


def dequant_stats_cuda(payload: torch.Tensor, mult: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 on a contiguous (n, d) payload and (n,) fp32 multipliers,
    both on one CUDA device.  Returns (raw (n, n) distances, (n,) squared
    norms) of the decoded rows, fp32, computed on the current stream.
    Raises on any input the kernel does not take."""
    check_dequant_args(payload, mult)
    for name, t in (("payload", payload), ("mult", mult)):
        if t.device.type != "cuda" or t.device != payload.device:
            raise ValueError(f"dequant_stats_cuda needs {name} on the CUDA "
                             f"device of the payload, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"dequant_stats_cuda needs a contiguous {name}")
    if mult.dtype != torch.float32:
        raise ValueError(f"dequant_stats_cuda needs float32 multipliers, "
                         f"got {mult.dtype}")
    n, d = payload.shape
    if n == 0 or d == 0:
        raise ValueError(f"empty payload {tuple(payload.shape)}")
    row_tile, chunks = launch_config(n, d)
    dev = payload.device
    partial = torch.empty((chunks, n, n), dtype=torch.float32, device=dev)
    dists = torch.empty((n, n), dtype=torch.float32, device=dev)
    norms = torch.empty((n,), dtype=torch.float32, device=dev)
    fn = _launch_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(payload.data_ptr(), DTYPE_CODES[payload.dtype],
                 mult.data_ptr(), partial.data_ptr(), dists.data_ptr(),
                 norms.data_ptr(), n, d, chunks, row_tile, stream)
    if err != 0:
        raise RuntimeError(f"dequant_stats kernel launch failed (cudaError "
                           f"{err}) for payload {payload.dtype} "
                           f"{tuple(payload.shape)}")
    dequant_stats_cuda.launches += 1
    return dists, norms


dequant_stats_cuda.launches = 0


@functools.lru_cache(maxsize=None)
def _rect_launch_fn():
    fn = build.library("dequant_stats_rect").dequant_stats_rect_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] \
        + [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_dequant_rect_args(p_loc: torch.Tensor, m_loc: torch.Tensor,
                            p_full: torch.Tensor, m_full: torch.Tensor,
                            n: Optional[int]) -> int:
    """The contract of ``dequant_stats_rect_pallas`` (one payload type for
    block and stack); returns the worker count the chunk count is K1's
    for."""
    n = check_rect_args(p_loc, p_full, n)
    check_dequant_args(p_loc, m_loc)
    check_dequant_args(p_full, m_full)
    if p_loc.dtype != p_full.dtype:
        raise ValueError(f"payload dtypes differ: {p_loc.dtype} vs "
                         f"{p_full.dtype}")
    return n


def dequant_stats_rect_cuda(p_loc: torch.Tensor, m_loc: torch.Tensor,
                            p_full: torch.Tensor, m_full: torch.Tensor, *,
                            n: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K7 on a contiguous (n_loc, d) payload block + (n_loc,) fp32
    multipliers and the gathered (n_full, d) payload + (n_full,)
    multipliers, all on one CUDA device.  ``n`` is the true worker count
    when the payload carries padding rows (default: all its rows).
    Returns (raw (n_loc, n_full) block, (n_full,) squared norms) of the
    decoded rows, fp32, on the current stream.  Raises on any input the
    kernel does not take."""
    n = check_dequant_rect_args(p_loc, m_loc, p_full, m_full, n)
    for name, t in (("p_loc", p_loc), ("m_loc", m_loc), ("p_full", p_full),
                    ("m_full", m_full)):
        if t.device.type != "cuda" or t.device != p_full.device:
            raise ValueError(f"dequant_stats_rect_cuda needs {name} on the "
                             f"CUDA device of p_full, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"dequant_stats_rect_cuda needs a contiguous "
                             f"{name}")
    if m_loc.dtype != torch.float32 or m_full.dtype != torch.float32:
        raise ValueError(f"dequant_stats_rect_cuda needs float32 "
                         f"multipliers, got {m_loc.dtype} / {m_full.dtype}")
    square = is_whole(p_loc, p_full, n) and is_whole(m_loc, m_full, n)
    chunks, tiles, scratch, (dists, norms) = rect_scratch(
        p_loc, p_full, n, square)
    (n_loc, d), n_full = p_loc.shape, p_full.shape[0]
    fn = _rect_launch_fn()
    with torch.cuda.device(p_full.device):
        stream = torch.cuda.current_stream(p_full.device).cuda_stream
        err = fn(p_loc.data_ptr(), m_loc.data_ptr(), p_full.data_ptr(),
                 m_full.data_ptr(), DTYPE_CODES[p_full.dtype],
                 *(data_ptr(t) for t in scratch), dists.data_ptr(),
                 norms.data_ptr(), n_loc, n_full, d, chunks, *tiles, stream)
    if err != 0:
        raise RuntimeError(f"dequant_stats_rect kernel launch failed "
                           f"(cudaError {err}) for payload {p_full.dtype} "
                           f"{tuple(p_loc.shape)} x {tuple(p_full.shape)}")
    dequant_stats_rect_cuda.launches += 1
    dequant_stats_rect_cuda.square_launches += square
    return dists, norms


dequant_stats_rect_cuda.launches = 0
#: of those launches, the ones that ran K5's symmetric grid (is_whole)
dequant_stats_rect_cuda.square_launches = 0
