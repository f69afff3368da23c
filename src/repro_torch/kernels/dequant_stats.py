"""K5: the fused dequantize -> statistics kernel (CUDA, ``csrc/dequant_stats.cu``).

Replaces ``repro/kernels/dequant_stats.py::dequant_stats_pallas``: an
(n, d) int8 or bf16 wire payload (fp32 accepted) + (n,) fp32 row
multipliers -> K1's raw (n, n) distances and (n,) squared norms of the
decoded rows ``payload.float() * mult[:, None]``, without the decoded fp32
stack in device memory.  The kernel is K1's template with a widening
loader, launched with K1's :func:`launch_config`, so on the card it equals
K1 on the decoded stack bit for bit.  Its plain version is
``kernels/ref.py::dequant_stats_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.pairwise_sqdist import launch_config

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
