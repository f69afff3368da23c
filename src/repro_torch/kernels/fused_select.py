"""K2: the fused multi-Bulyan apply kernel (CUDA, ``csrc/fused_select.cu``).

Replaces ``repro/kernels/fused_select.py::fused_select_pallas``: (n, d)
fp32 stack + (θ, n) plan weights ``w_ext``/``w_agr`` + β -> (d,) aggregate,
with no (θ, d) intermediate in device memory.  The kernel's header says
what bounds it and how its design meets that; its plain version is
``kernels/ref.py::fused_select_ref``, which it matches bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: largest θ the kernel's unrolled register slots hold
MAX_THETA = 32
#: grid cap (132 SMs x 16 on an H100); a grid-stride loop covers the rest
MAX_BLOCKS = 2112
_THREADS = 256


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build.library("fused_select").fused_select_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_select_args(x: torch.Tensor, w_ext: torch.Tensor,
                      w_agr: torch.Tensor, beta: int) -> None:
    """The shape contract of the fused apply (as ``fused_select_pallas``)."""
    if x.ndim != 2:
        raise ValueError(f"x must be (n, d), got shape {tuple(x.shape)}")
    n = x.shape[0]
    if w_ext.shape != w_agr.shape:
        raise ValueError(f"weight shapes differ: {tuple(w_ext.shape)} vs "
                         f"{tuple(w_agr.shape)}")
    if w_ext.ndim != 2 or w_ext.shape[1] != n:
        raise ValueError(f"weights must be (theta, n={n}), got "
                         f"{tuple(w_ext.shape)}")
    theta = w_ext.shape[0]
    if not 1 <= beta <= theta:
        raise ValueError(f"need 1 <= beta <= theta, got beta={beta}, "
                         f"theta={theta}")


def fused_select_cuda(x: torch.Tensor, w_ext: torch.Tensor,
                      w_agr: torch.Tensor, beta: int) -> torch.Tensor:
    """Launch K2 on contiguous fp32 CUDA tensors; returns the (d,) fp32
    aggregate, computed on the current stream.  Raises on any input the
    kernel does not take (θ > ``MAX_THETA`` included)."""
    check_select_args(x, w_ext, w_agr, beta)
    for name, t in (("x", x), ("w_ext", w_ext), ("w_agr", w_agr)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"fused_select_cuda needs {name} on the CUDA "
                             f"device of x, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_select_cuda needs contiguous float32 "
                             f"{name}, got {t.dtype}")
    n, d = x.shape
    theta = w_ext.shape[0]
    if theta > MAX_THETA:
        raise ValueError(f"fused_select_cuda holds theta <= {MAX_THETA} "
                         f"values in registers, got theta={theta}")
    if d == 0:
        raise ValueError("empty stack")
    blocks = min(-(-d // _THREADS), MAX_BLOCKS)
    out = torch.empty((d,), dtype=torch.float32, device=x.device)
    fn = _launch_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w_ext.data_ptr(), w_agr.data_ptr(),
                 out.data_ptr(), n, d, theta, int(beta), blocks, stream)
    if err != 0:
        raise RuntimeError(f"fused_select kernel launch failed "
                           f"(cudaError {err}) for x {tuple(x.shape)}, "
                           f"theta={theta}, beta={beta}")
    fused_select_cuda.launches += 1
    return out


fused_select_cuda.launches = 0
