"""K2: the fused multi-Bulyan apply kernel (CUDA, ``csrc/fused_select.cu``).

Replaces ``repro/kernels/fused_select.py::fused_select_pallas``: (n, d)
fp32 stack + (θ, n) plan weights ``w_ext``/``w_agr`` + β -> (d,) aggregate,
with no (θ, d) intermediate in device memory.  The kernel's header says
what bounds it and how its design meets that; its plain version is
``kernels/ref.py::fused_select_ref``, which it matches bit for bit.

A θ ≤ ``MAX_EXACT_THETA`` takes a kernel compiled for that θ, one up to
``MAX_THETA`` the kernel over ``MAX_THETA`` slots guarded by the runtime
θ, one up to ``MAX_WIDE_THETA`` the network variant, which keeps the
coordinate's θ extracted and θ aggregated values in shared memory, and
every larger θ the counted variant, which ranks by counting and keeps
them in a scratch allocated for the launch, of the size that
``fused_select.cu`` gives (``fused_select_scratch_floats``; its launcher
refuses a smaller one).  ``fused_select_cuda.variant_launches`` counts the
launches of each (``"theta=5"``, ``"theta<=32"``, ``"theta>32"``,
``"theta>128"``) beside ``launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: largest θ the kernel's unrolled register slots hold
MAX_THETA = 32
#: largest θ with a kernel compiled for it
MAX_EXACT_THETA = 16
#: the slot counts of the network variant's buckets (``for_bucket`` in
#: ``csrc/select_count.cuh``; ``*_select_wide_shape`` reports a θ's): a θ
#: in (previous, S] runs over S slots
NETWORK_SLOTS = (40, 48, 64, 96, 128)
#: largest θ of the network variant (the column on chip); the counted
#: variant takes every larger θ
MAX_WIDE_THETA = NETWORK_SLOTS[-1]
#: the names of what the launchers report for the θ > 32 variants
#: (``kNetworkVariant``, ``kCountedVariant`` in ``csrc/select_count.cuh``)
_REPORTED = {-1: f"theta>{MAX_THETA}", -2: f"theta>{MAX_WIDE_THETA}"}
#: grid cap of the θ ≤ 32 kernels (132 SMs x 16 on an H100; 1056 times
#: the same on the main path); a grid-stride loop covers the rest
MAX_BLOCKS = 2112


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build.library("fused_select").fused_select_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6 \
        + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _scratch_fn():
    fn = build.library("fused_select").fused_select_scratch_floats
    fn.argtypes = [ctypes.c_int64] * 2
    fn.restype = ctypes.c_int64
    return fn


def wide_shape(theta: int, library: str = "fused_select"):
    """The network variant's launch at θ on the current card, as K2's
    library (or K3's, ``"coord_select"``) reports it: {"slots": its
    bucket's, "threads", "smem_bytes" (a block's), "blocks_per_sm"}; None
    for a θ outside 33..``MAX_WIDE_THETA``."""
    fn = getattr(build.library(library), f"{library}_wide_shape")
    slots, threads, per_sm = (ctypes.c_int32(0) for _ in range(3))
    smem = ctypes.c_int64(0)
    err = fn(ctypes.c_int64(theta), ctypes.byref(slots),
             ctypes.byref(threads), ctypes.byref(smem), ctypes.byref(per_sm))
    if err == 1:  # cudaErrorInvalidValue: not a network variant's θ
        return None
    if err != 0:
        raise RuntimeError(f"{library}_wide_shape failed (cudaError {err}) "
                           f"at theta={theta}")
    return {"slots": slots.value, "threads": threads.value,
            "smem_bytes": smem.value, "blocks_per_sm": per_sm.value}


def variant_name(theta: int) -> str:
    """The kernel variant a θ takes (the name its launches count under):
    the same for K2 and K3, which share their dispatch."""
    if theta <= MAX_EXACT_THETA:
        return f"theta={theta}"
    if theta <= MAX_THETA:
        return f"theta<={MAX_THETA}"
    return f"theta>{MAX_THETA}" if theta <= MAX_WIDE_THETA \
        else f"theta>{MAX_WIDE_THETA}"


def launched_name(variant: int) -> str:
    """The name of the variant a launcher reported taking: its θ for a
    kernel compiled for it, ``MAX_THETA`` for the guarded one, -1 for the
    network variant and -2 for the counted one."""
    return _REPORTED.get(variant) or variant_name(variant)


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
    aggregate, computed on the current stream.  Takes every θ; raises on
    any input the kernel does not take."""
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
    if d == 0:
        raise ValueError("empty stack")
    out = torch.empty((d,), dtype=torch.float32, device=x.device)
    floats = _scratch_fn()(d, theta)
    scratch = torch.empty((floats,), dtype=torch.float32,
                          device=x.device) if floats > 0 else None
    fn = _launch_fn()
    variant = ctypes.c_int32(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w_ext.data_ptr(), w_agr.data_ptr(),
                 out.data_ptr(), None if scratch is None
                 else scratch.data_ptr(), max(floats, 0), n, d, theta,
                 int(beta), MAX_BLOCKS, stream, ctypes.byref(variant))
    if err != 0:
        raise RuntimeError(f"fused_select kernel launch failed "
                           f"(cudaError {err}) for x {tuple(x.shape)}, "
                           f"theta={theta}, beta={beta}")
    name = launched_name(variant.value)
    fused_select_cuda.launches += 1
    counts = fused_select_cuda.variant_launches
    counts[name] = counts.get(name, 0) + 1
    return out


fused_select_cuda.launches = 0
fused_select_cuda.variant_launches = {}
