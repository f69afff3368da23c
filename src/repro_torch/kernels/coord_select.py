"""K3: the Bulyan coordinate phase on materialised (θ, d) inputs (CUDA,
``csrc/coord_select.cu``).

Replaces ``repro/kernels/coord_select.py::coord_select_pallas``: (θ, d)
fp32 ``g_ext``/``g_agr`` + β -> (d,) fp32, the θ-median of ``g_ext`` and
the mean of the β ``g_agr`` values nearest it per coordinate.  It runs the
coordinate phase of K2 (``csrc/select_tile.cuh``) after loading the two
inputs, so the fused and the two-step substrates differ only in how the
inputs were formed.  A θ above ``MAX_THETA`` takes K2's network variant
of the phase (up to ``fused_select.MAX_WIDE_THETA``, the g_agr column in
shared memory) or its counted variant (above, which ranks straight from
the inputs' columns), so every θ runs;
``coord_select_cuda.variant_launches`` counts the launches of each
variant under K2's names (``fused_select.variant_name``).  The kernel's
header says what bounds it; its plain version is
``kernels/ref.py::coord_select_ref``, which it matches bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_select import launched_name

#: largest θ the kernel's unrolled register slots hold (above it, the
#: network and the counted variants)
MAX_THETA = 32
#: grid cap (132 SMs x 16 on an H100); a grid-stride loop covers the rest
MAX_BLOCKS = 2112
_THREADS = 256


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = build.library("coord_select").coord_select_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 \
        + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    fn.restype = ctypes.c_int
    return fn


def check_coord_args(g_ext: torch.Tensor, g_agr: torch.Tensor,
                     beta: int) -> None:
    """The shape contract of the coordinate phase (as
    ``coord_select_pallas``)."""
    if g_ext.shape != g_agr.shape:
        raise ValueError(f"g_ext/g_agr shapes differ: {tuple(g_ext.shape)} "
                         f"vs {tuple(g_agr.shape)}")
    if g_agr.ndim != 2:
        raise ValueError(f"expected (theta, d) inputs, got "
                         f"{tuple(g_agr.shape)}")
    theta = g_agr.shape[0]
    if not 1 <= beta <= theta:
        raise ValueError(f"need 1 <= beta <= theta, got beta={beta}, "
                         f"theta={theta}")


def coord_select_cuda(g_ext: torch.Tensor, g_agr: torch.Tensor,
                      beta: int) -> torch.Tensor:
    """Launch K3 on contiguous fp32 CUDA tensors; returns the (d,) fp32
    result, computed on the current stream.  Takes every θ; raises on any
    input the kernel does not take."""
    check_coord_args(g_ext, g_agr, beta)
    for name, t in (("g_ext", g_ext), ("g_agr", g_agr)):
        if t.device.type != "cuda" or t.device != g_ext.device:
            raise ValueError(f"coord_select_cuda needs {name} on the CUDA "
                             f"device of g_ext, got {t.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"coord_select_cuda needs contiguous float32 "
                             f"{name}, got {t.dtype}")
    theta, d = g_ext.shape
    if d == 0:
        raise ValueError("empty inputs")
    blocks = min(-(-d // _THREADS), MAX_BLOCKS)
    out = torch.empty((d,), dtype=torch.float32, device=g_ext.device)
    fn = _launch_fn()
    variant = ctypes.c_int32(0)
    with torch.cuda.device(g_ext.device):
        stream = torch.cuda.current_stream(g_ext.device).cuda_stream
        err = fn(g_ext.data_ptr(), g_agr.data_ptr(), out.data_ptr(), d,
                 theta, int(beta), blocks, stream, ctypes.byref(variant))
    if err != 0:
        raise RuntimeError(f"coord_select kernel launch failed "
                           f"(cudaError {err}) for inputs "
                           f"{tuple(g_ext.shape)}, beta={beta}")
    name = launched_name(variant.value)
    coord_select_cuda.launches += 1
    counts = coord_select_cuda.variant_launches
    counts[name] = counts.get(name, 0) + 1
    return out


coord_select_cuda.launches = 0
coord_select_cuda.variant_launches = {}
