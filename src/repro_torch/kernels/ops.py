"""Public kernel entry points: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor.

The choice is made from the tensor's device alone.  There is no fallback:
for a tensor that is not on the CPU the kernel launches or the wrapper
raises.  The five wrappers the JAX package hooks (K1, K5, K6, K7, K2)
report each call to an installed ``obs.profile.KernelProfiler``, on both
routes (``obs.profile.record_kernel``; a no-op without one).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.obs.profile import record_kernel
from repro_torch.kernels.coord_select import check_coord_args, coord_select_cuda
from repro_torch.kernels.dequant_stats import (check_dequant_args,
                                               check_dequant_rect_args,
                                               dequant_stats_cuda,
                                               dequant_stats_rect_cuda)
from repro_torch.kernels.fused_select import check_select_args, fused_select_cuda
from repro_torch.kernels.pairwise_sqdist import (check_rect_args,
                                                 pairwise_sqdist_cuda,
                                                 pairwise_stats_cuda,
                                                 pairwise_stats_rect_cuda)

_WRAPPERS = {"pairwise_stats": pairwise_stats_cuda,
             "fused_select": fused_select_cuda,
             "dequant_stats": dequant_stats_cuda,
             "coord_select": coord_select_cuda,
             "pairwise_stats_rect": pairwise_stats_rect_cuda,
             "dequant_stats_rect": dequant_stats_rect_cuda,
             "pairwise_sqdist": pairwise_sqdist_cuda}


def pairwise_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single pass (n, d) -> (raw (n, n) sq-dists, (n,) sq-norms), fp32.

    Raw: unclamped, diagonal kept — finalise with
    ``core.api.finalize_dists`` after accumulating over leaves.
    """
    if x.device.type == "cpu":
        record_kernel("pairwise_stats", "plain", x)
        return ref.pairwise_stats_ref(x)
    out = pairwise_stats_cuda(x)
    record_kernel("pairwise_stats", "cuda", x)
    return out


def dequant_stats(payload: torch.Tensor, mult: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused dequantize -> single-pass stats: (n, d) int8 / bf16 / fp32
    payload + (n,) fp32 row multipliers -> (raw (n, n) sq-dists, (n,)
    sq-norms) of the decoded rows ``payload.float() * mult[:, None]``."""
    check_dequant_args(payload, mult)
    if payload.device.type == "cpu":
        record_kernel("dequant_stats", "plain", payload, mult)
        return ref.dequant_stats_ref(payload, mult)
    out = dequant_stats_cuda(payload, mult)
    record_kernel("dequant_stats", "cuda", payload, mult)
    return out


def pairwise_stats_rect(x_loc: torch.Tensor, x_full: torch.Tensor, *,
                        n: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A mesh rank's row block: (n_loc, d) block x (n_full, d) stack ->
    (raw (n_loc, n_full) block, (n_full,) sq-norms), fp32, the block's rows
    of :func:`pairwise_stats` on the stack.  ``n``: the true worker count
    when the stack carries padding rows (the kernel takes K1's chunk count
    for it; the plain version does not depend on it).

    On the card the grid depends on memory, not values: when ``x_loc`` is
    ``x_full`` itself (one tensor, same shape, no padding rows: a one-rank
    mesh) the kernel runs K1's symmetric grid, each product once; any
    other block, a copy of the whole stack included, runs the rectangular
    grid, each product of the block formed separately (a block that is
    rows of a stack of at most 16 rows, as on a mesh, loads each stack row
    once: the view path).  All give the same bits;
    :func:`square_launch_counts` and :func:`view_launch_counts` say which
    ran."""
    check_rect_args(x_loc, x_full, n)
    if x_full.device.type == "cpu":
        record_kernel("pairwise_stats_rect", "plain", x_loc, x_full, n=n)
        return ref.pairwise_stats_rect_ref(x_loc, x_full)
    out = pairwise_stats_rect_cuda(x_loc, x_full, n=n)
    record_kernel("pairwise_stats_rect", "cuda", x_loc, x_full, n=n)
    return out


def dequant_stats_rect(p_loc: torch.Tensor, m_loc: torch.Tensor,
                       p_full: torch.Tensor, m_full: torch.Tensor, *,
                       n: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`pairwise_stats_rect` of the decoded rows of a payload block
    and the gathered payload (one payload type: int8, bf16 or fp32).  On
    the card K5's symmetric grid runs when ``p_loc`` is ``p_full`` and
    ``m_loc`` is ``m_full`` (the same tensors, no padding rows), the
    rectangular grid otherwise."""
    check_dequant_rect_args(p_loc, m_loc, p_full, m_full, n)
    args = (p_loc, m_loc, p_full, m_full)
    if p_full.device.type == "cpu":
        record_kernel("dequant_stats_rect", "plain", *args, n=n)
        return ref.dequant_stats_rect_ref(*args)
    out = dequant_stats_rect_cuda(*args, n=n)
    record_kernel("dequant_stats_rect", "cuda", *args, n=n)
    return out


def pairwise_sqdist(x: torch.Tensor) -> torch.Tensor:
    """(n, d) fp32 or bf16 -> finalised (n, n) fp32 squared distances
    (clamped at 0, diagonal zeroed) in one pass."""
    if x.device.type == "cpu":
        return ref.pairwise_sqdist_ref(x)
    return pairwise_sqdist_cuda(x)


def fused_select(x: torch.Tensor, w_ext: torch.Tensor, w_agr: torch.Tensor,
                 beta: int) -> torch.Tensor:
    """Fused multi-Bulyan apply: (n, d) stack + (θ, n) plan -> (d,) fp32."""
    check_select_args(x, w_ext, w_agr, beta)
    if x.device.type == "cpu":
        record_kernel("fused_select", "plain", x, w_ext, w_agr, beta)
        return ref.fused_select_ref(x, w_ext, w_agr, beta)
    out = fused_select_cuda(x, w_ext, w_agr, beta)
    record_kernel("fused_select", "cuda", x, w_ext, w_agr, beta)
    return out


def coord_select(g_ext: torch.Tensor, g_agr: torch.Tensor,
                 beta: int) -> torch.Tensor:
    """Bulyan coordinate phase on materialised (θ, d) ``g_ext``/``g_agr``
    -> (d,) fp32 (the second step of the two-step apply)."""
    check_coord_args(g_ext, g_agr, beta)
    if g_ext.device.type == "cpu":
        return ref.coord_select_ref(g_ext, g_agr, beta)
    return coord_select_cuda(g_ext, g_agr, beta)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def square_launch_counts() -> Dict[str, int]:
    """Of the K6 and K7 launches in :func:`launch_counts`, those that ran the
    square kernel's symmetric grid because the block was the stack."""
    return {name: fn.square_launches for name, fn in _WRAPPERS.items()
            if hasattr(fn, "square_launches")}


def view_launch_counts() -> Dict[str, int]:
    """Of the K6 launches in :func:`launch_counts`, those that ran the
    rectangular grid's view path because the block was rows of a stack of
    at most 16 rows."""
    return {name: fn.view_launches for name, fn in _WRAPPERS.items()
            if hasattr(fn, "view_launches")}


def fused_select_variant_counts() -> Dict[str, int]:
    """Of the K2 launches in :func:`launch_counts`, those of each kernel
    variant: ``"theta=<θ>"`` (compiled for that θ), ``"theta<=32"`` (the
    guarded slots), ``"theta>32"`` (the network variant, θ up to 128) or
    ``"theta>128"`` (the counted variant)."""
    return dict(fused_select_cuda.variant_launches)


def coord_select_variant_counts() -> Dict[str, int]:
    """Of the K3 launches in :func:`launch_counts`, those of each kernel
    variant, named as :func:`fused_select_variant_counts` names K2's."""
    return dict(coord_select_cuda.variant_launches)


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "square_launches"):
            fn.square_launches = 0
        if hasattr(fn, "view_launches"):
            fn.view_launches = 0
    fused_select_cuda.variant_launches.clear()
    coord_select_cuda.variant_launches.clear()
