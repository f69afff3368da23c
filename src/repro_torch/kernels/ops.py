"""Public kernel entry points: the CUDA kernel for a CUDA tensor, the plain
PyTorch version for a CPU tensor.

The choice is made from the tensor's device alone.  There is no fallback:
for a tensor that is not on the CPU the kernel launches or the wrapper
raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.fused_select import check_select_args, fused_select_cuda
from repro_torch.kernels.pairwise_sqdist import pairwise_stats_cuda

_WRAPPERS = {"pairwise_stats": pairwise_stats_cuda,
             "fused_select": fused_select_cuda}


def pairwise_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single pass (n, d) -> (raw (n, n) sq-dists, (n,) sq-norms), fp32.

    Raw: unclamped, diagonal kept — finalise with
    ``core.api.finalize_dists`` after accumulating over leaves.
    """
    if x.device.type == "cpu":
        return ref.pairwise_stats_ref(x)
    return pairwise_stats_cuda(x)


def fused_select(x: torch.Tensor, w_ext: torch.Tensor, w_agr: torch.Tensor,
                 beta: int) -> torch.Tensor:
    """Fused multi-Bulyan apply: (n, d) stack + (θ, n) plan -> (d,) fp32."""
    check_select_args(x, w_ext, w_agr, beta)
    if x.device.type == "cpu":
        return ref.fused_select_ref(x, w_ext, w_agr, beta)
    return fused_select_cuda(x, w_ext, w_agr, beta)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
