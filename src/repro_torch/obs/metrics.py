"""Campaign accumulators (cf. ``repro.obs.metrics``): the per-worker
suspicion EMA that ``repro_torch.sim`` carries across the steps and
phases of a campaign, as fp32 tensors on the device of the selection it
is fed.  The metrics registry of the JAX module is not ported yet."""
from __future__ import annotations

from typing import Optional, Union

import torch

Tensor = torch.Tensor


def init_suspicion(n_workers: int, *,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Tensor:
    return torch.zeros((n_workers,), dtype=torch.float32, device=device)


def update_suspicion(susp: Tensor, selection: Tensor, ema: float) -> Tensor:
    """EMA of per-worker rejection.

    A worker's per-step rejection is ``1 - selection_i / max_j selection_j``
    (0 for the most-trusted worker, 1 for a fully rejected one) — normalised
    so weighted rules and uniform rules land on the same scale.
    """
    rej = 1.0 - selection / (torch.max(selection) + 1e-12)
    return ema * susp + (1.0 - ema) * rej


def update_ema(prev: Tensor, value: Tensor, ema: float) -> Tensor:
    """Plain per-worker EMA — the suspicion-carry pattern for any 0/1
    indicator (the async service uses it on the per-round overstale mask,
    so campaigns report *sustained* staleness per worker, not one-round
    blips)."""
    return ema * prev + (1.0 - ema) * value.float()
