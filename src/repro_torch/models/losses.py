"""Memory-bounded cross entropy (cf. ``repro.models.losses``).

The loss is taken over token chunks so that at most one chunk's
(tokens × vocab) fp32 logits live at a time in the forward pass.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import modules as M

Tensor = torch.Tensor


def _chunk_nll(readout_params: dict, tied: bool, xc: Tensor, yc: Tensor,
               wc: Tensor) -> Tensor:
    """Sum of masked NLL over one chunk.  xc: (c, d); yc, wc: (c,)."""
    if tied:
        logits = M.embedding_attend(readout_params["embed"], xc)
    else:
        logits = M.linear_apply(readout_params["lm_head"], xc)
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, 1, yc[:, None].long())[:, 0]
    return torch.sum((logz - gold) * wc)


def chunked_xent(x: Tensor, labels: Tensor, readout_params: dict, *,
                 tied: bool, mask: Optional[Tensor] = None,
                 chunk: int = 4096) -> Tensor:
    """Mean next-token NLL.  x: (B, S, d); labels: (B, S)."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    yf = labels.reshape(t)
    wf = torch.ones((t,), dtype=torch.float32, device=x.device) \
        if mask is None else mask.reshape(t).float()
    denom = torch.clamp(torch.sum(wf), min=1.0)
    if t <= chunk:
        return _chunk_nll(readout_params, tied, xf, yf, wf) / denom
    sums = [_chunk_nll(readout_params, tied, xf[c:c + chunk],
                       yf[c:c + chunk], wf[c:c + chunk])
            for c in range(0, t, chunk)]
    return torch.sum(torch.stack(sums)) / denom
