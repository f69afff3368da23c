"""Plain PyTorch versions of the CUDA kernels.

Each function computes what its kernel computes, with ordinary tensor
operations.  ``kernels/ops.py`` takes them for CPU tensors; the tests hold
them to the JAX package, and ``chip_smoke.py`` holds each kernel to its
plain version on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def pairwise_stats_ref(x: Tensor, *, chunk: int = 1 << 20
                       ) -> Tuple[Tensor, Tensor]:
    """(n, d) -> (raw (n, n) ``sq_i + sq_j - 2 gram``, (n,) sq-norms), fp32.

    Raw: unclamped, diagonal kept, so contributions accumulate across
    leaves before ``core.api.finalize_dists`` (the JAX ``_stats_tile``
    formula, in its operation order).  The norms and the gram are summed
    over ``chunk``-column pieces: one GEMM over hundreds of millions of
    columns loses about 1e-4 of the gram's diagonal in fp32 on a GPU,
    while the per-piece sums keep the error near 1e-6.
    """
    n, d = x.shape
    sq = torch.zeros((n,), dtype=torch.float32, device=x.device)
    gram = torch.zeros((n, n), dtype=torch.float32, device=x.device)
    for c0 in range(0, d, chunk):
        xc = x[:, c0:c0 + chunk].float()
        sq = sq + torch.sum(xc * xc, dim=1)
        gram = gram + xc @ xc.T
    return sq[:, None] + sq[None, :] - 2.0 * gram, sq


def fused_select_ref(x: Tensor, w_ext: Tensor, w_agr: Tensor, beta: int, *,
                     chunk: int = 1 << 20) -> Tensor:
    """(n, d) stack + (θ, n) plan weights -> (d,) multi-Bulyan aggregate.

    Per coordinate: the two contractions over the worker axis, the θ-median
    of the extracted values (midpoint of the middle pair for even θ), the
    β aggregated values nearest it by rank counting (ties to the lower
    index), their mean.  The contractions and the final sum run row by
    row, each product and sum rounded on its own — the CUDA kernel's order,
    so the two agree bit for bit.  Columns are independent, so the work is
    cut into ``chunk``-column pieces to bound the (θ, θ, chunk) rank count.
    """
    theta, n = w_ext.shape
    d = x.shape[1]
    out = torch.empty((d,), dtype=torch.float32, device=x.device)
    we = w_ext.float()
    wa = w_agr.float()
    idx = torch.arange(theta, device=x.device)
    lower = (idx[None, :] < idx[:, None])[:, :, None]          # k < t
    for c0 in range(0, d, chunk):
        xc = x[:, c0:c0 + chunk].float()
        ext = torch.zeros((theta, xc.shape[1]), dtype=torch.float32,
                          device=x.device)
        agr = torch.zeros_like(ext)
        for i in range(n):
            ext = ext + we[:, i:i + 1] * xc[i:i + 1]
            agr = agr + wa[:, i:i + 1] * xc[i:i + 1]
        srt = torch.sort(ext, dim=0).values
        h = theta // 2
        med = srt[h] if theta % 2 else 0.5 * (srt[h - 1] + srt[h])
        dist = torch.abs(agr - med[None, :])
        # rank[t] = #{k: dist[k] < dist[t]} + #{k < t: dist[k] == dist[t]}
        lt = dist[None, :, :] < dist[:, None, :]
        eq = (dist[None, :, :] == dist[:, None, :]) & lower
        sel = torch.sum(lt | eq, dim=1) < beta
        s = torch.zeros_like(med)
        for t in range(theta):
            s = s + torch.where(sel[t], agr[t], torch.zeros_like(s))
        out[c0:c0 + chunk] = s / float(beta)
    return out
