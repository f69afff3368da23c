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
    formula, in its operation order, in fp32).  The norms and the gram
    are accumulated in float64 over ``chunk``-column pieces and rounded
    once to fp32 before that formula.  In fp32 the two sums drift apart
    on long rows (one GEMM over hundreds of millions of columns loses
    about 1e-4 of the gram's diagonal on a GPU; on real gradient leaves a
    GEMM and a sum over 8e5 columns differ by 1e-5 of the largest norm),
    and the formula turns that drift into a distance between two equal
    rows.  Rounded once, each sum is within half an fp32 ulp of the exact
    one, and equal rows give exactly 0.
    """
    return _stats_over_pieces(x, lambda xc: xc.float(), chunk)


def dequant_stats_ref(payload: Tensor, mult: Tensor, *, chunk: int = 1 << 20
                      ) -> Tuple[Tensor, Tensor]:
    """(n, d) int8 / bf16 / fp32 payload + (n,) fp32 row multipliers ->
    :func:`pairwise_stats_ref` of the decoded rows
    ``payload.float() * mult[:, None]``, decoded one ``chunk``-column piece
    at a time (the pieces are those of ``pairwise_stats_ref``, so the
    result equals it on the decoded stack bit for bit)."""
    m = mult.float()[:, None]
    return _stats_over_pieces(payload, lambda pc: pc.float() * m, chunk)


def pairwise_stats_rect_ref(x_loc: Tensor, x_full: Tensor, *,
                            chunk: int = 1 << 20) -> Tuple[Tensor, Tensor]:
    """(n_loc, d) row block x (n, d) stack -> (raw (n_loc, n) block
    ``sq_l + sq_f - 2 gram``, (n,) sq-norms of the stack), fp32: the rows
    of :func:`pairwise_stats_ref` for the block's rows, from the block and
    the stack alone (O(n_loc n d) work), summed as it sums."""
    return _rect_over_pieces(x_loc, x_full, lambda xc: xc.float(),
                             lambda xc: xc.float(), chunk)


def dequant_stats_rect_ref(p_loc: Tensor, m_loc: Tensor, p_full: Tensor,
                           m_full: Tensor, *, chunk: int = 1 << 20
                           ) -> Tuple[Tensor, Tensor]:
    """:func:`pairwise_stats_rect_ref` of the decoded rows
    ``payload.float() * mult[:, None]`` of a payload block and the
    gathered payload (one payload type for both)."""
    if p_loc.dtype != p_full.dtype:
        raise ValueError(f"payload dtypes differ: {p_loc.dtype} vs "
                         f"{p_full.dtype}")
    ml, mf = m_loc.float()[:, None], m_full.float()[:, None]
    return _rect_over_pieces(p_loc, p_full, lambda pc: pc.float() * ml,
                             lambda pc: pc.float() * mf, chunk)


def pairwise_sqdist_ref(x: Tensor) -> Tensor:
    """(n, d) fp32 or bf16 -> finalised (n, n) squared distances:
    ``core.api.finalize_dists`` of :func:`pairwise_stats_ref`."""
    from repro_torch.core.api import finalize_dists
    return finalize_dists(pairwise_stats_ref(x)[0])


def _rect_over_pieces(x_loc: Tensor, x_full: Tensor, decode_loc,
                      decode_full, chunk: int) -> Tuple[Tensor, Tensor]:
    """:func:`_stats_over_pieces` for a row block against a stack."""
    n_loc, d = x_loc.shape
    n = x_full.shape[0]
    dev = x_full.device
    sq_l = torch.zeros((n_loc,), dtype=torch.float64, device=dev)
    sq_f = torch.zeros((n,), dtype=torch.float64, device=dev)
    gram = torch.zeros((n_loc, n), dtype=torch.float64, device=dev)
    for c0 in range(0, d, chunk):
        xl = decode_loc(x_loc[:, c0:c0 + chunk]).double()
        xf = decode_full(x_full[:, c0:c0 + chunk]).double()
        sq_l = sq_l + torch.sum(xl * xl, dim=1)
        sq_f = sq_f + torch.sum(xf * xf, dim=1)
        gram = gram + xl @ xf.T
    sq_l, sq_f, gram = sq_l.float(), sq_f.float(), gram.float()
    return sq_l[:, None] + sq_f[None, :] - 2.0 * gram, sq_f


def _stats_over_pieces(x: Tensor, decode, chunk: int
                       ) -> Tuple[Tensor, Tensor]:
    n, d = x.shape
    sq = torch.zeros((n,), dtype=torch.float64, device=x.device)
    gram = torch.zeros((n, n), dtype=torch.float64, device=x.device)
    for c0 in range(0, d, chunk):
        # decoded in fp32 (the wire's decode), widened exactly
        xc = decode(x[:, c0:c0 + chunk]).double()
        sq = sq + torch.sum(xc * xc, dim=1)
        gram = gram + xc @ xc.T
    sq, gram = sq.float(), gram.float()
    return sq[:, None] + sq[None, :] - 2.0 * gram, sq


def fused_select_ref(x: Tensor, w_ext: Tensor, w_agr: Tensor, beta: int, *,
                     chunk: int = 1 << 20) -> Tensor:
    """(n, d) stack + (θ, n) plan weights -> (d,) multi-Bulyan aggregate.

    Per coordinate: the two contractions over the worker axis, then the
    coordinate phase of :func:`coord_select_ref`.  The contractions run row
    by row, each product and sum rounded on its own — the CUDA kernel's
    order, so the two agree bit for bit.  Columns are independent, so the
    work is cut into ``chunk``-column pieces to bound the (θ, θ, chunk)
    rank count.
    """
    theta, n = w_ext.shape
    d = x.shape[1]
    out = torch.empty((d,), dtype=torch.float32, device=x.device)
    we = w_ext.float()
    wa = w_agr.float()
    for c0 in range(0, d, chunk):
        xc = x[:, c0:c0 + chunk].float()
        ext = torch.zeros((theta, xc.shape[1]), dtype=torch.float32,
                          device=x.device)
        agr = torch.zeros_like(ext)
        for i in range(n):
            ext = ext + we[:, i:i + 1] * xc[i:i + 1]
            agr = agr + wa[:, i:i + 1] * xc[i:i + 1]
        out[c0:c0 + chunk] = _coordinate_phase(ext, agr, beta)
    return out


def coord_select_ref(g_ext: Tensor, g_agr: Tensor, beta: int, *,
                     chunk: int = 1 << 20) -> Tensor:
    """(θ, d) extracted and aggregated values -> (d,) coordinate phase.

    Per coordinate: the θ-median of ``g_ext`` (midpoint of the middle pair
    for even θ; ``torch.sort`` orders NaN last), the β ``g_agr`` values
    nearest it by rank counting (ties to the lower index; a NaN distance
    ranks 0, so it is always taken), their sum in row order divided by β.
    ``csrc/select_tile.cuh``, which K2 and K3 share, reaches the same
    median and the same set by a sorting network and a threshold, and sums
    in the same order, so the two agree with this bit for bit.  Cut into
    ``chunk``-column pieces as :func:`fused_select_ref`.
    """
    d = g_ext.shape[1]
    out = torch.empty((d,), dtype=torch.float32, device=g_ext.device)
    for c0 in range(0, d, chunk):
        out[c0:c0 + chunk] = _coordinate_phase(
            g_ext[:, c0:c0 + chunk].float(), g_agr[:, c0:c0 + chunk].float(),
            beta)
    return out


def _coordinate_phase(ext: Tensor, agr: Tensor, beta: int) -> Tensor:
    """(θ, c) fp32 ext / agr -> (c,): ``select_tile.cuh`` in PyTorch."""
    theta = ext.shape[0]
    idx = torch.arange(theta, device=ext.device)
    lower = (idx[None, :] < idx[:, None])[:, :, None]          # k < t
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
    # a tensor divisor: PyTorch divides a CUDA tensor by a Python scalar
    # as a product with its reciprocal, an ulp off the kernel's division
    # for a β that is not a power of two
    return s / torch.full_like(s, float(beta))
