"""Gradient Aggregation Rules (cf. ``repro.core.gar``).

All rules take a stacked gradient matrix ``G`` of shape ``(n, d)`` and
return the aggregate ``(d,)``.  The multi-Bulyan extraction follows
Algorithm 1: θ = n-2f-2 rounds of MULTI-KRUM over the remaining pool, the
pool removal expressed as an ``alive`` mask (dead entries get +inf
scores); the coordinate phase takes the θ-median of the extracted values
and averages the β = θ-2f aggregated values nearest it.

Plans (scores, masks, extraction weights) are computed on detached
distances: selection is piecewise constant, so the aggregate's gradient
flows through the selected averages only.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def _median_axis0(x: Tensor) -> Tensor:
    s = torch.sort(x, dim=0).values
    n = x.shape[0]
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


# --------------------------------------------------------------------------
# distances & scores
# --------------------------------------------------------------------------
def pairwise_sqdist(G: Tensor) -> Tensor:
    """(n, d) -> (n, n) squared euclidean distances, fp32, zero diagonal.

    The gram decomposition ``||a||² + ||b||² - 2 a·b`` in fp32, clamped at
    0 (NaN propagates, as ``jnp.maximum`` does) with the diagonal zeroed.
    """
    Gf = G.float()
    sq = torch.sum(Gf * Gf, dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (Gf @ Gf.T)
    d2 = torch.maximum(d2, torch.zeros_like(d2))
    n = G.shape[0]
    return d2 * (1.0 - torch.eye(n, dtype=d2.dtype, device=d2.device))


def krum_scores(dists: Tensor, f: int, alive: Optional[Tensor] = None,
                n_neighbors: Optional[int] = None) -> Tensor:
    """Krum score per worker: sum of sq-distances to its nearest neighbours.

    ``alive`` is an optional (n,) bool pool mask (dead workers are excluded
    as scorers and as neighbours); ``n_neighbors`` defaults to k - f - 2
    with k the pool size.  Sorting puts NaN last, as in JAX.
    """
    n = dists.shape[0]
    dev = dists.device
    if alive is None:
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
    if n_neighbors is None:
        n_neighbors = int(alive.sum()) - f - 2
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    valid = alive[None, :] & ~eye
    inf = torch.tensor(float("inf"), dtype=dists.dtype, device=dev)
    masked = torch.where(valid, dists.detach(), inf)
    srt = torch.sort(masked, dim=1).values
    take = torch.arange(n, device=dev)[None, :] < n_neighbors
    scores = torch.sum(torch.where(take, srt, torch.zeros_like(srt)), dim=1)
    return torch.where(alive, scores, inf)


def _select_smallest_mask(scores: Tensor, m: int) -> Tensor:
    """Boolean mask of the m smallest scores, ties broken by index:
    rank(i) = #{j: s_j < s_i} + #{j < i: s_j == s_i}."""
    n = scores.shape[0]
    idx = torch.arange(n, device=scores.device)
    lt = scores[None, :] < scores[:, None]
    eq = (scores[None, :] == scores[:, None]) & (idx[None, :] < idx[:, None])
    rank = torch.sum(lt | eq, dim=1)
    return rank < m


# --------------------------------------------------------------------------
# baselines
# --------------------------------------------------------------------------
def average(G: Tensor, f: int = 0) -> Tensor:
    """Plain averaging — the fastest but non-byzantine-resilient rule."""
    del f
    return torch.mean(G, dim=0)


def coordinate_median(G: Tensor, f: int = 0) -> Tensor:
    """Coordinate-wise median (the MEDIAN baseline of §V)."""
    del f
    return _median_axis0(G)


def trimmed_mean(G: Tensor, f: int) -> Tensor:
    """Coordinate-wise trimmed mean: drop the f largest and f smallest."""
    n = G.shape[0]
    if n <= 2 * f:
        raise ValueError(f"trimmed_mean needs n > 2f (n={n}, f={f})")
    srt = torch.sort(G, dim=0).values
    return torch.mean(srt[f:n - f], dim=0)


# --------------------------------------------------------------------------
# Krum family
# --------------------------------------------------------------------------
def multi_krum_mask(G: Tensor, f: int, m: Optional[int] = None,
                    dists: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """(selection mask (n,), scores (n,)) of MULTI-KRUM; m defaults to
    the paper's m̃ = n - f - 2."""
    n = G.shape[0]
    if n < 2 * f + 3:
        raise ValueError(f"multi-krum needs n >= 2f+3 (n={n}, f={f})")
    if m is None:
        m = n - f - 2
    if dists is None:
        dists = pairwise_sqdist(G)
    scores = krum_scores(dists, f).detach()
    return _select_smallest_mask(scores, m), scores


def krum(G: Tensor, f: int, dists: Optional[Tensor] = None) -> Tensor:
    """Krum: the single gradient with the smallest score."""
    mask, _ = multi_krum_mask(G, f, m=1, dists=dists)
    w = mask.to(G.dtype)
    return (w @ G) / torch.sum(w)


def multi_krum(G: Tensor, f: int, m: Optional[int] = None,
               dists: Optional[Tensor] = None) -> Tensor:
    """MULTI-KRUM: average of the m best-scored gradients (§III)."""
    mask, _ = multi_krum_mask(G, f, m=m, dists=dists)
    w = mask.float()
    return ((w @ G.float()) / torch.sum(w)).to(G.dtype)


# --------------------------------------------------------------------------
# Bulyan family
# --------------------------------------------------------------------------
def extraction_plan(dists: Tensor, f: int, theta: int,
                    multi: bool = True) -> Tuple[Tensor, Tensor]:
    """θ rounds of (MULTI-)KRUM extraction, in score space only.

    Returns ``(w_ext, w_agr)``, each ``(theta, n)`` row-stochastic fp32:
    ``w_ext[r]`` one-hot on the round-r winner; ``w_agr[r]`` uniform over
    the round-r MULTI-KRUM selection of size m_r = (n-r)-f-2 if ``multi``,
    else the winner's one-hot (classic BULYAN).
    """
    n = dists.shape[0]
    dev = dists.device
    dists = dists.detach()
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    w_ext = torch.zeros((theta, n), dtype=torch.float32, device=dev)
    w_agr = torch.zeros((theta, n), dtype=torch.float32, device=dev)
    for r in range(theta):
        m_r = (n - r) - f - 2
        scores = krum_scores(dists, f, alive=alive, n_neighbors=m_r)
        winner = torch.argmin(scores)
        w_ext[r, winner] = 1.0
        if multi:
            sel = _select_smallest_mask(scores, m_r).float()
            w_agr[r] = sel / torch.clamp(torch.sum(sel), min=1.0)
        else:
            w_agr[r, winner] = 1.0
        alive[winner] = False
    return w_ext, w_agr


def _extraction_rounds(G: Tensor, f: int, theta: int,
                       dists: Optional[Tensor] = None,
                       multi: bool = True) -> Tuple[Tensor, Tensor]:
    dists = pairwise_sqdist(G) if dists is None else dists
    w_ext, w_agr = extraction_plan(dists, f, theta, multi=multi)
    Gf = G.float()
    return w_ext @ Gf, w_agr @ Gf


def bulyan_coordinate_phase(G_ext: Tensor, G_agr: Tensor, beta: int) -> Tensor:
    """BULYAN's coordinate phase (Algorithm 1 lines 21-24): per coordinate,
    the median of ``G_ext`` and the mean of the β entries of ``G_agr``
    closest to it (stable ranks: ties go to the lower row)."""
    med = _median_axis0(G_ext)
    dist = torch.abs(G_agr - med[None]).detach()
    order = torch.argsort(dist, dim=0, stable=True)
    ranks = torch.argsort(order, dim=0)
    sel = ranks < beta
    return torch.sum(torch.where(sel, G_agr, torch.zeros_like(G_agr)),
                     dim=0) / float(beta)


def _bulyan_family(G: Tensor, f: int, *, multi: bool,
                   dists: Optional[Tensor] = None) -> Tensor:
    n = G.shape[0]
    if n < 4 * f + 3:
        raise ValueError(f"bulyan needs n >= 4f+3 (n={n}, f={f})")
    theta = n - 2 * f - 2
    beta = theta - 2 * f
    g_ext, g_agr = _extraction_rounds(G, f, theta, dists=dists, multi=multi)
    return bulyan_coordinate_phase(g_ext, g_agr, beta).to(G.dtype)


def bulyan(G: Tensor, f: int, dists: Optional[Tensor] = None) -> Tensor:
    """Classic BULYAN: iterated Krum extraction + coordinate phase."""
    return _bulyan_family(G, f, multi=False, dists=dists)


def multi_bulyan(G: Tensor, f: int, dists: Optional[Tensor] = None) -> Tensor:
    """MULTI-BULYAN (Algorithm 1): BULYAN over MULTI-KRUM aggregates."""
    return _bulyan_family(G, f, multi=True, dists=dists)
