"""Theoretical quantities from the paper, Lemmas 1-2 and Theorems 1-2
(cf. ``repro.core.theory``).

:func:`check_level` is the single n-vs-f resilience gate that
``Aggregator.validate`` — and through it ``RobustConfig.validate`` —
delegates to.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def eta(n: int, f: int, m: Optional[int] = None) -> float:
    """η(n, f) from Lemma 1.

    η(n,f) = sqrt( 2 ( n - f + (f·m + f²·(m+1)) / (n - 2f - 2) ) ),
    with m = n - f - 2 (the MULTI-KRUM selection size) by default.
    """
    if m is None:
        m = n - f - 2
    if n - 2 * f - 2 <= 0:
        raise ValueError(f"need n > 2f+2 (n={n}, f={f})")
    return math.sqrt(2.0 * (n - f + (f * m + f * f * (m + 1))
                            / (n - 2 * f - 2)))


def sin_alpha(n: int, f: int, d: int, sigma: float, g_norm: float) -> float:
    """sin α = η(n,f)·√d·σ / ||g|| (Lemma 1).  Must be < 1 for resilience."""
    return eta(n, f) * math.sqrt(d) * sigma / g_norm


def variance_condition(n: int, f: int, d: int, sigma: float,
                       g_norm: float) -> bool:
    """The paper's no-free-lunch requirement: η(n,f)·√d·σ < ||g||."""
    return sin_alpha(n, f, d, sigma, g_norm) < 1.0


def multi_krum_slowdown(n: int, f: int) -> float:
    """Theorem 1(ii): byzantine-free slowdown of MULTI-KRUM vs averaging."""
    return (n - f - 2) / n


def multi_bulyan_slowdown(n: int, f: int) -> float:
    """Theorem 2(iii): byzantine-free slowdown of MULTI-BULYAN vs averaging."""
    return (n - 2 * f - 2) / n


def strong_leeway_bound(d: int) -> float:
    """Definition 2: per-coordinate leeway O(1/√d) for strong resilience."""
    return 1.0 / math.sqrt(d)


def empirical_sigma(G: torch.Tensor) -> float:
    """Per-coordinate std σ of an (n, d) stack of correct gradients
    (E||G-g||² = dσ²), computed in the stack's dtype."""
    g = torch.mean(G, dim=0, keepdim=True)
    d = G.shape[1]
    return float(torch.sqrt(torch.mean(torch.sum((G - g) ** 2, dim=1)) / d))


def cone_cosine(agg: torch.Tensor, g: torch.Tensor) -> float:
    """cos of the angle between the aggregate and the true gradient."""
    a = agg.double().reshape(-1)
    b = g.double().reshape(-1)
    num = float(torch.dot(a, b))
    den = float(torch.linalg.norm(a) * torch.linalg.norm(b)) + 1e-30
    return num / den


def min_workers(gar: str, f: int) -> int:
    if gar in ("bulyan", "multi_bulyan"):
        return 4 * f + 3
    if gar in ("krum", "multi_krum"):
        return 2 * f + 3
    if gar == "trimmed_mean":
        return 2 * f + 1
    return 1


MIN_N_FORMULA = {
    "bulyan": "4f+3", "multi_bulyan": "4f+3",
    "krum": "2f+3", "multi_krum": "2f+3",
    "trimmed_mean": "2f+1",
}


def check_level(n: int, f: int, *, rule: str, need: Optional[int] = None,
                formula: Optional[str] = None) -> None:
    """Raise ``ValueError`` when ``n`` workers cannot defend ``f`` traitors
    under ``rule`` (n >= 2f+3 for the Krum family, 4f+3 for Bulyan, 2f+1
    for the trimmed mean)."""
    if f < 0:
        raise ValueError(f"f must be >= 0, got {f}")
    if need is None:
        need = min_workers(rule, f)
    if formula is None:
        formula = MIN_N_FORMULA.get(rule, str(need))
    if n < need:
        raise ValueError(
            f"{rule} requires n >= {formula} "
            f"(n={n}, f={f}, need n >= {need})")
