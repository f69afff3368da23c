"""Theoretical quantities from the paper the slice uses (cf. ``repro.core.theory``).

:func:`check_level` is the single n-vs-f resilience gate that
``Aggregator.validate`` — and through it ``RobustConfig.validate`` —
delegates to.
"""
from __future__ import annotations

from typing import Optional

import torch


def multi_bulyan_slowdown(n: int, f: int) -> float:
    """Theorem 2(iii): byzantine-free slowdown of MULTI-BULYAN vs averaging."""
    return (n - 2 * f - 2) / n


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
