"""Theoretical quantities from the paper, Lemmas 1-2 and Theorems 1-2
(cf. ``repro.core.theory``), the grouped f-budget arithmetic of the
hierarchical aggregation (``repro_torch.hier``) and the bounded-staleness
budget of the async service (``repro_torch.serve``).

:func:`check_level` is the single n-vs-f resilience gate that
``Aggregator.validate`` — and through it ``RobustConfig.validate`` —
delegates to, and that :func:`split_f_budget` applies at each level of a
grouped aggregation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

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


def max_f(gar: str, n: int) -> int:
    """The largest byzantine budget ``n`` workers admit under ``gar``
    (inverse of :func:`min_workers`; may be negative when even f=0 is
    infeasible)."""
    if gar in ("bulyan", "multi_bulyan"):
        return (n - 3) // 4
    if gar in ("krum", "multi_krum"):
        return (n - 3) // 2
    if gar == "trimmed_mean":
        return (n - 1) // 2
    return n


def check_level(n: int, f: int, *, rule: str, need: Optional[int] = None,
                formula: Optional[str] = None,
                level: Optional[str] = None) -> None:
    """Raise ``ValueError`` when ``n`` workers cannot defend ``f`` traitors
    under ``rule`` (n >= 2f+3 for the Krum family, 4f+3 for Bulyan, 2f+1
    for the trimmed mean).  ``level`` names the hierarchy level in the
    message (``"inner"`` / ``"outer"``)."""
    if f < 0:
        raise ValueError(f"f must be >= 0, got {f}")
    if need is None:
        need = min_workers(rule, f)
    if formula is None:
        formula = MIN_N_FORMULA.get(rule, str(need))
    if n < need:
        where = f" at hierarchy level {level!r}" if level else ""
        raise ValueError(
            f"{rule}{where} requires n >= {formula} "
            f"(n={n}, f={f}, need n >= {need})")


# ==========================================================================
# the grouped (hierarchical) f-budget arithmetic
# ==========================================================================
def group_sizes(n: int, g: int) -> Tuple[int, ...]:
    """Balanced split of ``n`` workers into ``ceil(n/g)`` contiguous groups
    of at most ``g``, sizes differing by at most one (larger first)."""
    if g < 1:
        raise ValueError(f"group size must be >= 1, got g={g}")
    if n < 1:
        raise ValueError(f"need at least one worker, got n={n}")
    n_groups = -(-n // g)
    base, rem = divmod(n, n_groups)
    return tuple(base + 1 if i < rem else base for i in range(n_groups))


@dataclasses.dataclass(frozen=True)
class FBudget:
    """Per-level byzantine budgets of a two-level grouped aggregation.

    ``f_inner`` is what every group defends, ``f_outer`` what the outer
    rule over the ``n_groups`` group aggregates defends.  A group is
    captured only when it holds more than ``f_inner`` traitors, so ``f``
    traitors capture at most ``f // (f_inner + 1)`` groups; the budget
    covers the contract ``f`` when that is at most ``f_outer``.
    """

    n: int
    f: int
    g: int
    group_sizes: Tuple[int, ...]
    f_inner: int
    f_outer: int

    @property
    def n_groups(self) -> int:
        return len(self.group_sizes)

    def capturable_groups(self, f: Optional[int] = None) -> int:
        f = self.f if f is None else f
        if self.n_groups == 1:
            return 0 if f <= self.f_inner else 1
        return f // (self.f_inner + 1)

    def covers(self, f: Optional[int] = None) -> bool:
        """Whether any placement of ``f`` traitors stays defended."""
        return self.capturable_groups(f) <= self.f_outer

    def bounds(self) -> Tuple[Tuple[int, int], ...]:
        """Contiguous (start, stop) worker-row ranges per group."""
        out, start = [], 0
        for s in self.group_sizes:
            out.append((start, start + s))
            start += s
        return tuple(out)


def split_f_budget(n: int, f: int, g: int, *, rule: str = "multi_bulyan",
                   outer_rule: Optional[str] = None,
                   f_inner: Optional[int] = None,
                   f_outer: Optional[int] = None,
                   enforce: bool = True) -> FBudget:
    """Derive and check the per-level f budgets for groups of size ``g``.

    By default ``f_inner`` is the largest budget the smallest group admits
    under ``rule`` (capped at ``f``) and ``f_outer`` the number of groups
    an ``f``-strong adversary can then capture, ``f // (f_inner + 1)``.
    Every level goes through :func:`check_level`, and unless ``enforce``
    is off the budget must cover the contract ``f`` (``enforce=False``
    runs an under-provisioned tree on purpose, to show the capture).  One
    group (g >= n) is the flat rule: ``f_inner = f``, ``f_outer = 0``.
    """
    if f < 0:
        raise ValueError(f"f must be >= 0, got {f}")
    sizes = group_sizes(n, g)
    n_groups, g_min = len(sizes), min(sizes)
    if n_groups == 1:
        fi = f if f_inner is None else f_inner
        check_level(g_min, fi, rule=rule, level="inner")
        budget = FBudget(n=n, f=f, g=g, group_sizes=sizes,
                         f_inner=fi, f_outer=0)
    else:
        fi = min(f, max(0, max_f(rule, g_min))) if f_inner is None \
            else f_inner
        check_level(g_min, fi, rule=rule, level="inner")
        fo = f // (fi + 1) if f_outer is None else f_outer
        if fo > 0 or outer_rule is not None:
            # a robust outer level must meet its own precondition over the
            # n_groups aggregates
            check_level(n_groups, fo, rule=outer_rule or rule,
                        level="outer")
        budget = FBudget(n=n, f=f, g=g, group_sizes=sizes,
                         f_inner=fi, f_outer=fo)
    if enforce and not budget.covers():
        raise ValueError(
            f"hierarchical f budget (f_inner={budget.f_inner}, "
            f"f_outer={budget.f_outer}, groups={budget.n_groups}) does not "
            f"cover contract f={f}: {budget.capturable_groups()} groups "
            f"capturable > f_outer; increase g, decrease f, or pass "
            f"enforce=False to deliberately run past the budget")
    return budget


# ==========================================================================
# the bounded-staleness f-budget arithmetic
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class StalenessBudget:
    """How an async round's stale workers spend the byzantine budget.

    The bounded-asynchrony argument of Chen et al. (arXiv 1705.05491): a
    worker whose buffered gradient is older than the staleness bound
    ``tau`` is indistinguishable from an adversarial one, so every
    *overstale* worker is charged against the contract ``f`` the GAR
    defends.

    * ``f_defended(k)``: byzantine defense left after ``k`` workers went
      overstale, ``max(f - k, 0)``.
    * ``admissible(k)``: whether a round with ``k`` overstale workers is
      still covered by the contract (``k <= f``); past that the plan
      service falls back to the previous round's plan.

    Python arithmetic for config-time checks; ``repro_torch.serve.buffer``
    computes the same quantities in tensors inside the round.
    """

    n: int
    f: int
    tau: int

    def f_defended(self, n_overstale: int) -> int:
        return max(self.f - min(n_overstale, self.f), 0)

    def admissible(self, n_overstale: int) -> bool:
        return n_overstale <= self.f

    def covers(self, n_byz: int, n_overstale: int) -> bool:
        """Whether ``n_byz`` true traitors plus ``n_overstale`` stale rows
        stay within the contract."""
        return n_byz + n_overstale <= self.f


def staleness_budget(n: int, f: int, tau: int, *,
                     rule: str = "multi_bulyan") -> StalenessBudget:
    """Derive and check the staleness budget of an async service: ``n``
    must defend the contract ``f`` under ``rule`` (:func:`check_level`)
    before any of it can be spent on staleness."""
    if tau < 0:
        raise ValueError(f"staleness bound tau must be >= 0, got {tau}")
    check_level(n, f, rule=rule)
    return StalenessBudget(n=n, f=f, tau=tau)
