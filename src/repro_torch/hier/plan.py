"""Hierarchical aggregation plans: group assignment and per-level plans
(cf. ``repro.hier.plan``).

The flat plan's statistics are an (n, n) matrix.  The grouped scheme
robust-aggregates within ``ceil(n/g)`` groups of at most ``g`` workers,
then robust-aggregates the group outputs: ceil(n/g) matrices of at most
(g, g) and one (n_groups, n_groups), with per-level byzantine budgets
derived and checked by ``core.theory.split_f_budget``.

* :class:`GroupConfig` — the user's knob: group size ``g``, the inner rule,
  optionally an explicit outer rule and per-level f overrides.
  ``hier=GroupConfig(g=7)`` on either trainer turns the feature on.
* :class:`HierPlan` — the computed plan: the group bounds, the per-level
  budgets and one :class:`~repro_torch.core.api.AggPlan` per group plus
  the outer plan, with the flat plan's telemetry surface
  (``selection_weights`` / ``diagnostics``) and per-group extras.

Groups are contiguous, balanced slices of the worker axis
(``core.theory.group_sizes``), larger groups first.  The attacks hold the
first rows, so all traitors fall in group 0 by default: the poisoned
subtree is the default adversarial placement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import theory
from repro_torch.core.api import AggPlan, AggStats

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GroupConfig:
    """Configuration of the two-level grouped aggregation.

    ``g`` is the largest group size; ``rule`` the inner (within-group) GAR
    of the registry.  ``outer_rule`` defaults to ``rule`` when the derived
    outer budget ``f_outer`` is positive, and to ``average`` when no whole
    group can be captured (the inner level already paid for robustness).
    ``f_inner`` / ``f_outer`` override the derived budgets;
    ``enforce_budget=False`` permits budgets that do not cover the
    contract f (every level is still checked by
    ``core.theory.check_level``).
    """

    g: int
    rule: str = "multi_bulyan"
    outer_rule: Optional[str] = None
    f_inner: Optional[int] = None
    f_outer: Optional[int] = None
    enforce_budget: bool = True

    @classmethod
    def from_spec(cls, spec: str, *, rule: str = "multi_bulyan"
                  ) -> "GroupConfig":
        """Parse the CLI grammar ``"g=64[,rule=...,f_inner=...,...]"``:
        comma-separated ``k=v`` as the attack and codec specs.  ``rule``
        is the default inner rule (the launcher passes its ``--gar``);
        ``enforce=0`` maps to ``enforce_budget=False``; a bare integer is
        shorthand for ``g=``."""
        kw: Dict[str, object] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                k, v = "g", part
            else:
                k, v = (s.strip() for s in part.split("=", 1))
            if k == "enforce":
                kw["enforce_budget"] = v not in ("0", "false", "False")
            elif k in ("g", "f_inner", "f_outer"):
                kw[k] = int(v)
            elif k in ("rule", "outer_rule"):
                kw[k] = v
            else:
                raise ValueError(
                    f"unknown --hier key {k!r} in {spec!r}; expected "
                    "g/rule/outer_rule/f_inner/f_outer/enforce")
        if "g" not in kw:
            raise ValueError(f"--hier spec {spec!r} needs g=<group size>")
        kw.setdefault("rule", rule)
        return cls(**kw)  # type: ignore[arg-type]

    def budget(self, n: int, f: int) -> theory.FBudget:
        """The checked per-level f budget for an (n, f) contract."""
        return theory.split_f_budget(
            n, f, self.g, rule=self.rule, outer_rule=self.outer_rule,
            f_inner=self.f_inner, f_outer=self.f_outer,
            enforce=self.enforce_budget)

    def resolve_outer_rule(self, budget: theory.FBudget) -> str:
        if self.outer_rule is not None:
            return self.outer_rule
        return self.rule if budget.f_outer > 0 else "average"


@dataclasses.dataclass(frozen=True)
class HierPlan:
    """Output of the hierarchical plan phase.

    ``inner`` holds one flat :class:`AggPlan` per group, in worker-row
    order over the contiguous ``bounds``; ``outer`` the plan over the group
    aggregates, or ``None`` for one group (g >= n), whose apply is the flat
    path bit for bit.
    """

    inner: Tuple[AggPlan, ...]
    outer: Optional[AggPlan]
    n: int
    f: int
    g: int
    bounds: Tuple[Tuple[int, int], ...]
    f_inner: int
    f_outer: int
    rule: str
    outer_rule: str

    @classmethod
    def build(cls, budget: theory.FBudget, cfg: GroupConfig,
              inner: Tuple[AggPlan, ...], outer: Optional[AggPlan]
              ) -> "HierPlan":
        """The plan of ``budget``'s groups: without an outer plan (one
        group) the flat rule, f_outer = 0 and the inner rule outside too;
        otherwise ``budget.f_outer`` and ``cfg.resolve_outer_rule``."""
        flat = outer is None
        return cls(inner=tuple(inner), outer=outer, n=budget.n, f=budget.f,
                   g=cfg.g, bounds=budget.bounds(), f_inner=budget.f_inner,
                   f_outer=0 if flat else budget.f_outer, rule=cfg.rule,
                   outer_rule=cfg.rule if flat else
                   cfg.resolve_outer_rule(budget))

    @property
    def n_groups(self) -> int:
        return len(self.inner)

    def group_selection(self) -> Tensor:
        """Convex (n_groups,) selection mass over the group aggregates."""
        if self.outer is None:
            return torch.ones((1,), dtype=torch.float32,
                              device=self.inner[0].selection_weights().device)
        return self.outer.selection_weights()

    def selection_weights(self) -> Tensor:
        """Per-worker selection mass through both levels, a convex (n,)
        fp32 vector: worker i's mass is its group's outer mass times its
        inner mass within the group.  Adaptive attacks consume it as they
        consume the flat plan's."""
        gsel = self.group_selection()
        parts = [gsel[k] * p.selection_weights().to(gsel.device)
                 for k, p in enumerate(self.inner)]
        return torch.cat(parts).float()

    def diagnostics(self, inner_stats: Optional[Tuple[AggStats, ...]] = None
                    ) -> Dict[str, Tensor]:
        """The flat plan's diagnostics plus the per-group layer:
        ``selection`` (n,), ``byz_mass``, ``group_selection`` (n_groups,)
        and, when every group's statistics carry distances,
        ``score_spectrum`` (n,), ``score_gap`` and ``mean_dist`` from the
        per-group Krum scores."""
        sel = self.selection_weights()
        byz = torch.sum(sel[: self.f]) if self.f else \
            torch.zeros((), dtype=torch.float32, device=sel.device)
        out: Dict[str, Tensor] = {"selection": sel, "byz_mass": byz,
                                  "group_selection": self.group_selection()}
        if inner_stats is not None and \
                all(st.dists is not None for st in inner_stats):
            per = [p.diagnostics(st)
                   for p, st in zip(self.inner, inner_stats)]
            out["score_spectrum"] = torch.sort(torch.cat(
                [d["score_spectrum"] for d in per])).values
            out["score_gap"] = torch.min(
                torch.stack([d["score_gap"] for d in per]))
            out["mean_dist"] = torch.mean(
                torch.stack([d["mean_dist"] for d in per]))
        return out
