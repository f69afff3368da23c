"""Declarative campaign scenarios (cf. ``repro.sim.scenario``).

A :class:`Scenario` is a frozen, fully serialisable description of one
byzantine training campaign: the architecture, the robust configuration,
the attack *schedule* (a sequence of :class:`AttackPhase` — per-phase attack
spec, effective f, worker churn), the data heterogeneity (Dirichlet non-IID
mixture) and the trainer substrate.  ``repro_torch.sim.engine.run_campaign``
executes it; nothing in here imports torch at module level — scenarios
are pure data, cheap to sweep over and to embed in campaign reports.
The rules and their messages are the JAX package's, checked against the
port's own attacks, codecs, transforms and ``hier.GroupConfig``.

Attack specs use the ``core.attacks`` spec-string grammar
(``"little_is_enough:z=2.0"``, ``"adaptive_lie:up=1.2"``); transform specs
use the same grammar over ``core.api.TRANSFORMS``
(``"worker_momentum:beta=0.9"``, ``"clip:max_norm=1.0"``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ArchConfig

# the tiny default campaign architecture (~1.5M params — minutes on CPU)
TINY = ArchConfig(name="sim-tiny", family="dense", n_layers=2, d_model=128,
                  n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=512)


@dataclasses.dataclass(frozen=True)
class AttackPhase:
    """One contiguous segment of a campaign with a fixed threat model.

    ``attack``  — attack spec string (``core.attacks.get_attack`` grammar;
                  adaptive specs allowed on the stacked trainer).
    ``f``       — how many workers the adversary controls *this phase*
                  (None -> the scenario's contract ``f``; must not exceed
                  it — the rule always defends against the contract).
    ``stale_workers`` — honest-worker ids whose data is frozen to the
                  phase's first batch (straggler/churn model: a stalled
                  worker keeps resubmitting gradients of old data; the
                  trainer contract stays untouched because churn lives
                  entirely in the data fed to the step).
    """

    steps: int
    attack: str = "none"
    f: Optional[int] = None
    stale_workers: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.steps <= 0:
            raise ValueError(f"phase steps must be positive, got {self.steps}")


@dataclasses.dataclass(frozen=True)
class AttackSchedule:
    """An ordered tuple of phases; the campaign runs them back to back."""

    phases: Tuple[AttackPhase, ...]

    def __post_init__(self):
        if not self.phases:
            raise ValueError("schedule needs at least one phase")

    @property
    def total_steps(self) -> int:
        return sum(p.steps for p in self.phases)

    def bounds(self) -> Tuple[Tuple[int, int], ...]:
        """Per-phase (start, stop) global step ranges."""
        out, start = [], 0
        for p in self.phases:
            out.append((start, start + p.steps))
            start += p.steps
        return tuple(out)

    def describe(self) -> str:
        return " -> ".join(f"{p.attack}@{p.steps}" for p in self.phases)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Worker data assignment.

    ``noniid_alpha = 0`` (default) keeps the i.i.d. single-automaton stream;
    ``> 0`` assigns each worker a Dirichlet(α) mixture over ``n_domains``
    distinct bigram automata (``data.synthetic.make_noniid_lm_batch``).
    """

    noniid_alpha: float = 0.0
    n_domains: int = 4

    def __post_init__(self):
        if self.noniid_alpha < 0:
            raise ValueError(f"noniid_alpha must be >= 0, got "
                             f"{self.noniid_alpha}")
        if self.noniid_alpha > 0 and self.n_domains < 2:
            raise ValueError("non-IID assignment needs n_domains >= 2")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One campaign: who aggregates, who attacks when, on what data."""

    name: str
    schedule: AttackSchedule
    n_workers: int = 11
    f: int = 2
    gar: str = "multi_bulyan"
    transforms: Tuple[str, ...] = ()          # transform spec strings
    codec: Optional[str] = None               # wire codec (repro_torch.comm)
    trainer: str = "stacked"                  # stacked|stream_block|stream_global
    # the port's RobustConfig.use_kernels (the CUDA kernels on a card,
    # their plain versions on the CPU); reports name it use_pallas, as
    # the JAX package's do
    use_kernels: bool = True
    arch: ArchConfig = TINY
    data: DataConfig = DataConfig()
    per_worker_batch: int = 2
    seq: int = 64
    lr: float = 0.05
    momentum: float = 0.9
    seed: int = 0
    suspicion_ema: float = 0.9                # telemetry EMA decay
    # hierarchical (grouped) aggregation — repro_torch.hier.
    # hier_g=0 keeps the flat path; > 0 groups workers by contiguous rows
    # (so a phase with f >= hier_g's inner budget concentrated in rows
    # 0..f-1 is the poisoned-subtree campaign).  hier_f_inner/hier_f_outer
    # override the derived per-level budgets and hier_enforce=False admits
    # budgets that do not cover the contract f — the deliberately
    # under-provisioned capture demonstrations.
    hier_g: int = 0
    hier_rule: Optional[str] = None           # default: the scenario gar
    hier_outer_rule: Optional[str] = None
    hier_f_inner: Optional[int] = None
    hier_f_outer: Optional[int] = None
    hier_enforce: bool = True
    # async bounded-staleness aggregation — repro_torch.serve.
    # async_tau=0 keeps the synchronous lockstep path; > 0 replays every
    # phase through the real gradient buffer: each phase's stale_workers
    # miss the round deadline and deliver only every stale_period rounds,
    # slots older than async_tau rounds are overstale and haircut the
    # byzantine budget (core.theory.StalenessBudget).
    async_tau: int = 0
    stale_period: int = 4

    def __post_init__(self):
        if self.trainer not in ("stacked", "stream_block", "stream_global"):
            raise ValueError(f"unknown trainer {self.trainer!r}")
        if self.transforms and self.trainer != "stacked":
            raise ValueError(
                "pre-aggregation transforms need trainer='stacked' "
                "(the streaming trainers never hold the full stack)")
        for p in self.schedule.phases:
            f_eff = self.f if p.f is None else p.f
            if not 0 <= f_eff <= self.f:
                raise ValueError(
                    f"phase {p.attack!r}: effective f={f_eff} outside "
                    f"[0, contract f={self.f}]")
            bad = [w for w in p.stale_workers
                   if not 0 <= w < self.n_workers]
            if bad:
                raise ValueError(f"stale_workers out of range: {bad}")
        # fail on malformed specs at scenario build time, not mid-campaign
        from repro_torch.core import attacks as ATK
        for p in self.schedule.phases:
            name, _ = ATK.parse_spec(p.attack)
            if name not in ATK.ATTACKS and name not in ATK.ADAPTIVE \
                    and name not in ATK.WIRE_ATTACKS:
                raise ValueError(
                    f"unknown attack {name!r}; available: "
                    f"{sorted(ATK.ATTACKS)} + {sorted(ATK.ADAPTIVE)} + "
                    f"wire: {sorted(ATK.WIRE_ATTACKS)}")
            if name in ATK.ADAPTIVE and self.trainer != "stacked":
                raise ValueError(
                    f"adaptive attack {name!r} needs trainer='stacked'")
            if name in ATK.WIRE_ATTACKS and self.codec is None:
                raise ValueError(
                    f"wire attack {name!r} needs a codec= wire to attack")
        if self.codec is not None:
            from repro_torch.comm import get_codec
            c = get_codec(self.codec)   # validates the spec eagerly
            if c.stateful and self.trainer != "stacked":
                raise ValueError(
                    "error-feedback codecs (ef=1) need trainer='stacked'")
            if c.stateful and self.hier_g > 0:
                raise ValueError(
                    "hier_g > 0 does not support error-feedback codecs "
                    "(no residual slot at the leaders→server hop)")
        if self.hier_g < 0:
            raise ValueError(f"hier_g must be >= 0, got {self.hier_g}")
        if self.async_tau < 0:
            raise ValueError(
                f"async_tau must be >= 0, got {self.async_tau}")
        if self.async_tau > 0:
            if self.stale_period < 1:
                raise ValueError(
                    f"stale_period must be >= 1, got {self.stale_period}")
            if self.trainer != "stacked":
                raise ValueError(
                    "async bounded-staleness aggregation needs "
                    "trainer='stacked'")
            if self.transforms or self.codec is not None or self.hier_g > 0:
                raise ValueError(
                    "async_tau > 0 does not compose with transforms, "
                    "codecs or hierarchical aggregation yet (the v1 "
                    "service scope — DESIGN.md §13)")
            for p in self.schedule.phases:
                name, _ = ATK.parse_spec(p.attack)
                if name in ATK.ADAPTIVE:
                    raise ValueError(
                        f"adaptive attack {name!r} is not supported on "
                        f"the async service path")
        if self.hier_g > 0:
            # fail on an infeasible per-level budget at scenario build
            # time; split_f_budget raises with the offending level named
            self.hier_config().budget(self.n_workers, self.f)

    def phase_f(self, phase: AttackPhase) -> int:
        return self.f if phase.f is None else phase.f

    def hier_config(self):
        """The ``repro_torch.hier.GroupConfig`` this scenario asks for (or
        None)."""
        if self.hier_g <= 0:
            return None
        from repro_torch.hier import GroupConfig
        return GroupConfig(g=self.hier_g,
                           rule=self.hier_rule or self.gar,
                           outer_rule=self.hier_outer_rule,
                           f_inner=self.hier_f_inner,
                           f_outer=self.hier_f_outer,
                           enforce_budget=self.hier_enforce)

    def build_transforms(self):
        """Resolve transform spec strings into Transform instances."""
        from repro_torch.core import api
        from repro_torch.core.attacks import parse_spec
        out = []
        for spec in self.transforms:
            name, kwargs = parse_spec(spec)
            try:
                cls = api.TRANSFORMS[name]
            except KeyError:
                raise ValueError(
                    f"unknown transform {name!r}; available: "
                    f"{sorted(api.TRANSFORMS)}") from None
            out.append(cls(**kwargs))
        return tuple(out)

    def to_json(self) -> Dict[str, Any]:
        """Report-embeddable plain-dict form (arch collapsed to its name)."""
        return {
            "name": self.name,
            "n_workers": self.n_workers,
            "f": self.f,
            "gar": self.gar,
            "transforms": list(self.transforms),
            "codec": self.codec,
            "trainer": self.trainer,
            "use_pallas": self.use_kernels,
            "arch": self.arch.name,
            "data": dataclasses.asdict(self.data),
            "per_worker_batch": self.per_worker_batch,
            "seq": self.seq,
            "lr": self.lr,
            "momentum": self.momentum,
            "seed": self.seed,
            "phases": [
                {"steps": p.steps, "attack": p.attack,
                 "f": self.phase_f(p), "stale_workers": list(p.stale_workers)}
                for p in self.schedule.phases
            ],
            **({"async": {"tau": self.async_tau,
                          "stale_period": self.stale_period}}
               if self.async_tau > 0 else {}),
            **({"hier": {"g": self.hier_g,
                         "rule": self.hier_rule or self.gar,
                         "outer_rule": self.hier_outer_rule,
                         "f_inner": self.hier_f_inner,
                         "f_outer": self.hier_f_outer,
                         "enforce": self.hier_enforce}}
               if self.hier_g > 0 else {}),
        }


def switch_scenario(gar: str = "multi_bulyan", *, pre: int = 20,
                    post: int = 20, attack: str = "little_is_enough:z=4.0",
                    **kw) -> Scenario:
    """The canonical mid-run switch campaign: no_attack -> ``attack``.

    This is the acceptance scenario: the robust rule's post-switch
    honest-mean deviation must stay bounded with ≈ 0 byzantine selection,
    while plain averaging is dragged away by the same schedule.
    """
    sched = AttackSchedule((AttackPhase(steps=pre, attack="none"),
                            AttackPhase(steps=post, attack=attack)))
    return Scenario(name=f"switch-{gar}", schedule=sched, gar=gar, **kw)
