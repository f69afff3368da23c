"""The async plan/apply aggregation service (cf. ``repro.serve.service``).

:class:`AsyncAggService` bundles the shared
:class:`~repro_torch.core.api.AggregatorBackend` with a staleness bound:
the *plan service* runs on the buffered statistics (K1 per leaf, then the
O(n²) plan), the *apply service* applies the covered plan to the buffered
gradient stack (K2 per leaf).  This module adds the bounded-staleness
round (``serve.buffer``) on top, and the trainer step that threads its
state through ``TrainerState.bstate``.

The service loop is collective-free: cross-worker data moves through the
buffer (admission is a masked ``where``), never through a collective.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, RobustConfig
from repro_torch.core import api
from repro_torch.core import attacks as ATK
from repro_torch.core import theory
from repro_torch.dist.trainer import (TrainerState, _honest_mean_dev,
                                      as_trainer_state, inject_byzantine,
                                      per_worker_grads)
from repro_torch.optim.optimizers import Optimizer
from repro_torch.serve import buffer as BUF
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor
Tree = Any


@dataclasses.dataclass(frozen=True)
class AsyncAggService:
    """Plan service + apply service over a bounded-staleness buffer.

    ``backend`` is the one shared aggregation pipeline; ``tau`` the
    staleness bound (a slot older than ``tau`` rounds is overstale and
    spends contract-f budget: ``core.theory.staleness_budget``).
    """

    backend: api.AggregatorBackend
    tau: int

    def __post_init__(self):
        # config-time gate: n is unknown here, but tau must be sane
        if self.tau < 0:
            raise ValueError(f"staleness bound tau must be >= 0, "
                             f"got {self.tau}")

    def budget(self, n: int) -> theory.StalenessBudget:
        return theory.staleness_budget(n, self.backend.f, self.tau,
                                       rule=self.backend.gar)

    def init_state(self, grads_like: Tree) -> BUF.BufferState:
        return BUF.init_buffer_state(grads_like, self.backend, tau=self.tau)

    # ------------------------------------------------------------ services
    def plan(self, state: BUF.BufferState
             ) -> Tuple[api.AggPlan, Dict[str, Any]]:
        """The plan service on the current buffer (no admission)."""
        info = BUF.staleness_info(state.age, tau=self.tau,
                                  f=self.backend.f)
        plan, stats = self.backend.plan_stats(state.grads)
        plan = api.select_plan(info["admissible"], plan, state.plan)
        return plan, dict(info, stats=stats)

    def apply(self, plan: api.AggPlan, state: BUF.BufferState) -> Tree:
        """The apply service: the covered plan over the buffered stack."""
        return self.backend.apply(plan, state.grads)

    def round(self, state: BUF.BufferState, grads: Tree, fresh
              ) -> Tuple[Tree, BUF.BufferState, Dict[str, Any]]:
        """One full async round: admit → plan → apply."""
        return BUF.buffered_round(state, self.backend, grads, fresh,
                                  tau=self.tau)


def with_buffer(tstate: TrainerState, service: AsyncAggService,
                params: Tree, n_workers: int) -> TrainerState:
    """Seed the ``bstate`` slot of a :class:`TrainerState` for the async
    trainer (the stacked gradient shapes mirror the parameters)."""
    stacked = tree_map(lambda p: p.new_zeros((n_workers,) + tuple(p.shape)),
                       params)
    return dataclasses.replace(tstate, bstate=service.init_state(stacked))


def make_async_train_step(cfg: ArchConfig, rcfg: RobustConfig,
                          opt: Optimizer, lr_fn, *, tau: int,
                          window: int = 0, chunk_q: int = 1024,
                          attack: str = "none",
                          attack_f: Optional[int] = None,
                          telemetry: bool = False):
    """Build the bounded-staleness async trainer step.

    Signature ``(params, state, batch, seed, fresh) -> (params, state,
    metrics)``: ``fresh`` is the (n,) bool delivery mask of the round
    (True = the worker's gradient arrived by the deadline).  Workers that
    missed keep their buffered slot; slots older than ``tau`` rounds are
    overstale and haircut the byzantine budget
    (``core.theory.StalenessBudget``).  The buffer lives in
    ``TrainerState.bstate``: seed it with :func:`with_buffer`.

    The per-worker gradients come from ``dist.trainer.per_worker_grads``
    and the attack overwrites the first ``attack_f`` rows
    (``inject_byzantine``, seeded by ``seed``), as in the synchronous
    step; on a round where every worker is fresh the step is the
    synchronous step.  Scope, as the JAX package's: attacks and telemetry
    compose with the async path; transforms, codecs, hierarchical
    aggregation and the mesh do not.  With ``telemetry`` the metrics gain
    the plan's diagnostics (``selection``, ``byz_mass``, scores),
    ``honest_dev`` against the buffered rows, ``admitted``, ``overstale``,
    ``staleness_age``, ``n_overstale``, ``f_defended`` and
    ``plan_reused`` (fp32 tensors).
    """
    rcfg.validate()
    backend = api.AggregatorBackend.for_config(rcfg, needs_dists=telemetry)
    service = AsyncAggService(backend=backend, tau=tau)
    theory.staleness_budget(rcfg.n_workers, rcfg.f, tau, rule=rcfg.gar)
    f_eff = rcfg.f if attack_f is None else attack_f
    if not 0 <= f_eff <= rcfg.f:
        raise ValueError(
            f"attack_f must be in [0, f] (attack_f={f_eff}, f={rcfg.f})")
    attack_fn = ATK.get_attack(attack)

    def step(params, state, batch, seed, fresh):
        state = as_trainer_state(state)
        if state.bstate is None:
            raise ValueError("async trainer needs TrainerState.bstate; "
                             "seed it with serve.service.with_buffer()")
        losses, grads = per_worker_grads(params, cfg, batch, window=window,
                                         chunk_q=chunk_q)
        grads = inject_byzantine(grads, f_eff, attack_fn, seed)
        with torch.no_grad():
            agg, bstate, info = service.round(state.bstate, grads, fresh)
            del grads
            lr = lr_fn(state.opt.step)
            new_params, new_opt = opt.update(agg, state.opt, params, lr)
            gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                   for g in tree_leaves(agg)))
            metrics = {"loss": torch.mean(losses),
                       "loss_per_worker": losses,
                       "lr": lr,
                       "agg_grad_norm": gnorm}
            if telemetry:
                diag = bstate.plan.diagnostics(info["stats"])
                diag["byz_mass"] = torch.sum(diag["selection"][:f_eff])
                # deviation from the honest rows of the *buffered* stack,
                # the values the aggregate was computed from
                diag["honest_dev"] = _honest_mean_dev(agg, bstate.grads,
                                                      f_eff)
                for key, src in (("admitted", "admitted"),
                                 ("overstale", "overstale"),
                                 ("staleness_age", "age"),
                                 ("n_overstale", "n_overstale"),
                                 ("f_defended", "f_defended"),
                                 ("plan_reused", "plan_reused")):
                    diag[key] = info[src].float()
                metrics["telemetry"] = diag
        new_state = dataclasses.replace(state, opt=new_opt, bstate=bstate)
        return tree_map(lambda p: p.detach(), new_params), new_state, metrics

    return step
