"""Bounded-staleness async gradient buffer (cf. ``repro.serve.buffer``).

The buffer is the asynchrony boundary of the plan/apply service split:
workers deliver gradients whenever they finish, the round deadline fires
regardless, and a worker that missed it keeps its *previous* row in the
buffered stack, admitted into the next plan instead of blocking this one.
Every slot carries an int32 age (rounds since last delivery); rows older
than the staleness bound ``tau`` are *overstale* and are charged against
the contract ``f`` (``core.theory.StalenessBudget``, after Chen et al.,
arXiv 1705.05491).

Admission is a masked ``torch.where`` per leaf, out of place: a
:class:`BufferState` the caller still holds keeps its tensors.  Ages are
one (n,) int32 tensor on the gradients' device, and the staleness
arithmetic and the degradation to the previous round's plan
(``core.api.select_plan``) stay on the device: no round reads a value
back to the host.  Under ``use_kernels`` a round's statistics are one K1
launch and its bulyan apply one K2 launch per leaf of the buffered stack.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.core import api
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor
Tree = Any


@dataclasses.dataclass(frozen=True)
class BufferState:
    """Per-round state of the async aggregation buffer.

    * ``grads``: stacked tree, every leaf ``(n, ...)``: each worker's most
      recently delivered gradient (its buffer slot);
    * ``age``: (n,) int32 tensor, rounds since the slot was last refreshed
      (0 = delivered this round);
    * ``plan``: the :class:`~repro_torch.core.api.AggPlan` the service
      applied last round (the degradation target of an inadmissible one).
    """

    grads: Tree
    age: Tensor
    plan: api.AggPlan


def init_buffer_state(grads_like: Tree, backend: api.AggregatorBackend,
                      *, tau: int) -> BufferState:
    """Empty buffer: zero slots, every worker overstale until it delivers.

    Ages start at ``tau + 1``, so a worker that never delivered counts
    against the budget from round one.  The seed plan is the backend's
    plan on all-zero distances (scalar work, no kernel): a plan of the
    same kind and shapes as every later one, so the degradation never
    changes a shape.
    """
    leaves = tree_leaves(grads_like)
    if not leaves:
        raise ValueError("empty gradient pytree")
    n, dev = leaves[0].shape[0], leaves[0].device
    grads = tree_map(torch.zeros_like, grads_like)
    age = torch.full((n,), tau + 1, dtype=torch.int32, device=dev)
    needs = backend.aggregator.needs_dists or backend.needs_dists
    stats = api.AggStats(
        n=n, f=backend.f,
        dists=torch.zeros((n, n), dtype=torch.float32, device=dev)
        if needs else None)
    return BufferState(grads=grads, age=age, plan=backend.plan(stats))


def _mask(fresh, device) -> Tensor:
    """The (n,) bool delivery mask on ``device`` (a list, an array or a
    tensor)."""
    return torch.as_tensor(fresh, dtype=torch.bool).to(device)


def admit(state: BufferState, grads: Tree, fresh) -> BufferState:
    """One round of admissions: the slots of workers whose gradient arrived
    by the deadline (``fresh``, (n,) bool) take it, the rest age by one.
    Out of place: ``state`` keeps its tensors.

    Late arrivals are not lost: the caller feeds them as ``fresh`` next
    round, so a late gradient enters the *next* plan.
    """
    fresh = _mask(fresh, state.age.device)

    def take(slot, new):
        m = fresh.reshape((-1,) + (1,) * (new.dim() - 1))
        return torch.where(m, new.to(slot.dtype), slot)

    return dataclasses.replace(
        state,
        grads=tree_map(take, state.grads, grads),
        age=torch.where(fresh, 0, state.age + 1).to(torch.int32))


def staleness_info(age: Tensor, *, tau: int, f: int) -> Dict[str, Tensor]:
    """The tensor mirror of :class:`~repro_torch.core.theory.
    StalenessBudget`:

    * ``overstale``: (n,) bool, age > tau;
    * ``n_overstale``: int32 count;
    * ``f_defended``: ``max(f - n_overstale, 0)``, the byzantine defense
      left after the staleness haircut (never above the contract f);
    * ``admissible``: bool, ``n_overstale <= f``; past that the round's
      plan is not covered by the contract and is degraded.
    """
    overstale = age > tau
    n_over = torch.sum(overstale).to(torch.int32)
    f_arr = torch.tensor(f, dtype=torch.int32, device=age.device)
    return {
        "overstale": overstale,
        "n_overstale": n_over,
        "f_defended": torch.clamp(f_arr - torch.minimum(n_over, f_arr),
                                  min=0),
        "admissible": n_over <= f_arr,
    }


def buffered_round(state: BufferState, backend: api.AggregatorBackend,
                   grads: Tree, fresh, *, tau: int
                   ) -> Tuple[Tree, BufferState, Dict[str, Any]]:
    """Admit → plan → degrade-if-inadmissible → apply: one async round.

    The plan is always computed at the contract ``f`` over the whole
    buffered stack (``plan_stats``: K1 per leaf); when the round is
    inadmissible the *previous* plan is selected instead
    (:func:`~repro_torch.core.api.select_plan`) and applied to the current
    buffer (K2 per leaf): serving continues on the last covered selection.

    Returns ``(aggregate, new_state, info)``, ``info`` the staleness
    telemetry (:func:`staleness_info` plus ``admitted``, the delivery
    mask, ``plan_reused``, the round's :class:`AggStats` and ``age``).
    """
    fresh = _mask(fresh, state.age.device)
    state = admit(state, grads, fresh)
    info = staleness_info(state.age, tau=tau, f=backend.f)
    plan, stats = backend.plan_stats(state.grads)
    plan = api.select_plan(info["admissible"], plan, state.plan)
    agg = backend.apply(plan, state.grads)
    info = dict(info, admitted=fresh,
                plan_reused=torch.logical_not(info["admissible"]),
                stats=stats, age=state.age)
    return agg, dataclasses.replace(state, plan=plan), info
