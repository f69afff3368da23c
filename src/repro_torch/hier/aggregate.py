"""Two-level hierarchical aggregation (cf. ``repro.hier.aggregate``).

:func:`hier_aggregate_tree` is the grouped counterpart of
``core.api.aggregate_tree``: per group, stats → plan → apply on the
group's rows, then the same three phases once more over the
``(n_groups, ...)`` stack of group aggregates.  Each level is the existing
machinery — the registry rules, the kernels, the ``repro_torch.comm``
codecs — composed:

* the statistics never form an (n, n) matrix, only ceil(n/g) matrices of
  at most (g, g) and one (n_groups, n_groups);
* a group's operand is a row view of the stack (``x[s:e]`` of a
  contiguous ``(n, ...)`` leaf is contiguous), never a copy, so under
  ``use_kernels`` K1 and K2 (or K3 under ``coord_chunk`` / ``fused=False``)
  read each group's rows in place; a wire container is cut with
  ``comm.codecs.slice_workers``, whose payload rows K5 reads;
* with ``codec`` the group aggregates are re-encoded for the
  leaders→server hop (its exact bytes in ``info``) and decoded before the
  outer level, so the aggregate carries that hop's quantization.

One group (g >= n) has no outer level: stats, plan and apply run once
over rows [0, n), the flat path bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import obs as OBS
from repro_torch.core import api
from repro_torch.core.attacks import fold_seed
from repro_torch.core.theory import FBudget
from repro_torch.hier.plan import GroupConfig, HierPlan
from repro_torch.tree import tree_leaves, tree_map

Tree = Any

#: the seed stream of the leaders→server re-encode, the counterpart of the
#: JAX package's ``LEADER_ENCODE_FOLD``: beside the trainer's
#: ``ENCODE_STREAM`` (2**31 - 2) and ``TRANSFORM_STREAM`` (2**31 - 1), and
#: above any leaf index a model reaches
LEADER_ENCODE_STREAM = 2 ** 31 - 3


def slice_rows(grads: Tree, start: int, stop: int) -> Tree:
    """Worker rows [start, stop) of every leaf, as views."""
    return tree_map(lambda x: x[start:stop], grads)


def stack_groups(parts) -> Tree:
    """The group aggregates' trees stacked into ``(n_groups, ...)``
    leaves."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *parts)


def outer_aggregate(inter: Tree, budget: FBudget, cfg: GroupConfig, *,
                    codec=None, seed: Optional[int] = None,
                    coord_chunk: int = 0, use_kernels: bool = False,
                    fused: "bool | str" = True
                    ) -> Tuple[Tree, Any, Any, int]:
    """The outer level over the ``(n_groups, ...)`` stack ``inter``: the
    leaders→server hop under ``codec`` (encoded with the seed
    ``fold_seed(seed, LEADER_ENCODE_STREAM)``, then decoded), stats, plan
    and apply.  Returns (aggregate, outer plan, outer stats, the hop's
    wire bytes (0 without a codec)).  An
    error-feedback codec is refused: the hop has no residual slot."""
    leader_bytes = 0
    if codec is not None:
        from repro_torch.comm import codecs as CC
        c = CC.get_codec(codec) if isinstance(codec, str) else codec
        if c.stateful:
            raise ValueError(
                "hier leader re-encode does not support error-feedback "
                "codecs (no residual slot at the leader hop); drop ef=1 "
                "or aggregate without hier")
        enc2, _ = c.encode(inter, seed=None if seed is None else
                           fold_seed(seed, LEADER_ENCODE_STREAM))
        leader_bytes = enc2.wire_bytes
        inter = c.decode(enc2)
        del enc2
    outer = api.get_aggregator(cfg.resolve_outer_rule(budget))
    ost = api.compute_stats(inter, budget.f_outer,
                            needs_dists=outer.needs_dists,
                            use_kernels=use_kernels)
    outer.validate(ost.n, ost.f)
    op = outer.plan(ost)
    agg = outer.apply(op, inter, coord_chunk=coord_chunk,
                      use_kernels=use_kernels, fused=fused)
    return agg, op, ost, leader_bytes


def hier_aggregate_tree(grads: Tree, f: int, cfg: GroupConfig, *,
                        codec=None, seed: Optional[int] = None,
                        coord_chunk: int = 0, use_kernels: bool = False,
                        fused: "bool | str" = True,
                        needs_dists: Optional[bool] = None,
                        decoded: Optional[Tree] = None,
                        obs: Optional[OBS.ObsConfig] = None,
                        obs_state: Optional[Dict[str, Any]] = None,
                        obs_round=None,
                        ) -> Tuple[Tree, HierPlan, Dict[str, Any]]:
    """Aggregate a stacked gradient tree (or a wire container)
    hierarchically.

    Returns ``(aggregate, HierPlan, info)``; ``info`` holds
    ``inner_stats`` (per-group :class:`AggStats`, for the score
    diagnostics), ``outer_stats`` and ``leader_wire_bytes``, the exact
    leaders→server bytes under ``codec`` (0 otherwise; the
    workers→leaders bytes are the input container's).

    ``cfg.budget(n, f)`` checks every level and, unless
    ``cfg.enforce_budget`` is off, that the budgets cover ``f``.
    ``codec`` (spec or instance) re-encodes the group aggregates for the
    second hop with the seed stream ``LEADER_ENCODE_STREAM`` of ``seed``;
    an error-feedback codec is refused.  ``needs_dists=True`` forces
    per-group distances for distance-free rules (the trainers' telemetry
    wants the score spectrum).  ``use_kernels`` is the JAX function's
    ``use_pallas``.

    For a wire container ``grads``, ``decoded`` may carry its decoded
    stack (the trainer's, decoded once): the statistics then run on the
    container's group slices and the applies on row views of
    ``decoded``, which decoding each group's slice would give bit for
    bit; without it each group's slice is decoded by the apply.

    ``obs`` / ``obs_state`` / ``obs_round`` thread the trainers' span
    ring through the tree: with an enabled, tracing ``obs.ObsConfig`` each
    level records its stats / plan / apply spans of round ``obs_round``
    (payload: the level's group count, ``n_groups`` for the inner level
    and 1 for the outer one) and ``info["obs_state"]`` carries the
    updated state out; otherwise ``obs_state`` passes through untouched.
    """
    obs_trace = (OBS.obs_on(obs) and obs.trace and obs_state is not None
                 and obs_state.get("t") is not None)

    def spans(st, payload):
        """One level's stats / plan / apply triple."""
        if not obs_trace:
            return st
        rnd = 0 if obs_round is None else obs_round
        t = st["t"]
        for phase in (OBS.PH_STATS, OBS.PH_PLAN, OBS.PH_APPLY):
            t = OBS.record(t, phase, rnd, payload)
        return {**st, "t": t}

    enc = api._as_encoded(grads)
    if enc is not None:
        from repro_torch.comm import codecs as CC
        n = enc.n
        slice_group = lambda s, e: CC.slice_workers(enc, s, e)  # noqa: E731
    else:
        leaves = tree_leaves(grads)
        if not leaves:
            raise ValueError("empty gradient tree")
        n = leaves[0].shape[0]
        slice_group = lambda s, e: slice_rows(grads, s, e)      # noqa: E731
    budget = cfg.budget(n, f)
    inner = api.get_aggregator(cfg.rule)
    inner_dists = inner.needs_dists if needs_dists is None else \
        (inner.needs_dists or needs_dists)

    inner_plans, inner_stats, parts = [], [], []
    for start, stop in budget.bounds():
        sub = slice_group(start, stop)
        st = api.compute_stats(sub, budget.f_inner,
                               needs_dists=inner_dists,
                               use_kernels=use_kernels)
        inner.validate(st.n, st.f)
        p = inner.plan(st)
        rows = sub if decoded is None else slice_rows(decoded, start, stop)
        parts.append(inner.apply(p, rows, coord_chunk=coord_chunk,
                                 use_kernels=use_kernels, fused=fused))
        inner_plans.append(p)
        inner_stats.append(st)
        del sub, rows

    # the inner level's triple, after the per-group loop
    obs_state = spans(obs_state, budget.n_groups)
    info: Dict[str, Any] = {"inner_stats": tuple(inner_stats),
                            "outer_stats": None, "leader_wire_bytes": 0,
                            "obs_state": obs_state}
    if budget.n_groups == 1:
        # g >= n is the flat rule: no outer level, no second hop
        return parts[0], HierPlan.build(budget, cfg, inner_plans, None), \
            info

    inter = stack_groups(parts)                   # (n_groups, ...) only
    del parts
    agg, op, ost, info["leader_wire_bytes"] = outer_aggregate(
        inter, budget, cfg, codec=codec, seed=seed, coord_chunk=coord_chunk,
        use_kernels=use_kernels, fused=fused)
    # the outer level's triple over the (n_groups, ...) stack
    info["obs_state"] = spans(obs_state, 1)
    info["outer_stats"] = ost
    return agg, HierPlan.build(budget, cfg, inner_plans, op), info
