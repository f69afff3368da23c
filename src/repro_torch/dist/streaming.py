"""Streaming multi-Bulyan: per-block backward passes, plan reuse (cf.
``repro.dist.streaming``; the JAX package's DESIGN.md section 5).

The stacked trainer (``dist.trainer``) holds the whole ``(n, d)`` fp32
gradient stack at once.  The streaming trainer holds one block's: the
blocks are the top-level entries of the parameter tree, walked in sorted
key order (for the dense decoder ``embed``, ``final_norm``, ``groups``),
so their leaves concatenate into the whole tree's leaf order.  Each
block's stack comes from :func:`dist.trainer.per_worker_grads` with
``block=k``: the gradient with respect to that block only, the rest of
the parameters closed over, which equals the matching leaves of the whole
stack.

* ``scope="global"``, the exact algorithm: pass 1 walks the blocks and
  adds each leaf's raw (n, n) distance contribution (K1, or K5 off the
  wire container, under ``use_kernels``) to one running total, leaf by
  leaf in the whole tree's order, the float summation of the stacked
  trainer's single pass; the plan is made once; pass 2 walks the blocks
  again, takes the gradients again and applies the plan to each (K2).
  The step equals the stacked trainer's bit for bit, at twice its
  forward/backward work.
* ``scope="block"``: one pass; each block takes its own statistics, plan
  and apply.  Selection is per block, so a byzantine worker can win in one
  block and lose in another.

With ``hier`` (a ``repro_torch.hier.GroupConfig``) both scopes aggregate
in two levels.  Global scope: pass 1 adds one raw (g_k, g_k) total per
group, leaf by leaf in the whole tree's order (each group's rows a view
of the leaf, or its slice of the leaf's wire container), never an (n, n)
one; pass 2 applies each group's plan to its rows and keeps only the
block's ``(n_groups, ...)`` stack of group aggregates; the outer level
(the leaders→server re-encode under a codec, stats, plan, apply) runs
once over those.  That is the stacked ``hier`` step bit for bit, on every
wire.  Block scope runs the whole ``hier.hier_aggregate_tree`` per block.

Every random draw uses the leaf's index in the whole tree (the
``leaf_offset`` of ``inject_byzantine``, ``Codec.encode`` and
``inject_wire``), so the attack, the codec and the wire attack draw what
the stacked trainer draws.  Between the passes and between blocks no
reference to a block's stack, container or autograd graph survives: one
block's stack is live at a time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch import obs as OBS
from repro_torch.comm import codecs as CC
from repro_torch.configs.base import ArchConfig, RobustConfig
from repro_torch.core import api
from repro_torch.core import attacks as ATK
from repro_torch.dist.trainer import (
    ENCODE_STREAM, _derive_mesh_ctx, _resolve_codec, as_trainer_state,
    honest_dev_accumulate, honest_dev_finalize, inject_byzantine,
    inject_wire, per_worker_grads, record_step)
from repro_torch.hier import aggregate as HA
from repro_torch.hier.plan import HierPlan
from repro_torch.optim.optimizers import Optimizer
from repro_torch.tree import tree_leaves, tree_map


def _block_keys(params):
    """Top-level block names in the whole tree's leaf order (sorted keys),
    or None for a tree that is not a dict (one block: the tree)."""
    if not isinstance(params, dict):
        return None
    return sorted(params.keys())


def make_streaming_train_step(cfg: ArchConfig, rcfg: RobustConfig,
                              opt: Optimizer, lr_fn, *,
                              scope: str = "block", window: int = 0,
                              chunk_q: int = 1024, attack: str = "none",
                              attack_f: Optional[int] = None, codec=None,
                              coord_chunk: int = 0, telemetry: bool = False,
                              transforms: Sequence[api.Transform] = (),
                              shard_map_mesh=None, shard_map_axes=None,
                              spmd: Optional[bool] = None, hier=None,
                              obs: Optional[OBS.ObsConfig] = None):
    """Build the streaming-trainer step, ``(params, state, batch, seed) ->
    (params, state, metrics)`` as the stacked trainer's.

    ``attack`` takes the stacked trainer's spec strings, adaptive ones
    excepted (their feedback needs the whole step); ``attack_f`` (default
    ``rcfg.f``) is the number of rows it controls.  ``codec`` puts the
    compressed wire between workers and aggregator block by block; an
    error-feedback codec (``ef=1``) is refused, its residual needs the
    stacked trainer's state slot.  ``transforms`` are refused (they need
    the whole stack).  With ``telemetry`` the metrics gain the stacked
    trainer's ``"telemetry"`` dict; under ``scope="block"`` its plan
    diagnostics are the mean over the block plans.

    ``shard_map_mesh`` / ``shard_map_axes`` / ``spmd`` make the
    aggregation mesh-native, as on the stacked trainer: the statistics
    and the apply take each block's ``core.api.row_block`` (K6, or K7 off
    the wire, per leaf in pass 1; K2 on the rank's column tile in pass 2),
    every rank reaching the collectives in the same leaf order.

    ``hier`` (a ``repro_torch.hier.GroupConfig``) aggregates in two levels
    (the module docstring): per group then over the group aggregates, with
    the budget of ``hier.budget(rcfg.n_workers, rcfg.f)`` checked when the
    step is built.  Not composable with a mesh (JAX's refusal).

    ``obs`` mirrors the stacked trainer: an enabled ``obs.ObsConfig``
    records the stacked trainer's registry into ``state.mstate`` and, with
    ``obs.trace``, one span a phase a step: stats and plan once pass 1 is
    done (the plan's payload 1 when one plan serves every block, else 0),
    apply after the update (payload: the aggregate's norm).  Disabled or
    ``None``, the step dispatches the ops of the uninstrumented step.

    The step takes and returns a ``TrainerState`` (a bare ``OptState`` is
    coerced); only its ``opt`` and ``mstate`` slots are live, and a state
    carrying transform, attack or residual state is refused.
    """
    if scope not in ("block", "global"):
        raise ValueError(f"scope must be 'block' or 'global', got {scope!r}")
    if transforms:
        raise NotImplementedError(
            "pre-aggregation transforms need the full stack; use the "
            "stacked trainer (dist.make_train_step) with transforms")
    wire = ATK.is_wire_attack(attack)
    if not wire and ATK.is_adaptive(attack):
        raise NotImplementedError(
            "adaptive attacks need the stacked trainer's plan-feedback "
            "state; use dist.make_train_step")
    rcfg.validate()
    f_eff = rcfg.f if attack_f is None else attack_f
    if not 0 <= f_eff <= rcfg.f:
        raise ValueError(
            f"attack_f must be in [0, f] (attack_f={f_eff}, f={rcfg.f})")
    codec_obj = _resolve_codec(codec)
    if wire and codec_obj is None:
        raise ValueError(
            f"wire attack {attack!r} needs a codec= wire to attack "
            f"(available codecs: {list(CC.available_codecs())})")
    if codec_obj is not None and codec_obj.stateful:
        raise NotImplementedError(
            "error-feedback codecs carry a per-worker residual; use the "
            "stacked trainer (dist.make_train_step) with codec")
    attack_fn = ATK.get_wire_attack(attack) if wire else \
        ATK.get_attack(attack)
    mesh_ctx = _derive_mesh_ctx(shard_map_mesh, shard_map_axes, spmd)
    backend = api.AggregatorBackend.for_config(
        rcfg, coord_chunk=coord_chunk, needs_dists=telemetry,
        mesh_ctx=mesh_ctx, obs=obs)
    obs_live = OBS.obs_on(obs)
    # telemetry wants the score spectrum even for distance-free rules
    needs_stats = backend.aggregator.needs_dists or telemetry
    budget = inner = None
    if hier is not None:
        if mesh_ctx is not None:
            raise NotImplementedError(
                "hier= is not composable with the mesh-native (spmd) "
                "aggregation path yet; drop shard_map_mesh/spmd")
        # checked once: every block's stack has rcfg.n_workers rows
        budget = hier.budget(rcfg.n_workers, rcfg.f)
        inner = api.get_aggregator(hier.rule)
        needs_stats = inner.needs_dists or telemetry
    kw = dict(coord_chunk=coord_chunk, use_kernels=rcfg.use_kernels)

    def rows(g):
        """What the backend takes: this rank's row block on a mesh."""
        return g if mesh_ctx is None else api.row_block(g, mesh_ctx)

    def step(params, state, batch, seed: int = 0):
        state = as_trainer_state(state)
        if state.tstates or state.astate is not None \
                or state.cres is not None:
            raise NotImplementedError(
                "the streaming trainer carries only the opt slot; a "
                "TrainerState with live tstates/astate/cres belongs to "
                "the stacked trainer (dist.make_train_step)")
        if obs_live and state.mstate is None:
            state = dataclasses.replace(state, mstate=OBS.init_train_obs(
                obs, rcfg.n_workers, telemetry=telemetry,
                device=tree_leaves(params)[0].device))
        keys = _block_keys(params)
        blocks = [None] if keys is None else keys
        # each block's first leaf in the whole tree's leaf order
        offsets, off = {}, 0
        for k in blocks:
            offsets[k] = off
            off += len(tree_leaves(params if k is None else params[k]))

        def block_grads(k):
            """(losses, the block's attacked stack, its wire container or
            None): the stack is what survived the wire, decoded in place."""
            losses, g = per_worker_grads(params, cfg, batch, window=window,
                                         chunk_q=chunk_q, block=k)
            if not wire:
                g = inject_byzantine(g, f_eff, attack_fn, seed,
                                     leaf_offset=offsets[k])
            if codec_obj is None:
                return losses, g, None
            with torch.no_grad():
                enc, _ = codec_obj.encode(
                    g, seed=ATK.fold_seed(seed, ENCODE_STREAM),
                    leaf_offset=offsets[k])
                if wire:
                    enc = inject_wire(enc, f_eff, attack_fn, seed,
                                      leaf_offset=offsets[k])
                return losses, codec_obj.decode(enc, out=g), enc

        def add_block(totals, k, bounds=None):
            """``totals`` plus block k's raw contributions, leaf by leaf (a
            container's leaf off its payload): to the one (n, n) total,
            or with ``bounds`` to each group's (g_k, g_k) total from the
            group's rows of the leaf.  The block's stack and container
            die on return."""
            _, g, enc = block_grads(k)
            units = tree_leaves(g) if enc is None else \
                CC.leaf_containers(enc)
            del g, enc
            with torch.no_grad():
                for u in units:
                    if bounds is None:
                        totals = totals + api.raw_pairwise_stats(
                            rows(u), use_kernels=rcfg.use_kernels,
                            mesh_ctx=mesh_ctx)[0]
                        continue
                    for gi, (s, e) in enumerate(bounds):
                        part = u[s:e] if isinstance(u, torch.Tensor) \
                            else CC.slice_workers(u, s, e)
                        totals[gi] = totals[gi] + api.raw_pairwise_stats(
                            part, use_kernels=rcfg.use_kernels)[0]
            return totals

        if hier is not None and scope == "global":
            return hier_global_step(params, state, seed, blocks, keys,
                                    block_grads, add_block)

        plan = global_diag = None
        if scope == "global" and needs_stats:
            # pass 1: one running total in the whole tree's leaf order,
            # finalised once: the stacked trainer's float summation
            # (per-block subtotals would reassociate the sums)
            n = rcfg.n_workers
            total = torch.zeros((n, n), dtype=torch.float32,
                                device=tree_leaves(params)[0].device)
            for k in blocks:
                total = add_block(total, k)
            stats = api.AggStats(n=n, f=rcfg.f,
                                 dists=api.finalize_dists(total))
            plan = backend.plan(stats)
            if telemetry:
                global_diag = plan.diagnostics(stats)
        elif hier is None and not needs_stats:
            # a distance-free rule's plan does not depend on the block
            plan = backend.plan(api.AggStats(n=rcfg.n_workers, f=rcfg.f))
        state = pass_one_spans(state, plan)

        # pass 2, or block scope's only pass: the first block's losses are
        # the step's
        agg, losses, diags = {}, None, []
        dev_sq = ref_sq = 0.0
        wire_total = leader_total = 0
        for k in blocks:
            l_k, g, enc = block_grads(k)
            losses = l_k if losses is None else losses
            del l_k
            with torch.no_grad():
                if hier is not None:
                    # block scope: the whole two-level pipeline per block
                    agg[k], hplan_k, hinfo_k = HA.hier_aggregate_tree(
                        g if enc is None else enc, rcfg.f, hier,
                        codec=codec_obj, seed=seed,
                        needs_dists=True if telemetry else None,
                        decoded=None if enc is None else g, **kw)
                    leader_total += hinfo_k["leader_wire_bytes"]
                    if enc is not None:
                        wire_total += enc.wire_bytes
                    del enc
                    if telemetry:
                        diags.append(hplan_k.diagnostics(
                            hinfo_k["inner_stats"]))
                        dev_sq, ref_sq = honest_dev_accumulate(
                            dev_sq, ref_sq, agg[k], g, f_eff)
                    del g
                    continue
                block_plan = plan
                if block_plan is None:
                    # block scope: the block's own statistics (off the
                    # wire container when there is one) and plan
                    stats_k = backend.stats(rows(g if enc is None else enc))
                    block_plan = backend.plan(stats_k)
                    if telemetry:
                        diags.append(block_plan.diagnostics(stats_k))
                if enc is not None:
                    wire_total += enc.wire_bytes
                del enc
                agg[k] = backend.apply(block_plan, rows(g))
                if telemetry:
                    dev_sq, ref_sq = honest_dev_accumulate(
                        dev_sq, ref_sq, agg[k], g, f_eff)
            del g
        agg = agg[None] if keys is None else agg
        return finish(params, state, agg, losses, global_diag, diags,
                      dev_sq, ref_sq, wire_total, leader_total)

    def hier_global_step(params, state, seed, blocks, keys, block_grads,
                         add_block):
        """Global scope under ``hier``: pass 1 (per-group totals), the
        inner plans, pass 2 (each block's stack of group aggregates), the
        outer level once; ``block_grads`` and ``add_block`` are the
        step's."""
        bounds = budget.bounds()
        dev = tree_leaves(params)[0].device
        if needs_stats:
            totals = [torch.zeros((e - s, e - s), dtype=torch.float32,
                                  device=dev) for s, e in bounds]
            for k in blocks:
                totals = add_block(totals, k, bounds)
            inner_stats = tuple(
                api.AggStats(n=e - s, f=budget.f_inner,
                             dists=api.finalize_dists(t))
                for (s, e), t in zip(bounds, totals))
            del totals
        else:
            inner_stats = tuple(api.AggStats(n=e - s, f=budget.f_inner)
                                for s, e in bounds)
        plans = []
        for st in inner_stats:
            inner.validate(st.n, st.f)
            plans.append(inner.plan(st))
        state = pass_one_spans(state, None)
        # pass 2: only each block's (n_groups, ...) stack survives it
        inter, honest, losses = {}, {}, None
        wire_total = 0
        for k in blocks:
            l_k, g, enc = block_grads(k)
            losses = l_k if losses is None else losses
            with torch.no_grad():
                if enc is not None:
                    wire_total += enc.wire_bytes
                del enc
                inter[k] = HA.stack_groups([
                    inner.apply(p, HA.slice_rows(g, s, e), **kw)
                    for p, (s, e) in zip(plans, bounds)])
                if telemetry:
                    # the honest means, d-sized, for the deviation once
                    # the outer aggregate exists
                    honest[k] = tree_map(
                        lambda x: torch.mean(x[f_eff:].float(), dim=0), g)
            del g, l_k
        inter = inter[None] if keys is None else inter
        leader_total, outer_plan = 0, None
        with torch.no_grad():
            if budget.n_groups == 1:
                agg = tree_map(lambda x: x[0], inter)
            else:
                agg, outer_plan, _, leader_total = HA.outer_aggregate(
                    inter, budget, hier, codec=codec_obj, seed=seed, **kw)
            del inter
            global_diag, dev_sq, ref_sq = None, 0.0, 0.0
            if telemetry:
                global_diag = HierPlan.build(
                    budget, hier, plans, outer_plan).diagnostics(inner_stats)
                hm = honest[None] if keys is None else honest
                for a, m in zip(tree_leaves(agg), tree_leaves(hm)):
                    dev_sq = dev_sq + torch.sum((a.float() - m) ** 2)
                    ref_sq = ref_sq + torch.sum(m ** 2)
        return finish(params, state, agg, losses, global_diag, [], dev_sq,
                      ref_sq, wire_total, leader_total)

    def pass_one_spans(state, plan):
        """The stats and plan spans of the step, once pass 1 is done: one
        a phase, the plan's payload 1 when a plan serves every block."""
        if not (obs_live and obs.trace):
            return state
        ms = state.mstate
        t = OBS.record(ms["t"], OBS.PH_STATS, state.opt.step)
        t = OBS.record(t, OBS.PH_PLAN, state.opt.step,
                       0.0 if plan is None else 1.0)
        return dataclasses.replace(state, mstate={**ms, "t": t})

    def finish(params, state, agg, losses, global_diag, diags, dev_sq,
               ref_sq, wire_total, leader_total):
        """The optimizer update and the metrics of a step."""
        with torch.no_grad():
            lr = lr_fn(state.opt.step)
            new_params, new_opt = opt.update(agg, state.opt, params, lr)
            gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                   for g in tree_leaves(agg)))
            metrics = {"loss": torch.mean(losses),
                       "loss_per_worker": losses,
                       "lr": lr,
                       "agg_grad_norm": gnorm}
            if telemetry:
                if global_diag is not None:
                    diag = dict(global_diag)
                else:
                    # block scope: the mean over the block plans
                    diag = {kk: torch.mean(torch.stack(
                        [d[kk] for d in diags]), dim=0) for kk in diags[0]}
                # captured mass over the rows the attack holds (f_eff)
                diag["byz_mass"] = torch.sum(diag["selection"][:f_eff])
                diag["honest_dev"] = honest_dev_finalize(dev_sq, ref_sq)
                if codec_obj is not None:
                    diag["wire_bytes_per_worker"] = \
                        wire_total // rcfg.n_workers
                if hier is not None and codec_obj is not None:
                    diag["leader_wire_bytes"] = leader_total
                metrics["telemetry"] = diag
            mstate = record_step(state.mstate, obs, state.opt.step,
                                 metrics) if obs_live else state.mstate
        new_state = dataclasses.replace(state, opt=new_opt, mstate=mstate)
        return tree_map(lambda p: p.detach(), new_params), new_state, metrics

    return step
