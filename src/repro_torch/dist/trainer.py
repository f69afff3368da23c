"""Stacked byzantine-SGD trainer (cf. ``repro.dist.trainer``).

One train step:

1. forward+backward per worker, in a loop: each worker's
   ``torch.autograd.grad`` is written into a preallocated fp32
   ``(n, *leaf.shape)`` stack per leaf, which is already the contiguous
   ``(n, numel)`` operand the kernels read;
2. :func:`inject_byzantine` overwrites the first ``f`` worker rows of the
   stack, in place, with the attack's proposals (a gradient-space
   attack);
3. with a ``codec``: every worker encodes its rows onto the wire
   (``repro_torch.comm``), :func:`inject_wire` forges the first ``f``
   workers' messages (a wire attack), and the container is decoded into
   the gradient stack;
4. the pre-aggregation ``transforms`` (``core.api.apply_transforms``),
   whose state rides in ``TrainerState.tstates``; a ``needs_dists`` one
   takes its distances by K1 under ``rcfg.use_kernels``;
5. stats → plan → apply (``core.api.AggregatorBackend``): under
   ``rcfg.use_kernels`` the statistics take one K1 launch per leaf, or
   under a codec with no transform one K5 launch per int8 / bf16 wire
   leaf (straight off the payloads), and a bulyan apply one K2 launch per
   leaf on the (decoded, transformed) stack — or, with ``coord_chunk``,
   the two-step substrate, one K3 launch per column slice.  On a mesh
   (``shard_map_mesh``) the three run mesh-native on this rank's row
   block: K6 (K7 off the wire) per leaf for the statistics, K2 per leaf
   on the rank's column tile for the apply.  With ``hier`` the grouped
   pipeline (``repro_torch.hier``) replaces them: the same launches per
   group on the group's rows, then per leaf once more over the stack of
   group aggregates where the outer rule needs them;
6. one optimizer update from the aggregated gradient.

The step has signature ``(params, state, batch, seed) -> (params, state,
metrics)``; ``state`` is a :class:`TrainerState` (``opt``; ``tstates``,
one entry per transform; ``astate``, the adaptive attack's feedback
state; ``cres``, the error-feedback residual, under an ``ef=1`` codec).
The observability option of the JAX trainer is not ported yet.  The
streaming trainer (``dist.streaming``) builds on the
pieces here: :func:`per_worker_grads` of one block, the ``leaf_offset``
of the injections, and the honest-deviation helpers.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import comm as CM
from repro_torch import models as MD
from repro_torch.configs.base import ArchConfig, RobustConfig
from repro_torch.core import api
from repro_torch.core import attacks as ATK
from repro_torch.hier import hier_aggregate_tree
from repro_torch.optim.optimizers import OptState, Optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tree = Any
Tensor = torch.Tensor


# --------------------------------------------------------------------- data
def split_workers(batch: Dict[str, Tensor], n_workers: int
                  ) -> Dict[str, Tensor]:
    """(global_batch, ...) leaves -> (n_workers, per_worker, ...) leaves."""

    def sp(x):
        b = x.shape[0]
        if b % n_workers:
            raise ValueError(
                f"global batch {b} not divisible by n_workers={n_workers}")
        return x.reshape((n_workers, b // n_workers) + tuple(x.shape[1:]))

    return {k: sp(v) for k, v in batch.items()}


# ------------------------------------------------------------------ attacks
#: the seed stream of the codec's randomness, as the JAX trainer's
#: ``fold_in(key, 2**31 - 2)``; attack leaf i draws from stream i
ENCODE_STREAM = 2 ** 31 - 2
#: the seed stream of the transforms, as the JAX trainer's
#: ``fold_in(key, 2**31 - 1)``
TRANSFORM_STREAM = 2 ** 31 - 1


def inject_byzantine(grads: Tree, f: int, attack, seed: int = 0, *,
                     leaf_offset: int = 0) -> Tree:
    """Overwrite the first ``f`` worker rows of every leaf, in place, with
    the attack's proposals; the attack sees the ``(n-f, numel)`` fp32
    stack of correct rows.  ``attack`` is a spec string or a resolved
    ``(G, f, gen) -> (f, d)`` callable; leaf i draws from a generator
    seeded by ``(seed, leaf_offset + i)``, so a block of leaves that
    starts at leaf ``leaf_offset`` of the whole tree (the streaming
    trainer's) draws what the whole-tree call draws for them."""
    if f == 0:
        return grads
    attack_fn = ATK.get_attack(attack) if isinstance(attack, str) else attack
    for i, leaf in enumerate(tree_leaves(grads)):
        correct = leaf[f:].reshape(leaf.shape[0] - f, -1).float()
        byz = attack_fn(correct, f, ATK.leaf_generator(
            leaf.device, seed, leaf_offset + i))
        leaf[:f].copy_(byz.reshape((f,) + tuple(leaf.shape[1:])))
    return grads


def inject_wire(enc: CM.EncodedGrads, f: int, attack, seed: int = 0, *,
                leaf_offset: int = 0) -> CM.EncodedGrads:
    """Replace the first ``f`` workers' wire messages with the attack's.

    The wire counterpart of :func:`inject_byzantine`: ``attack`` is a wire
    attack spec (``core.attacks.WIRE_ATTACKS``) or a resolved callable; it
    sees the honest payload and sidecar rows of each leaf and forges the
    first ``f`` rows of both.  Leaf i gets the generator of
    ``(seed, leaf_offset + i)``, as in :func:`inject_byzantine`.  Returns
    a new container; ``enc`` is not modified.
    """
    if f == 0:
        return enc
    fn = ATK.get_wire_attack(attack) if isinstance(attack, str) else attack
    p_leaves = tree_leaves(enc.payload)
    new_p, new_s = [], []
    for i, (p, s) in enumerate(zip(p_leaves, CM.codecs.sidecar_leaves(enc))):
        gen = ATK.leaf_generator(p.device, seed, leaf_offset + i)
        pb, sb = fn(p[f:], None if s is None else s[f:], f, gen)
        new_p.append(torch.cat([pb.to(p.dtype), p[f:]], dim=0))
        new_s.append(None if s is None else
                     torch.cat([sb.to(s.dtype), s[f:]], dim=0))
    sidecar = None if enc.sidecar is None else \
        tree_unflatten(enc.sidecar, new_s)
    return dataclasses.replace(enc, payload=tree_unflatten(enc.payload, new_p),
                               sidecar=sidecar)


# -------------------------------------------------------------- state
@dataclasses.dataclass(frozen=True)
class TrainerState:
    """The trainer-state container, accessed by field name: ``opt`` (the
    optimizer's :class:`OptState`), ``tstates`` (one state per transform,
    ``None`` for a stateless one; ``()`` when no transform is stateful),
    ``astate`` (the adaptive attack's state, a dict of fp32 tensors,
    ``None`` unless the attack is adaptive) and ``cres`` (the
    error-feedback compression residual, a tree of fp32 ``(n, ...)``
    leaves, ``None`` unless the codec has ``ef=1``) and ``bstate`` (the
    async bounded-staleness buffer, a ``serve.buffer.BufferState``, seeded
    by ``serve.service.with_buffer``; ``None`` on the synchronous
    trainers).  ``mstate`` waits for the observability subsystem; the
    checkpoint store saves the slots by field name (``state|astate|z``)."""

    opt: OptState
    tstates: tuple = ()
    astate: Any = None
    cres: Any = None
    bstate: Any = None


def as_trainer_state(state) -> TrainerState:
    """Coerce a bare :class:`OptState` into a :class:`TrainerState`; a
    TrainerState passes through unchanged."""
    if isinstance(state, TrainerState):
        return state
    if isinstance(state, OptState):
        return TrainerState(opt=state)
    raise TypeError(
        f"expected TrainerState (or a bare OptState), got {type(state)}; "
        "seed trainer state with dist.init_train_state")


def _resolve_codec(codec) -> Optional[CM.Codec]:
    """Codec spec string / instance / None -> codec instance or None."""
    return CM.get_codec(codec) if isinstance(codec, str) else codec


def _derive_mesh_ctx(shard_map_mesh, shard_map_axes, spmd
                     ) -> Optional[api.MeshContext]:
    """Resolve the (mesh, axes, spmd) trio the trainer accepts, as the JAX
    trainer does: ``spmd=None`` turns the mesh-native path on whenever a
    mesh is given; ``shard_map_axes`` overrides the worker axes derived
    from the mesh's axis names."""
    if spmd is None:
        spmd = shard_map_mesh is not None
    if not spmd:
        return None
    if shard_map_mesh is None:
        raise ValueError("spmd aggregation needs shard_map_mesh")
    return api.MeshContext.for_mesh(
        shard_map_mesh,
        worker_axes=tuple(shard_map_axes) if shard_map_axes else None)


def init_train_state(opt: Optimizer, params: Tree,
                     transforms: Sequence[api.Transform] = (), *,
                     n_workers: int = 0, attack: str = "none",
                     attack_f: int = 0, codec=None) -> TrainerState:
    """Initial :class:`TrainerState`: stateful transforms (worker
    momentum) fill ``tstates``, and an error-feedback codec (``ef=1``)
    ``cres``, with zeros shaped like the ``n_workers`` stack; an adaptive
    attack spec (``core.attacks.ADAPTIVE``) fills ``astate``, seeded for
    ``attack_f`` byzantine rows on the parameters' device."""
    codec_obj = _resolve_codec(codec)
    stateful = any(t.stateful for t in transforms)
    adaptive = isinstance(attack, str) and ATK.is_adaptive(attack)
    ef = codec_obj is not None and codec_obj.stateful
    if not stateful and not adaptive and not ef:
        return TrainerState(opt=opt.init(params))
    if n_workers <= 0:
        raise ValueError("stateful transforms / adaptive attacks / "
                         "error-feedback codecs need n_workers > 0")
    # expand: the stacked shapes as views, nothing allocated
    stacked = tree_map(
        lambda p: p.expand((n_workers,) + tuple(p.shape)), params)
    tstates = api.init_transform_states(transforms, stacked) \
        if stateful else ()
    astate = ATK.get_adaptive(attack).init_state(
        n_workers, attack_f, device=tree_leaves(params)[0].device) \
        if adaptive else None
    cres = codec_obj.init_residual(stacked) if ef else None
    return TrainerState(opt=opt.init(params), tstates=tstates,
                        astate=astate, cres=cres)


# ------------------------------------------------------------------ trainer
# The honest-mean deviation is shared by the stacked and the streaming
# trainer (accumulated block by block there, finalised once), so the
# metric is the same float computation on both.
def honest_dev_accumulate(dev_sq, ref_sq, agg: Tree, grads: Tree,
                          f_eff: int):
    """Add one (sub)tree's ``||agg - honest_mean||^2`` and
    ``||honest_mean||^2`` terms, leaf by leaf; ``grads`` is the stack the
    rule consumed, whose rows ``f_eff:`` are the honest workers'."""
    for a, g in zip(tree_leaves(agg), tree_leaves(grads)):
        hm = torch.mean(g[f_eff:].float(), dim=0)
        dev_sq = dev_sq + torch.sum((a.float() - hm) ** 2)
        ref_sq = ref_sq + torch.sum(hm ** 2)
    return dev_sq, ref_sq


def honest_dev_finalize(dev_sq, ref_sq) -> Tensor:
    return torch.sqrt(dev_sq) / (torch.sqrt(ref_sq) + 1e-12)


def _honest_mean_dev(agg: Tree, grads: Tree, f_eff: int) -> Tensor:
    """Relative l2 deviation of the aggregate from the honest-row mean."""
    return honest_dev_finalize(
        *honest_dev_accumulate(0.0, 0.0, agg, grads, f_eff))


def per_worker_grads(params: Tree, cfg: ArchConfig,
                     batch: Dict[str, Tensor], *, window: int = 0,
                     chunk_q: int = 1024, block: Optional[str] = None):
    """(losses (n,), stacked fp32 gradient tree with leaves (n, ...)).

    Workers run one after another; worker w's gradient is written into
    row w of a preallocated stack per leaf, so at most one worker's
    activations and gradients are live besides the stack.  With
    ``block=k`` only the leaves of ``params[k]`` take gradients (the rest
    of the tree is closed over as constants) and the stack is that
    subtree's: each value is the matching leaf of the whole tree's stack.
    """
    sub = params if block is None else params[block]
    leaves = tree_leaves(sub)
    n = next(iter(batch.values())).shape[0]
    live = [p.detach().requires_grad_(True) for p in leaves]
    if block is None:
        live_tree = tree_unflatten(params, live)
    else:
        live_tree = {k: tree_unflatten(sub, live) if k == block else
                     tree_map(lambda p: p.detach(), v)
                     for k, v in params.items()}
    stacks = [torch.empty((n,) + tuple(p.shape), dtype=torch.float32,
                          device=p.device) for p in leaves]
    losses = torch.empty((n,), dtype=torch.float32, device=leaves[0].device)
    for w in range(n):
        wb = {k: v[w] for k, v in batch.items()}
        loss = MD.loss_fn(live_tree, cfg, wb, window=window, chunk_q=chunk_q)
        grads = torch.autograd.grad(loss, live)
        for s, g in zip(stacks, grads):
            s[w].copy_(g)
        losses[w] = loss.detach()
        del loss, grads
    return losses, tree_unflatten(sub, stacks)


def make_train_step(cfg: ArchConfig, rcfg: RobustConfig, opt: Optimizer,
                    lr_fn, *, window: int = 0, chunk_q: int = 1024,
                    attack: str = "none", attack_f: Optional[int] = None,
                    transforms: Sequence[api.Transform] = (),
                    codec=None, coord_chunk: int = 0,
                    telemetry: bool = False, shard_map_mesh=None,
                    shard_map_axes: Optional[Sequence[str]] = None,
                    spmd: Optional[bool] = None, hier=None):
    """Build the stacked-trainer step.

    ``attack`` is a spec string (``core.attacks.get_attack``, or a wire
    attack of ``core.attacks.WIRE_ATTACKS``, which needs a codec);
    ``attack_f`` the number of rows it controls (defaults to ``rcfg.f``).
    An adaptive spec (``adaptive_lie``, ``adaptive_mimic``) proposes from
    ``state.astate`` as it was before the step and updates it from the
    plan's selection weights after the apply (seed it with
    :func:`init_train_state`).

    ``codec`` (a ``repro_torch.comm`` spec such as ``"qsgd:bits=8"``)
    puts a compressed wire between workers and aggregator: the workers
    encode, a wire attack forges the encoded messages, the statistics run
    on the container (K5 under ``use_kernels``) and the apply on the rows
    decoded into the gradient stack.  An ``ef=1`` codec threads its
    residual through ``state.cres`` (:func:`init_train_state`).

    ``transforms`` (``core.api`` pre-aggregation stages) rewrite the
    (decoded) stack before the rule, drawing from the seed stream
    ``TRANSFORM_STREAM``; stateful ones thread their state through
    ``state.tstates`` (seed it with :func:`init_train_state`).  After a
    transform the statistics run on the rewritten stack, not on the wire
    container.  ``coord_chunk`` puts a bulyan apply on the two-step
    substrate in column slices of that width (``core.api._bulyan_leaf``).

    With ``telemetry`` the metrics gain a ``"telemetry"`` dict of plan
    diagnostics (``selection``, ``byz_mass``, score fields) plus
    ``honest_dev`` and, under a codec, ``wire_bytes_per_worker``.

    ``shard_map_mesh`` (a ``torch.distributed`` ``DeviceMesh`` from
    ``launch.mesh.make_host_mesh``; the JAX trainer's names, with
    ``shard_map_axes`` and ``spmd``: :func:`_derive_mesh_ctx`) makes the
    aggregation mesh-native.  Every rank runs the forward/backward, the
    attack, the codec and the transforms on the whole stack with the same
    seeds, exactly as without a mesh; then it cuts its
    ``core.api.row_block`` of the statistics' input (the wire container
    unless a transform rewrote the stack) and of the decoded stack, and
    stats → plan → apply run on those blocks
    (``core.api.AggregatorBackend`` with ``mesh_ctx``), every rank getting
    the whole aggregate.  So every attack, the adaptive state, the
    ``ef=1`` residual and the transforms compose with the mesh unchanged.

    ``hier`` (a ``repro_torch.hier.GroupConfig``) replaces stats → plan →
    apply with the two-level grouped pipeline
    (``hier.hier_aggregate_tree``): robust-aggregate within groups of
    ``hier.g`` workers, then over the group aggregates, with per-level f
    budgets from ``core.theory.split_f_budget``.  The statistics run on
    the wire container's group slices (unless a transform rewrote the
    stack) and the applies on row views of the decoded stack; under a
    codec the group aggregates are re-encoded for the leaders→server hop
    (seed stream ``hier.LEADER_ENCODE_STREAM``).  The adaptive state
    updates from the plan's two-level selection weights; telemetry gains
    ``group_selection`` and, under a codec, ``leader_wire_bytes``.  Not
    composable with a mesh or an error-feedback codec (JAX's refusals).
    """
    rcfg.validate()
    transforms = tuple(transforms)
    f_eff = rcfg.f if attack_f is None else attack_f
    if not 0 <= f_eff <= rcfg.f:
        raise ValueError(
            f"attack_f must be in [0, f] (attack_f={f_eff}, f={rcfg.f})")
    codec_obj = _resolve_codec(codec)
    wire = ATK.is_wire_attack(attack)
    if wire and codec_obj is None:
        raise ValueError(
            f"wire attack {attack!r} needs a codec= wire to attack "
            f"(available codecs: {list(CM.available_codecs())})")
    adaptive = None
    if wire:
        attack_fn = ATK.get_wire_attack(attack)
    elif ATK.is_adaptive(attack):
        adaptive, attack_fn = ATK.get_adaptive(attack), None
    else:
        attack_fn = ATK.get_attack(attack)
    mesh_ctx = _derive_mesh_ctx(shard_map_mesh, shard_map_axes, spmd)
    # telemetry wants the score spectrum even for distance-free rules
    backend = api.AggregatorBackend.for_config(
        rcfg, coord_chunk=coord_chunk, needs_dists=telemetry,
        mesh_ctx=mesh_ctx)
    needs_dists = backend.aggregator.needs_dists or telemetry
    if hier is not None:
        if mesh_ctx is not None:
            raise NotImplementedError(
                "hier= is not composable with the mesh-native (spmd) "
                "aggregation path yet; drop shard_map_mesh/spmd")
        if codec_obj is not None and codec_obj.stateful:
            raise ValueError(
                "hier= does not support error-feedback codecs (the "
                "leaders→server hop has no residual slot); drop ef=1")

    def rows(g):
        """What the backend takes: this rank's row block on a mesh."""
        return g if mesh_ctx is None else api.row_block(g, mesh_ctx)

    def step(params, state: TrainerState, batch, seed: int = 0):
        losses, grads = per_worker_grads(params, cfg, batch, window=window,
                                         chunk_q=chunk_q)
        astate, atk = state.astate, attack_fn
        if adaptive is not None:
            if astate is None:
                raise ValueError(
                    f"adaptive attack {attack!r} needs its state: build it "
                    f"with init_train_state(..., attack={attack!r})")
            atk = functools.partial(adaptive.propose, state=astate)
        if not wire:
            grads = inject_byzantine(grads, f_eff, atk, seed)
        enc, cres = None, state.cres
        with torch.no_grad():
            if codec_obj is not None:
                enc, cres = codec_obj.encode(
                    grads, seed=ATK.fold_seed(seed, ENCODE_STREAM),
                    residual=cres)
                if wire:
                    enc = inject_wire(enc, f_eff, attack_fn, seed)
                # what survived the wire, decoded into the stack (the
                # residual is already formed); statistics come straight
                # off the container
                grads = codec_obj.decode(enc, out=grads)
            # a stateful transform's new state may share storage with the
            # stack it returns: nothing below writes into ``grads``
            grads, tstates = api.apply_transforms(
                grads, transforms, state.tstates or None,
                seed=ATK.fold_seed(seed, TRANSFORM_STREAM),
                use_kernels=rcfg.use_kernels)
            # statistics straight off the wire container unless a
            # transform rewrote the decoded stack
            stats_src = enc if (enc is not None and not transforms) \
                else grads
            if hier is not None:
                agg, plan, hinfo = hier_aggregate_tree(
                    stats_src, rcfg.f, hier, codec=codec_obj, seed=seed,
                    coord_chunk=coord_chunk, use_kernels=rcfg.use_kernels,
                    needs_dists=needs_dists,
                    decoded=grads if stats_src is enc else None)
                stats = hinfo["inner_stats"]
            else:
                stats = backend.stats(rows(stats_src))
                plan = backend.plan(stats)
                agg = backend.apply(plan, rows(grads))
            if adaptive is not None:
                astate = adaptive.update(astate, plan.selection_weights())
            lr = lr_fn(state.opt.step)
            new_params, new_opt = opt.update(agg, state.opt, params, lr)
            gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                   for g in tree_leaves(agg)))
            metrics = {"loss": torch.mean(losses),
                       "loss_per_worker": losses,
                       "lr": lr,
                       "agg_grad_norm": gnorm}
            if telemetry:
                diag = plan.diagnostics(stats)
                # captured mass over the rows the attack holds (f_eff)
                diag["byz_mass"] = torch.sum(diag["selection"][:f_eff])
                diag["honest_dev"] = _honest_mean_dev(agg, grads, f_eff)
                if enc is not None:
                    diag["wire_bytes_per_worker"] = enc.bytes_per_worker
                if hier is not None and codec_obj is not None:
                    diag["leader_wire_bytes"] = hinfo["leader_wire_bytes"]
                metrics["telemetry"] = diag
        new_state = dataclasses.replace(state, opt=new_opt, tstates=tstates,
                                        astate=astate, cres=cres)
        return tree_map(lambda p: p.detach(), new_params), new_state, metrics

    return step
