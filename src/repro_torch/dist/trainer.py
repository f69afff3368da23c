"""Stacked byzantine-SGD trainer (cf. ``repro.dist.trainer``).

One train step:

1. forward+backward per worker, in a loop: each worker's
   ``torch.autograd.grad`` is written into a preallocated fp32
   ``(n, *leaf.shape)`` stack per leaf, which is already the contiguous
   ``(n, numel)`` operand the kernels read;
2. :func:`inject_byzantine` overwrites the first ``f`` worker rows of the
   stack, in place, with the attack's proposals;
3. stats → plan → apply (``core.api.AggregatorBackend``): under
   ``rcfg.use_kernels`` one K1 launch per leaf for the statistics and one
   K2 launch per leaf for a bulyan apply;
4. one optimizer update from the aggregated gradient.

The step has signature ``(params, state, batch, seed) -> (params, state,
metrics)``; ``state`` is a :class:`TrainerState` (only ``opt`` is live in
the port so far).  The codec, mesh, hierarchical, observability and
transform options of the JAX trainer are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import models as MD
from repro_torch.configs.base import ArchConfig, RobustConfig
from repro_torch.core import api
from repro_torch.core import attacks as ATK
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
def _leaf_generator(device: torch.device, seed: int, leaf_index: int
                    ) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1_000_003 + leaf_index) % (2 ** 63))
    return gen


def inject_byzantine(grads: Tree, f: int, attack, seed: int = 0) -> Tree:
    """Overwrite the first ``f`` worker rows of every leaf, in place, with
    the attack's proposals; the attack sees the ``(n-f, numel)`` fp32
    stack of correct rows.  ``attack`` is a spec string or a resolved
    ``(G, f, gen) -> (f, d)`` callable; leaf i draws from a generator
    seeded by ``(seed, i)``."""
    if f == 0:
        return grads
    attack_fn = ATK.get_attack(attack) if isinstance(attack, str) else attack
    for i, leaf in enumerate(tree_leaves(grads)):
        correct = leaf[f:].reshape(leaf.shape[0] - f, -1).float()
        byz = attack_fn(correct, f, _leaf_generator(leaf.device, seed, i))
        leaf[:f].copy_(byz.reshape((f,) + tuple(leaf.shape[1:])))
    return grads


# -------------------------------------------------------------- state
@dataclasses.dataclass(frozen=True)
class TrainerState:
    """The trainer-state container, accessed by field name.  Only ``opt``
    (the optimizer's :class:`OptState`) is live in the port so far; the
    other slots of the JAX container wait for their subsystems."""

    opt: OptState
    tstates: tuple = ()
    astate: Any = None
    cres: Any = None


def init_train_state(opt: Optimizer, params: Tree) -> TrainerState:
    return TrainerState(opt=opt.init(params))


# ------------------------------------------------------------------ trainer
def _honest_mean_dev(agg: Tree, grads: Tree, f_eff: int) -> Tensor:
    """Relative l2 deviation of the aggregate from the honest-row mean."""
    dev_sq = ref_sq = 0.0
    for a, g in zip(tree_leaves(agg), tree_leaves(grads)):
        hm = torch.mean(g[f_eff:].float(), dim=0)
        dev_sq = dev_sq + torch.sum((a.float() - hm) ** 2)
        ref_sq = ref_sq + torch.sum(hm ** 2)
    return torch.sqrt(dev_sq) / (torch.sqrt(ref_sq) + 1e-12)


def per_worker_grads(params: Tree, cfg: ArchConfig,
                     batch: Dict[str, Tensor], *, window: int = 0,
                     chunk_q: int = 1024):
    """(losses (n,), stacked fp32 gradient tree with leaves (n, ...)).

    Workers run one after another; worker w's gradient is written into
    row w of a preallocated stack per leaf, so at most one worker's
    activations and gradients are live besides the stack.
    """
    leaves = tree_leaves(params)
    n = next(iter(batch.values())).shape[0]
    live = [p.detach().requires_grad_(True) for p in leaves]
    live_tree = tree_unflatten(params, live)
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
    return losses, tree_unflatten(params, stacks)


def make_train_step(cfg: ArchConfig, rcfg: RobustConfig, opt: Optimizer,
                    lr_fn, *, window: int = 0, chunk_q: int = 1024,
                    attack: str = "none", attack_f: Optional[int] = None,
                    telemetry: bool = False):
    """Build the stacked-trainer step.

    ``attack`` is a spec string (``core.attacks.get_attack``); ``attack_f``
    the number of rows it controls (defaults to ``rcfg.f``).  With
    ``telemetry`` the metrics gain a ``"telemetry"`` dict of plan
    diagnostics (``selection``, ``byz_mass``, score fields) plus
    ``honest_dev``.
    """
    rcfg.validate()
    f_eff = rcfg.f if attack_f is None else attack_f
    if not 0 <= f_eff <= rcfg.f:
        raise ValueError(
            f"attack_f must be in [0, f] (attack_f={f_eff}, f={rcfg.f})")
    attack_fn = ATK.get_attack(attack)
    # telemetry wants the score spectrum even for distance-free rules
    backend = api.AggregatorBackend.for_config(rcfg, needs_dists=telemetry)

    def step(params, state: TrainerState, batch, seed: int = 0):
        losses, grads = per_worker_grads(params, cfg, batch, window=window,
                                         chunk_q=chunk_q)
        grads = inject_byzantine(grads, f_eff, attack_fn, seed)
        with torch.no_grad():
            stats = backend.stats(grads)
            plan = backend.plan(stats)
            agg = backend.apply(plan, grads)
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
                metrics["telemetry"] = diag
        new_state = dataclasses.replace(state, opt=new_opt)
        return tree_map(lambda p: p.detach(), new_params), new_state, metrics

    return step
