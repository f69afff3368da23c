"""SGD(+momentum) and AdamW over nested-dict parameters (cf.
``repro.optim.optimizers``).

``init(params) -> OptState``; ``update(grads, state, params, lr) ->
(new_params, new_state)``.  Updates are functional: new tensors are
returned and the caller drops the old ones.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tree = Any


class OptState(NamedTuple):
    step: int
    mu: Optional[Tree]    # first moment / momentum
    nu: Optional[Tree]    # second moment (adam only)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], OptState]
    update: Callable[..., tuple]


def _zeros_like_f32(tree: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def _split(params: Tree, out: list, k: int) -> Tree:
    return tree_unflatten(params, [o[k] for o in out])


def sgd(momentum: float = 0.9, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        mu = _zeros_like_f32(params) if momentum else None
        return OptState(0, mu, None)

    def update(grads, state, params, lr):
        def upd(p, g, m):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p.float()
            if momentum:
                m = momentum * m + g
                step_dir = (g + momentum * m) if nesterov else m
            else:
                step_dir = g
            new_p = p.float() - lr * step_dir
            return new_p.to(p.dtype), m

        mus = tree_leaves(state.mu) if momentum else \
            [None] * len(tree_leaves(params))
        out = [upd(p, g, m) for p, g, m in
               zip(tree_leaves(params), tree_leaves(grads), mus)]
        new_mu = _split(params, out, 1) if momentum else None
        return _split(params, out, 0), OptState(state.step + 1, new_mu, None)

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return OptState(0, _zeros_like_f32(params), _zeros_like_f32(params))

    def update(grads, state, params, lr):
        t = state.step + 1
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t

        def upd(p, g, m, v):
            g = g.float()
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            step_dir = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step_dir = step_dir + weight_decay * p.float()
            new_p = p.float() - lr * step_dir
            return new_p.to(p.dtype), m, v

        out = [upd(*xs) for xs in zip(
            tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
            tree_leaves(state.nu))]
        return _split(params, out, 0), OptState(
            t, _split(params, out, 1), _split(params, out, 2))

    return Optimizer(init, update)


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(**kw)
    if name == "adamw":
        return adamw(**kw)
    raise KeyError(f"unknown optimizer {name!r}")
