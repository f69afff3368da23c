"""Tree-aware robust aggregation façade (cf. ``repro.core.robust``).

The trainer hands over a *stacked gradient tree*: every leaf has a leading
worker axis ``n``.  The stack is never concatenated into one (n, d)
matrix: the (n, n) squared distances are summed over the leaves, the
selection runs on that matrix (``Aggregator.plan``), and the plan is
applied leaf by leaf (``Aggregator.apply``).  The implementation lives in
:mod:`repro_torch.core.api`; ``tree_aggregate`` and
:class:`RobustAggregator` are thin wrappers over it, as in the JAX
package.

``coord_chunk``: the two-step Bulyan apply materialises (θ, numel) per
leaf; with ``coord_chunk`` it works through the coordinates in slices of
that width, to bound the live buffer.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch.configs.base import RobustConfig
from repro_torch.core import api
from repro_torch.tree import tree_leaves, tree_map

# re-exported, as the JAX module re-exports it
tree_pairwise_sqdist = api.tree_pairwise_sqdist

Tree = Any


def tree_aggregate(grads: Tree, f: int, name: str = "multi_bulyan", *,
                   coord_chunk: int = 0, use_kernels: bool = False,
                   dists: Optional[torch.Tensor] = None) -> Tree:
    """Aggregate a stacked gradient tree with the named GAR
    (:func:`repro_torch.core.api.aggregate_tree`)."""
    return api.aggregate_tree(grads, f, name, coord_chunk=coord_chunk,
                              use_kernels=use_kernels, dists=dists)


class RobustAggregator:
    """Callable façade bound to a :class:`RobustConfig`.

    >>> agg = RobustAggregator(RobustConfig(n_workers=16, f=3))
    >>> g = agg(stacked_grads)          # tree -> tree

    ``transforms`` (pre-aggregation stages, see ``core.api``) run on the
    stack before the GAR; stateful ones need ``states=`` threaded by the
    caller (the trainer does this itself), and the call then returns
    ``(aggregate, new_states)``.
    """

    def __init__(self, cfg: RobustConfig, coord_chunk: int = 0,
                 transforms: Sequence[api.Transform] = ()):
        cfg.validate()
        self.cfg = cfg
        self.coord_chunk = coord_chunk
        self.transforms = tuple(transforms)
        self.aggregator = api.get_aggregator(cfg.gar)

    def init_transform_states(self, grads_like: Tree):
        return api.init_transform_states(self.transforms, grads_like)

    def __call__(self, grads: Tree, *, states=None,
                 seed: Optional[int] = None):
        grads, new_states = api.apply_transforms(
            grads, self.transforms, states, seed=seed,
            use_kernels=self.cfg.use_kernels)
        out = api.aggregate_tree(grads, self.cfg.f, self.cfg.gar,
                                 coord_chunk=self.coord_chunk,
                                 use_kernels=self.cfg.use_kernels)
        return (out, new_states) if self.transforms else out

    def diagnostics(self, grads: Tree) -> dict:
        """Variance-condition diagnostics (paper §VI no-free-lunch)."""
        dists = tree_pairwise_sqdist(grads)
        mean = tree_map(lambda x: torch.mean(x, dim=0), grads)
        g_sq = sum(torch.sum(m.float() ** 2) for m in tree_leaves(mean))
        n = dists.shape[0]
        # sum_i ||G_i - mean||^2 = (1/2n) sum_ij d^2_ij
        dsig2 = torch.sum(dists) / (2.0 * n * n)
        return {
            "grad_norm": torch.sqrt(g_sq),
            "sqrt_d_sigma": torch.sqrt(dsig2),
            "mean_pairwise_dist": torch.sqrt(torch.sum(dists) /
                                             (n * (n - 1))),
        }
