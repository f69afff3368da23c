"""Plan/apply aggregation API, single-device subset (cf. ``repro.core.api``).

* ``plan(stats)`` runs on the replicated ``(n, n)`` squared-distance matrix
  and per-worker norms only: O(n²·θ) scalar work, no touch of the d axis.
* ``apply(plan, grads)`` runs the per-leaf contractions and the coordinate
  phase over d.

Every GAR is an :class:`Aggregator` registered by name with capability
flags (``needs_dists``, ``min_n``).  Under ``use_kernels`` the statistics
go through ``kernels.ops.pairwise_stats`` (K1) once per leaf and every
bulyan leaf through ``kernels.ops.fused_select`` (K2): the CUDA kernels for
CUDA tensors, their plain versions for CPU tensors.

Gradient trees are nested dicts whose leaves carry the worker axis first;
leaves are visited in sorted key-path order (``repro_torch.tree``), as JAX
flattens them, so cross-leaf fp32 sums associate as in the reference.
The mesh, encoded-wire and transform branches of the JAX module are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import gar as G
from repro_torch.core import theory
from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor
Tree = Any


# ==========================================================================
# statistics (the plan's only input)
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class AggStats:
    """Replicated per-round statistics the selection plan is computed from:
    the (n, n) fp32 squared distances (when the rule needs them) and the
    (n,) squared l2 norms."""

    n: int
    f: int
    dists: Optional[Tensor] = None
    sq_norms: Optional[Tensor] = None


def _leaf2d(x: Tensor) -> Tensor:
    """(n, ...) -> (n, numel) view."""
    return x.reshape(x.shape[0], -1)


def _leaf_stats_contrib(leaf: Tensor) -> Tuple[Tensor, Tensor]:
    """One leaf's raw (dists, sq_norms) contribution: the plain formula
    ``sq_i + sq_j - 2 gram``, fp32, unclamped, diagonal kept."""
    x = _leaf2d(leaf).float()
    sq = torch.sum(x * x, dim=1)
    gram = x @ x.T
    return sq[:, None] + sq[None, :] - 2.0 * gram, sq


def finalize_dists(total: Tensor) -> Tensor:
    """Numerical floor + exact-zero diagonal on an accumulated (n, n) sum
    (NaN propagates through the floor, as ``jnp.maximum`` does)."""
    total = torch.maximum(total, torch.zeros_like(total))
    n = total.shape[0]
    return total * (1.0 - torch.eye(n, dtype=total.dtype,
                                    device=total.device))


def raw_pairwise_stats(grads: Tree, *, use_kernels: bool = False
                       ) -> Tuple[Tensor, Tensor]:
    """(raw (n, n) sq-dists, (n,) sq-norms) summed over the leaves in
    sorted key-path order; unclamped, diagonal kept.  Under
    ``use_kernels`` each leaf is one K1 launch (one read of the leaf)."""
    leaves = tree_leaves(grads)
    if not leaves:
        raise ValueError("empty gradient tree")
    n = leaves[0].shape[0]
    dev = leaves[0].device
    total_d = torch.zeros((n, n), dtype=torch.float32, device=dev)
    total_s = torch.zeros((n,), dtype=torch.float32, device=dev)
    for leaf in leaves:
        if leaf.shape[0] != n:
            raise ValueError("all leaves must share the worker axis size")
        if use_kernels:
            dd, sq = kops.pairwise_stats(_leaf2d(leaf).float().contiguous())
        else:
            dd, sq = _leaf_stats_contrib(leaf)
        total_d = total_d + dd
        total_s = total_s + sq
    return total_d, total_s


def tree_pairwise_stats(grads: Tree, *, use_kernels: bool = False
                        ) -> Tuple[Tensor, Tensor]:
    """Single pass over the stack: (finalised (n, n) sq-dists, (n,) norms)."""
    total_d, total_s = raw_pairwise_stats(grads, use_kernels=use_kernels)
    return finalize_dists(total_d), total_s


def tree_sq_norms(grads: Tree) -> Tensor:
    """Per-worker squared l2 norms across every leaf -> (n,) fp32."""
    leaves = tree_leaves(grads)
    total = torch.zeros((leaves[0].shape[0],), dtype=torch.float32,
                        device=leaves[0].device)
    for leaf in leaves:
        x = _leaf2d(leaf).float()
        total = total + torch.sum(x * x, dim=1)
    return total


def compute_stats(grads: Tree, f: int, *, needs_dists: bool = True,
                  needs_norms: bool = False, use_kernels: bool = False,
                  dists: Optional[Tensor] = None) -> AggStats:
    """Build the :class:`AggStats` a rule's ``plan`` consumes; only what
    the flags ask for is computed (the norms come free with distances)."""
    leaves = tree_leaves(grads)
    if not leaves:
        raise ValueError("empty gradient tree")
    n = leaves[0].shape[0]
    norms = None
    if needs_dists and dists is None:
        dists, norms = tree_pairwise_stats(grads, use_kernels=use_kernels)
    if needs_norms and norms is None:
        norms = tree_sq_norms(grads)
    return AggStats(n=n, f=f, dists=dists, sq_norms=norms)


# ==========================================================================
# plans
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class AggPlan:
    """Output of a rule's selection phase; ``kind`` picks the apply path
    (``mean``, ``weighted`` (n,) weights, ``coordinate`` (median / trimmed
    mean), ``bulyan`` (θ, n) ``w_ext``/``w_agr`` + β)."""

    kind: str
    n: int
    f: int
    weights: Optional[Tensor] = None
    w_ext: Optional[Tensor] = None
    w_agr: Optional[Tensor] = None
    beta: int = 0

    def selection_weights(self) -> Tensor:
        """Per-worker selection mass as one convex (n,) fp32 vector (bulyan:
        the mean over rounds of the aggregate-weight rows)."""
        if self.kind == "weighted":
            return self.weights.float()
        if self.kind == "bulyan":
            return torch.mean(self.w_agr.float(), dim=0)
        return torch.full((self.n,), 1.0 / self.n, dtype=torch.float32)

    def diagnostics(self, stats: Optional[AggStats] = None
                    ) -> Dict[str, Tensor]:
        """``selection``, ``byz_mass`` (mass on the first f rows) and, with
        distances, ``score_spectrum``, ``score_gap`` and ``mean_dist``."""
        sel = self.selection_weights()
        byz = torch.sum(sel[: self.f]) if self.f else \
            torch.zeros((), dtype=torch.float32, device=sel.device)
        out: Dict[str, Tensor] = {"selection": sel, "byz_mass": byz}
        if stats is not None and stats.dists is not None:
            scores = G.krum_scores(stats.dists, self.f)
            sel = sel.to(scores.device)
            picked = sel > 0.0
            inf = torch.tensor(float("inf"), device=scores.device)
            sel_max = torch.max(torch.where(picked, scores, -inf))
            rej_min = torch.min(torch.where(picked, inf, scores))
            gap = torch.where(torch.all(picked),
                              torch.zeros((), device=scores.device),
                              rej_min - sel_max)
            n = stats.dists.shape[0]
            off = torch.sum(stats.dists) / (n * (n - 1)) if n > 1 else \
                torch.zeros((), dtype=torch.float32, device=scores.device)
            out.update(score_spectrum=torch.sort(scores).values,
                       score_gap=gap.float(), mean_dist=off.float())
        return out


# --------------------------------------------------------------- leaf math
def _weighted_mean_leaf(w: Tensor, leaf: Tensor) -> Tensor:
    """(n,) weights (summing to 1) applied over the worker axis of a leaf."""
    x = leaf.float()
    return torch.tensordot(w.to(x.device), x, dims=([0], [0])).to(leaf.dtype)


def _bulyan_leaf(w_ext: Tensor, w_agr: Tensor, beta: int, leaf: Tensor,
                 use_kernels: bool = False) -> Tensor:
    """Extraction plan + coordinate phase on one leaf.  Under
    ``use_kernels`` every leaf goes through K2 (``kops.fused_select``)."""
    if use_kernels:
        x = _leaf2d(leaf).float().contiguous()
        out = kops.fused_select(x, w_ext.float().contiguous(),
                                w_agr.float().contiguous(), beta)
        return out.reshape(leaf.shape[1:]).to(leaf.dtype)
    x = leaf.float()
    g_ext = torch.tensordot(w_ext, x, dims=([1], [0]))
    g_agr = torch.tensordot(w_agr, x, dims=([1], [0]))
    return G.bulyan_coordinate_phase(g_ext, g_agr, beta).to(leaf.dtype)


# ==========================================================================
# the Aggregator protocol + registry
# ==========================================================================
class Aggregator:
    """Two-phase GAR: ``plan`` on the (n, n) statistics, ``apply`` on d."""

    name: str = ""
    needs_dists: bool = False
    min_n_formula: str = "1"

    @staticmethod
    def min_n(f: int) -> int:
        return 1

    def validate(self, n: int, f: int) -> None:
        theory.check_level(n, f, rule=self.name, need=self.min_n(f),
                           formula=self.min_n_formula)

    def plan(self, stats: AggStats) -> AggPlan:
        raise NotImplementedError

    def apply(self, plan: AggPlan, grads: Tree, *,
              use_kernels: bool = False) -> Tree:
        """Plan application, shared across rules, dispatched on plan.kind."""
        if plan.kind == "mean":
            return tree_map(lambda x: torch.mean(x, dim=0), grads)
        if plan.kind == "weighted":
            return tree_map(lambda x: _weighted_mean_leaf(plan.weights, x),
                            grads)
        if plan.kind == "bulyan":
            return tree_map(lambda x: _bulyan_leaf(
                plan.w_ext, plan.w_agr, plan.beta, x,
                use_kernels=use_kernels), grads)
        if plan.kind == "coordinate":
            return tree_map(lambda x: self._coordinate_leaf(plan, x), grads)
        raise ValueError(f"unknown plan kind {plan.kind!r}")

    def _coordinate_leaf(self, plan: AggPlan, leaf: Tensor) -> Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class AggregatorBackend:
    """One bound stats→validate→plan→apply pipeline (the trainer's)."""

    gar: str
    f: int
    use_kernels: bool = True
    needs_dists: bool = False          # force stats for distance-free rules

    @classmethod
    def for_config(cls, rcfg, **overrides) -> "AggregatorBackend":
        """Build from a ``RobustConfig`` (gar / f / use_kernels)."""
        kw = dict(gar=rcfg.gar, f=rcfg.f, use_kernels=rcfg.use_kernels)
        kw.update(overrides)
        return cls(**kw)

    @property
    def aggregator(self) -> Aggregator:
        return get_aggregator(self.gar)

    def stats(self, grads: Tree, *, dists: Optional[Tensor] = None
              ) -> AggStats:
        return compute_stats(
            grads, self.f,
            needs_dists=self.aggregator.needs_dists or self.needs_dists,
            use_kernels=self.use_kernels, dists=dists)

    def plan(self, stats: AggStats) -> AggPlan:
        """Validate + selection on the statistics only."""
        agg = self.aggregator
        agg.validate(stats.n, stats.f)
        return agg.plan(stats)

    def apply(self, plan: AggPlan, grads: Tree) -> Tree:
        return self.aggregator.apply(plan, grads,
                                     use_kernels=self.use_kernels)


REGISTRY: Dict[str, Aggregator] = {}


def register_gar(cls):
    """Class decorator: instantiate and register a GAR by its ``name``."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"{cls.__name__} must set a registry name")
    if inst.name in REGISTRY:
        raise ValueError(f"GAR {inst.name!r} is already registered "
                         f"({type(REGISTRY[inst.name]).__name__})")
    REGISTRY[inst.name] = inst
    return cls


def get_aggregator(name: str) -> Aggregator:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown GAR {name!r}; available: "
                       f"{sorted(REGISTRY)}") from None


def available_gars() -> Tuple[str, ...]:
    return tuple(sorted(REGISTRY))


# ==========================================================================
# the seven rules
# ==========================================================================
@register_gar
class Average(Aggregator):
    """Plain averaging — fastest, non-byzantine-resilient baseline."""

    name = "average"

    def plan(self, stats: AggStats) -> AggPlan:
        return AggPlan(kind="mean", n=stats.n, f=stats.f)


@register_gar
class CoordinateMedian(Aggregator):
    """Coordinate-wise median (the MEDIAN baseline of §V)."""

    name = "median"

    def plan(self, stats: AggStats) -> AggPlan:
        return AggPlan(kind="coordinate", n=stats.n, f=stats.f)

    def _coordinate_leaf(self, plan: AggPlan, leaf: Tensor) -> Tensor:
        return G._median_axis0(leaf.float()).to(leaf.dtype)


@register_gar
class TrimmedMean(Aggregator):
    """Coordinate-wise trimmed mean: drop the f largest and f smallest."""

    name = "trimmed_mean"
    min_n_formula = "2f+1"

    @staticmethod
    def min_n(f: int) -> int:
        return 2 * f + 1

    def plan(self, stats: AggStats) -> AggPlan:
        if stats.n <= 2 * stats.f:
            raise ValueError(
                f"trimmed_mean needs n > 2f (n={stats.n}, f={stats.f})")
        return AggPlan(kind="coordinate", n=stats.n, f=stats.f)

    def _coordinate_leaf(self, plan: AggPlan, leaf: Tensor) -> Tensor:
        s = torch.sort(leaf.float(), dim=0).values
        return torch.mean(s[plan.f:plan.n - plan.f], dim=0).to(leaf.dtype)


class _KrumFamily(Aggregator):
    needs_dists = True
    min_n_formula = "2f+3"
    _m_select: Optional[int] = None       # None -> the paper's m̃ = n-f-2

    @staticmethod
    def min_n(f: int) -> int:
        return 2 * f + 3

    def plan(self, stats: AggStats) -> AggPlan:
        n, f = stats.n, stats.f
        self.validate(n, f)
        m = self._m_select if self._m_select is not None else n - f - 2
        scores = G.krum_scores(stats.dists, f).detach()
        w = G._select_smallest_mask(scores, m).float()
        return AggPlan(kind="weighted", n=n, f=f, weights=w / torch.sum(w))


@register_gar
class Krum(_KrumFamily):
    """Krum (Blanchard et al. 2017): the single best-scored gradient."""

    name = "krum"
    _m_select = 1


@register_gar
class MultiKrum(_KrumFamily):
    """MULTI-KRUM (§III): average of the m̃ = n-f-2 best-scored."""

    name = "multi_krum"


class _BulyanFamily(Aggregator):
    needs_dists = True
    min_n_formula = "4f+3"
    _multi = True

    @staticmethod
    def min_n(f: int) -> int:
        return 4 * f + 3

    def plan(self, stats: AggStats) -> AggPlan:
        n, f = stats.n, stats.f
        self.validate(n, f)
        theta = n - 2 * f - 2
        beta = theta - 2 * f
        w_ext, w_agr = G.extraction_plan(stats.dists, f, theta,
                                         multi=self._multi)
        return AggPlan(kind="bulyan", n=n, f=f, w_ext=w_ext, w_agr=w_agr,
                       beta=beta)


@register_gar
class Bulyan(_BulyanFamily):
    """Classic BULYAN: iterated Krum extraction + coordinate phase."""

    name = "bulyan"
    _multi = False


@register_gar
class MultiBulyan(_BulyanFamily):
    """MULTI-BULYAN (Algorithm 1): BULYAN over MULTI-KRUM aggregates."""

    name = "multi_bulyan"


# ==========================================================================
# high-level entry points
# ==========================================================================
def aggregate_tree(grads: Tree, f: int, name: str = "multi_bulyan", *,
                   use_kernels: bool = False,
                   dists: Optional[Tensor] = None) -> Tree:
    """Aggregate a stacked gradient tree with the named registered rule."""
    agg = get_aggregator(name)
    stats = compute_stats(grads, f, needs_dists=agg.needs_dists,
                          use_kernels=use_kernels, dists=dists)
    agg.validate(stats.n, stats.f)
    return agg.apply(agg.plan(stats), grads, use_kernels=use_kernels)


def aggregate_matrix(Gm: Tensor, f: int, name: str = "multi_bulyan", *,
                     use_kernels: bool = False,
                     dists: Optional[Tensor] = None) -> Tensor:
    """(n, d) stack -> (d,) aggregate: the single-leaf special case."""
    return aggregate_tree(Gm, f, name, use_kernels=use_kernels, dists=dists)
