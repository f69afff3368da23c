"""Plan/apply aggregation API, single-device subset (cf. ``repro.core.api``).

* ``plan(stats)`` runs on the replicated ``(n, n)`` squared-distance matrix
  and per-worker norms only: O(n²·θ) scalar work, no touch of the d axis.
* ``apply(plan, grads)`` runs the per-leaf contractions and the coordinate
  phase over d.

Every GAR is an :class:`Aggregator` registered by name with capability
flags (``needs_dists``, ``min_n``).  Under ``use_kernels`` the statistics
go through ``kernels.ops.pairwise_stats`` (K1) once per leaf and every
bulyan leaf through ``kernels.ops.fused_select`` (K2), or, on the two-step
substrate (``fused=False`` or ``coord_chunk``), through two matrix
products and ``kernels.ops.coord_select`` (K3): the CUDA kernels for CUDA
tensors, their plain versions for CPU tensors.

Gradient trees are nested dicts whose leaves carry the worker axis first;
leaves are visited in sorted key-path order (``repro_torch.tree``), as JAX
flattens them, so cross-leaf fp32 sums associate as in the reference.

The statistics and the apply accept a ``repro_torch.comm``
:class:`EncodedGrads` wire container in place of the tree: statistics then
run on the payloads (K5 under ``use_kernels`` for the int8 / bf16 leaves),
and the apply decodes first.  The pre-aggregation transforms (worker
momentum, clipping, nearest-neighbour mixing) rewrite the stack before the
rule.

With a :class:`MeshContext` the statistics and the apply run mesh-native
on a ``torch.distributed`` ``DeviceMesh`` (the JAX package's DESIGN.md
§10): each rank passes its :class:`RowBlock` of the stack.  The
statistics compute only the rank's rows of the (n, n) matrix (K6 / K7
under ``use_kernels``), gathered into the replicated statistics every
rank's plan needs; the apply gathers the rank's (n_pad, d/M) column tile
of each leaf over the worker group, applies the plan to it (K2, or the
products and K3, under ``use_kernels``) and gathers the tiles' results
over the model group, so every rank returns the whole aggregate.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.comm.container import EncodedGrads
from repro_torch.core import attacks as ATK
from repro_torch.core import gar as G
from repro_torch.core import theory
from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

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


def _as_encoded(grads: Tree) -> Optional[EncodedGrads]:
    """The wire container, or None for a plain tree."""
    return grads if isinstance(grads, EncodedGrads) else None


def finalize_dists(total: Tensor) -> Tensor:
    """Numerical floor + exact-zero diagonal on an accumulated (n, n) sum
    (NaN propagates through the floor, as ``jnp.maximum`` does)."""
    total = torch.maximum(total, torch.zeros_like(total))
    n = total.shape[0]
    return total * (1.0 - torch.eye(n, dtype=total.dtype,
                                    device=total.device))


def raw_pairwise_stats(grads: Tree, *, use_kernels: bool = False,
                       mesh_ctx: Optional["MeshContext"] = None
                       ) -> Tuple[Tensor, Tensor]:
    """(raw (n, n) sq-dists, (n,) sq-norms) summed over the leaves in
    sorted key-path order; unclamped, diagonal kept.  Under
    ``use_kernels`` each leaf is one K1 launch (one read of the leaf); a
    wire container's int8 / bf16 leaves are one K5 launch each.  With
    ``mesh_ctx``, ``grads`` is this rank's :class:`RowBlock` and the pass
    is :func:`sharded_raw_stats`."""
    if mesh_ctx is not None:
        return sharded_raw_stats(grads, mesh_ctx=mesh_ctx,
                                 use_kernels=use_kernels)
    enc = _as_encoded(grads)
    if enc is not None:
        from repro_torch.comm import codecs as CC
        return CC.encoded_raw_stats(enc, use_kernels=use_kernels)
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


def tree_pairwise_sqdist(grads: Tree, *, use_kernels: bool = False
                         ) -> Tensor:
    """Sum of per-leaf pairwise squared distances -> finalised (n, n)."""
    return tree_pairwise_stats(grads, use_kernels=use_kernels)[0]


def tree_pairwise_stats(grads: Tree, *, use_kernels: bool = False,
                        mesh_ctx: Optional["MeshContext"] = None
                        ) -> Tuple[Tensor, Tensor]:
    """Single pass over the stack: (finalised (n, n) sq-dists, (n,) norms);
    mesh-native with ``mesh_ctx`` (:func:`raw_pairwise_stats`)."""
    total_d, total_s = raw_pairwise_stats(grads, use_kernels=use_kernels,
                                          mesh_ctx=mesh_ctx)
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
                  dists: Optional[Tensor] = None,
                  mesh_ctx: Optional["MeshContext"] = None) -> AggStats:
    """Build the :class:`AggStats` a rule's ``plan`` consumes; only what
    the flags ask for is computed (the norms come free with distances).
    ``grads`` may be a wire container: the statistics then run on its
    payloads, without decoding the stack here.

    With ``mesh_ctx`` the statistics run mesh-native: ``grads`` is this
    rank's :class:`RowBlock` (of a tree or a wire container, cut by
    :func:`row_block`), every rank computes its rows of the (n, n) matrix
    (:func:`sharded_raw_stats`), and every rank gets the same replicated
    statistics.  Norms alone are each rank's row sums, gathered."""
    if mesh_ctx is not None:
        block = _row_block_arg(grads)
        norms = None
        if needs_dists and dists is None:
            raw, norms = sharded_raw_stats(block, mesh_ctx=mesh_ctx,
                                           use_kernels=use_kernels)
            dists = finalize_dists(raw)
        if needs_norms and norms is None:
            if _as_encoded(block.rows) is not None:
                norms = sharded_raw_stats(block, mesh_ctx=mesh_ctx,
                                          use_kernels=use_kernels)[1]
            else:
                norms = _gather_rows(tree_sq_norms(block.rows),
                                     mesh_ctx)[:block.n]
        return AggStats(n=block.n, f=f, dists=dists, sq_norms=norms)
    enc = _as_encoded(grads)
    if enc is not None:
        norms = None
        if needs_dists and dists is None:
            dists, norms = tree_pairwise_stats(enc, use_kernels=use_kernels)
        if needs_norms and norms is None:
            norms = raw_pairwise_stats(enc, use_kernels=use_kernels)[1]
        return AggStats(n=enc.n, f=f, dists=dists, sq_norms=norms)
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
# mesh-native statistics (cf. the JAX package's DESIGN.md §10)
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class MeshContext:
    """Where the mesh-native statistics run: a ``torch.distributed``
    ``DeviceMesh`` (``launch.mesh.make_host_mesh``), the mesh axes that
    carry the byzantine worker dimension (``("pod", "data")`` multi-pod,
    ``("data",)`` single-pod) and the tensor-parallel axis (``None``: no
    d-sharding).  It holds one process group over the worker axes and one
    over the model axis, made at first use: every rank must reach them
    in the same order, as it reaches any collective."""

    mesh: Any
    worker_axes: Tuple[str, ...] = ("data",)
    model_axis: Optional[str] = "model"

    @classmethod
    def for_mesh(cls, mesh, worker_axes: Optional[Sequence[str]] = None
                 ) -> "MeshContext":
        """Derive the canonical context from a mesh's axis names."""
        names = tuple(mesh.mesh_dim_names)
        if worker_axes is None:
            worker_axes = ("pod", "data") if "pod" in names else ("data",)
        missing = [a for a in worker_axes if a not in names]
        if missing:
            raise ValueError(
                f"worker axes {missing} not in mesh axes {names}")
        return cls(mesh=mesh, worker_axes=tuple(worker_axes),
                   model_axis="model" if "model" in names else None)

    @property
    def _sizes(self) -> Dict[str, int]:
        return dict(zip(self.mesh.mesh_dim_names,
                        (int(s) for s in self.mesh.shape)))

    @property
    def worker_size(self) -> int:
        return math.prod(self._sizes[a] for a in self.worker_axes)

    @property
    def model_size(self) -> int:
        return self._sizes[self.model_axis] \
            if self.model_axis is not None else 1

    @property
    def worker_index(self) -> int:
        """Flat index of this rank's worker shard, pod-major (the JAX
        package's ``_worker_index``)."""
        idx = 0
        for a in self.worker_axes:
            idx = idx * self._sizes[a] + self.mesh.get_local_rank(a)
        return idx

    @property
    def model_index(self) -> int:
        return self.mesh.get_local_rank(self.model_axis) \
            if self.model_axis is not None else 0

    @functools.cached_property
    def worker_group(self):
        """The process group of the ranks that share this rank's model
        coordinate, in worker order."""
        if len(self.worker_axes) == 1:
            return self.mesh.get_group(self.worker_axes[0])
        names = list(self.mesh.mesh_dim_names)
        keep = [names.index(a) for a in self.worker_axes]
        rest = [i for i in range(len(names)) if i not in keep]
        ranks = self.mesh.mesh.permute(*rest, *keep).reshape(
            -1, self.worker_size).tolist()
        return dist.new_subgroups_by_enumeration(ranks)[0]

    @functools.cached_property
    def model_group(self):
        return self.mesh.get_group(self.model_axis) \
            if self.model_axis is not None else None


@dataclasses.dataclass(frozen=True)
class RowBlock:
    """One mesh rank's share of a stacked gradient tree or a wire
    container: ``rows`` holds its n_loc = ceil(n / W) worker rows (rows
    past the n-th are zeros), ``n`` the true worker count."""

    rows: Tree
    n: int


def worker_rows(n: int, ctx: MeshContext) -> Tuple[int, int]:
    """(first row, n_loc) of this rank's block: the worker axis zero-padded
    to n_pad = W ceil(n / W) rows, cut into W blocks."""
    n_loc = -(-n // ctx.worker_size)
    return ctx.worker_index * n_loc, n_loc


def _pad_rows(x: Tensor, n_pad: int) -> Tensor:
    if x.shape[0] == n_pad:
        return x
    pad = x.new_zeros((n_pad - x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat([x, pad])


def row_block(grads: Tree, ctx: MeshContext) -> RowBlock:
    """This rank's :class:`RowBlock` of a stacked tree or wire container
    (payload and sidecar rows cut alike, the container's byte count
    re-derived for its rows): the torch counterpart of the worker axis of
    ``repro.dist.sharding.grad_stack_specs``."""
    enc = _as_encoded(grads)
    leaves = tree_leaves(enc.payload if enc is not None else grads)
    if not leaves:
        raise ValueError("empty gradient tree")
    n = enc.n if enc is not None else leaves[0].shape[0]
    start, n_loc = worker_rows(n, ctx)

    def cut(x):
        if x.shape[0] != n:
            raise ValueError("all leaves must share the worker axis size")
        return _pad_rows(x[start:start + n_loc], n_loc)

    if enc is None:
        return RowBlock(rows=tree_map(cut, grads), n=n)
    from repro_torch.comm import codecs as CC
    shapes = tuple((n_loc,) + tuple(s[1:]) for s in enc.shapes)
    rows = EncodedGrads(
        payload=tree_map(cut, enc.payload),
        sidecar=None if enc.sidecar is None else tree_map(cut, enc.sidecar),
        spec=enc.spec, n=n_loc, shapes=shapes,
        wire_bytes=sum(CC.get_codec(enc.spec).leaf_wire_bytes(s)
                       for s in shapes))
    return RowBlock(rows=rows, n=n)


def column_tile(block: RowBlock, ctx: MeshContext) -> RowBlock:
    """The (n_loc, d/M) column tile of every leaf of a tree's row block,
    each leaf flattened and zero-padded to a multiple of M columns: the
    input of :func:`sharded_raw_stats_model_axis` (the model axis of
    ``grad_stack_specs``)."""
    return RowBlock(rows=tree_map(lambda x: _tile2d(_leaf2d(x), ctx),
                                  block.rows), n=block.n)


def _tile2d(x2: Tensor, ctx: MeshContext) -> Tensor:
    """This rank's contiguous (rows, m) column tile of (rows, numel) rows,
    zero-padded to M m columns, m = ceil(numel / M); at M = 1 a contiguous
    ``x2`` itself, with no copy."""
    M, k = ctx.model_size, ctx.model_index
    m = -(-x2.shape[1] // M)
    if M * m != x2.shape[1]:
        x2 = torch.nn.functional.pad(x2, (0, M * m - x2.shape[1]))
    return x2[:, k * m:(k + 1) * m].contiguous()


def _row_block_arg(grads) -> RowBlock:
    if not isinstance(grads, RowBlock):
        raise TypeError(f"the mesh-native path takes this rank's RowBlock "
                        f"(core.api.row_block), got {type(grads).__name__}")
    return grads


def _all_gather(x: Tensor, group, size: int) -> Tensor:
    """Every group member's ``x`` stacked along axis 0 in group-rank
    order (one all-gather)."""
    x = x.contiguous()
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    # newer torch names it all_gather_single and warns on the old name
    # (2.13 does); older releases have only all_gather_into_tensor (2.11)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x, group=group)
    return out


def _gather_rows(x: Tensor, ctx: MeshContext) -> Tensor:
    """Every worker shard's rows of ``x``, stacked in worker order (one
    all-gather over the worker group)."""
    return _all_gather(x, ctx.worker_group, ctx.worker_size)


def _block_stats_contrib(x_loc: Tensor, x_full: Tensor
                         ) -> Tuple[Tensor, Tensor]:
    """Row-block partial of :func:`_leaf_stats_contrib`: the raw (n_loc, n)
    block of ``x_loc``'s rows against the stack ``x_full`` and the stack's
    (n,) norms, from those two alone (O(n_loc n d) work).  The plain
    formula in fp32: BLAS may sum a row subset in another order than the
    whole product, so the block is close to, not bitwise, the replicated
    rows (K6 is bitwise to K1's)."""
    xl = _leaf2d(x_loc).float()
    xf = _leaf2d(x_full).float()
    sq_full = torch.sum(xf * xf, dim=1)
    sq_loc = torch.sum(xl * xl, dim=1)
    gram = xl @ xf.T
    return sq_loc[:, None] + sq_full[None, :] - 2.0 * gram, sq_full


def _assemble(total_d: Tensor, total_s: Tensor, n: int, ctx: MeshContext
              ) -> Tuple[Tensor, Tensor]:
    """The rank blocks gathered into the replicated (n, n) and (n,)."""
    return _gather_rows(total_d, ctx)[:n, :n].contiguous(), total_s[:n]


def sharded_raw_stats(grads: RowBlock, *, mesh_ctx: MeshContext,
                      use_kernels: bool = False) -> Tuple[Tensor, Tensor]:
    """Mesh-native single pass: (raw (n, n) sq-dists, (n,) sq-norms), the
    same on every rank.

    ``grads`` is this rank's :class:`RowBlock` of a tree or a wire
    container.  Leaf by leaf, in sorted key-path order, the rank gathers
    the leaf's rows over the worker group, computes its (n_loc, n_pad)
    block of the leaf's contribution (its rows are a view of the gathered
    stack) and adds it to its running block: under ``use_kernels`` K6
    (``kops.pairwise_stats_rect``) for a tree leaf, K7 or K6 for a wire
    leaf (``comm.codecs.encoded_leaf_block_contrib``), otherwise the plain
    block formula (:func:`_block_stats_contrib`; a wire leaf is decoded
    first).  The blocks are then gathered and the padding sliced away.
    The kernels take K1's chunk count for the true n, so each block is
    K1's (K5's) matching rows bit for bit and the result is the
    replicated kernel path's bit for bit.
    """
    block = _row_block_arg(grads)
    return _assemble(*_local_block(block, mesh_ctx, use_kernels), block.n,
                     mesh_ctx)


def sharded_raw_stats_model_axis(grads: RowBlock, *, mesh_ctx: MeshContext,
                                 use_kernels: bool = False
                                 ) -> Tuple[Tensor, Tensor]:
    """Model-axis-sharded single pass: raw ((n, n) sq-dists, (n,) norms)
    from (n_loc, d/M) leaf tiles (:func:`column_tile`).

    Each rank gathers only its column tile's worker rows, computes the
    rectangular block on the (n_loc, d/M) x (n_pad, d/M) tile pair (K6
    under ``use_kernels``), and the partial blocks are summed over the
    model group before the blocks are gathered.  The model-axis sum is
    another summation order than the full-d contraction, so the result
    equals :func:`sharded_raw_stats` bit for bit at M = 1 and to about
    1e-6 at M > 1, as in the JAX package."""
    block = _row_block_arg(grads)
    total_d, total_s = _local_block(block, mesh_ctx, use_kernels)
    if mesh_ctx.model_group is not None:
        dist.all_reduce(total_d, group=mesh_ctx.model_group)
        dist.all_reduce(total_s, group=mesh_ctx.model_group)
    return _assemble(total_d, total_s, block.n, mesh_ctx)


def _local_block(block: RowBlock, ctx: MeshContext, use_kernels: bool
                 ) -> Tuple[Tensor, Tensor]:
    """This rank's raw (n_loc, n_pad) block and the (n_pad,) norms, summed
    over the leaves of ``block`` (:func:`sharded_raw_stats`)."""
    n = block.n
    start, n_loc = worker_rows(n, ctx)
    n_pad = n_loc * ctx.worker_size
    enc = _as_encoded(block.rows)
    if enc is not None:
        from repro_torch.comm import codecs as CC
        codec = CC.get_codec(enc.spec)
        items = list(zip(tree_leaves(enc.payload), CC.sidecar_leaves(enc),
                         enc.shapes))
    else:
        items = [(x, None, None) for x in tree_leaves(block.rows)]
    if not items:
        raise ValueError("empty gradient tree")
    dev = items[0][0].device
    total_d = torch.zeros((n_loc, n_pad), dtype=torch.float32, device=dev)
    total_s = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
    rows = slice(start, start + n_loc)
    for x, s, shape in items:
        if x.shape[0] != n_loc:
            raise ValueError(f"a row block of {n} workers on "
                             f"{ctx.worker_size} worker shards has {n_loc} "
                             f"rows, got {x.shape[0]}")
        full = _gather_rows(x, ctx)
        if enc is not None:
            s_full = None if s is None else _gather_rows(s, ctx)
            shape = (n_pad,) + tuple(shape[1:])
            if use_kernels:
                dd, sq = CC.encoded_leaf_block_contrib(
                    codec, full, s_full, shape, row_start=start,
                    n_loc=n_loc, n=n)
            else:
                g = codec.decode_leaf(full, s_full, shape)
                dd, sq = _block_stats_contrib(g[rows], g)
        elif use_kernels:
            full = _leaf2d(full).float().contiguous()
            dd, sq = kops.pairwise_stats_rect(full[rows], full, n=n)
        else:
            dd, sq = _block_stats_contrib(full[rows], full)
        total_d = total_d + dd
        total_s = total_s + sq
    return total_d, total_s


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
                 coord_chunk: int = 0, use_kernels: bool = False,
                 fused: "bool | str" = True) -> Tensor:
    """Extraction plan + coordinate phase on one leaf.

    * ``use_kernels`` and ``fused`` (True or ``"force"``): one K2 launch
      (``kops.fused_select``), with no (θ, numel) intermediate.  The JAX
      package's measured crossover table (``repro.kernels.dispatch``) is
      not ported: it was read from CPU interpret-mode timings, so every
      leaf takes the kernel.
    * ``use_kernels`` without ``fused``, or a ``coord_chunk``: the
      two-step substrate on the (n, numel) fp32 view — the two
      contractions as plain matrix products (full fp32 on the card:
      ``torch.backends.cuda.matmul.allow_tf32`` is off by default), then
      the coordinate phase, K3 (``kops.coord_select``) under
      ``use_kernels``.  With ``coord_chunk`` the columns go in
      slices of that width (the last one shorter), one K3 launch each;
      columns are independent, so the slices give what JAX's zero-padded
      ``lax.map`` gives.
    * otherwise the contractions as tensordots over the leaf.
    """
    if use_kernels and fused:
        x = _leaf2d(leaf).float().contiguous()
        out = kops.fused_select(x, w_ext.float().contiguous(),
                                w_agr.float().contiguous(), beta)
        return out.reshape(leaf.shape[1:]).to(leaf.dtype)
    if use_kernels or coord_chunk:
        x = _leaf2d(leaf).float()
        we, wa = w_ext.float(), w_agr.float()

        def phase(xc: Tensor) -> Tensor:              # (n, c) -> (c,)
            g_ext = torch.matmul(we, xc)
            g_agr = torch.matmul(wa, xc)
            if use_kernels:
                return kops.coord_select(g_ext, g_agr, beta)
            return G.bulyan_coordinate_phase(g_ext, g_agr, beta)

        numel = x.shape[1]
        if coord_chunk and numel > coord_chunk:
            out = torch.cat([phase(x[:, c0:c0 + coord_chunk])
                             for c0 in range(0, numel, coord_chunk)])
        else:
            out = phase(x)
        return out.reshape(leaf.shape[1:]).to(leaf.dtype)
    x = leaf.float()
    g_ext = torch.tensordot(w_ext, x, dims=([1], [0]))
    g_agr = torch.tensordot(w_agr, x, dims=([1], [0]))
    return G.bulyan_coordinate_phase(g_ext, g_agr, beta).to(leaf.dtype)


def _pad_cols(w: Tensor, n_pad: int) -> Tensor:
    """fp32 weights over the worker axis (last), zero-padded to n_pad."""
    w = w.float()
    return torch.nn.functional.pad(w, (0, n_pad - w.shape[-1]))


def _sharded_apply_leaf(plan: AggPlan, x_loc: Tensor, ctx: MeshContext,
                        coordinate_fn=None, *, use_kernels: bool = False,
                        fused: "bool | str" = True,
                        row_mult: Optional[Tensor] = None) -> Tensor:
    """Mesh-native apply of one plan to this rank's rows of one leaf
    (the JAX package's DESIGN.md §10): the (numel,) fp32 aggregate, the
    same on every rank.

    The rank takes the column tile of its (n_loc, numel) rows that its
    model index owns (zero-padded to M ceil(numel / M) columns, as
    :func:`column_tile` cuts it) and gathers it over the worker group
    into the (n_pad, d/M) tile of the stack, the one worker-to-model
    reshard of the pipeline: no rank holds more than that of the leaf.
    The plan runs on the tile, and the (d/M,) results are gathered over
    the model group in model-index order.  Per plan kind: ``mean`` sums
    the rows over n; ``weighted`` and ``bulyan`` take their weights
    zero-padded to n_pad (a zero row adds 0 x 0 to every contraction),
    ``bulyan`` under ``use_kernels`` one K2 launch on the tile with
    ``fused``, else two matrix products and one K3 launch; ``coordinate``
    (median, trimmed mean) takes the tile's first n rows, since zero
    padding must never enter an order statistic.

    With ``row_mult`` the rows are a wire payload (int8 / bf16) and
    ``row_mult`` its (n_loc,) fp32 dequant multipliers, gathered beside
    the tile: the gathered tile is dequantised as the codec's decode
    does it (``comm.codecs._scaled_rows``: widen, one rounded multiply),
    so its fp32 values are the decode's bit for bit.
    """
    n, kind = plan.n, plan.kind
    if kind not in ("mean", "weighted", "bulyan", "coordinate"):
        raise ValueError(f"unknown plan kind {kind!r}")
    _, n_loc = worker_rows(n, ctx)
    x2 = _leaf2d(x_loc)
    if x2.shape[0] != n_loc:
        raise ValueError(f"a row block of {n} workers on {ctx.worker_size} "
                         f"worker shards has {n_loc} rows, got "
                         f"{x2.shape[0]}")
    numel = x2.shape[1]
    if row_mult is None:
        x2 = x2.float()
    full = _gather_rows(_tile2d(x2, ctx), ctx)              # (n_pad, m)
    if row_mult is not None:
        mult = _gather_rows(row_mult.float(), ctx)
        full = full.float() * mult[:, None]
    n_pad = full.shape[0]
    if kind == "coordinate":
        out = coordinate_fn(plan, full[:n])
    elif kind == "mean":
        out = torch.sum(full, dim=0) / n
    elif kind == "weighted":
        out = _weighted_mean_leaf(_pad_cols(plan.weights, n_pad), full)
    else:
        out = _bulyan_leaf(_pad_cols(plan.w_ext, n_pad),
                           _pad_cols(plan.w_agr, n_pad), plan.beta, full,
                           use_kernels=use_kernels, fused=fused)
    if ctx.model_group is not None:
        out = _all_gather(out, ctx.model_group, ctx.model_size)
    return out[:numel]


def _sharded_apply_encoded(plan: AggPlan, enc: EncodedGrads,
                           ctx: MeshContext, coordinate_fn=None, *,
                           use_kernels: bool = False,
                           fused: "bool | str" = True) -> Tree:
    """Mesh-native apply of one plan to this rank's rows of a wire
    container: fp32 leaves of the original shapes.  A leaf whose codec has
    the dequant form (``Codec.dequant_form``: int8 / bf16 payload x one
    multiplier a row) gathers its payload tile and multipliers and
    dequantises per tile, so no rank decodes more than (n_pad, d/M) of it;
    top-k and identity leaves decode the rank's rows first."""
    from repro_torch.comm import codecs as CC
    codec = CC.get_codec(enc.spec)
    out = []
    for p, s, shape in zip(tree_leaves(enc.payload), CC.sidecar_leaves(enc),
                           enc.shapes):
        form = codec.dequant_form(p, s)
        if form is not None:
            rows, mult = form
            o = _sharded_apply_leaf(plan, rows, ctx, coordinate_fn,
                                    use_kernels=use_kernels, fused=fused,
                                    row_mult=mult)
        else:
            o = _sharded_apply_leaf(plan, codec.decode_leaf(p, s, shape),
                                    ctx, coordinate_fn,
                                    use_kernels=use_kernels, fused=fused)
        out.append(o.reshape(tuple(shape[1:])))
    return tree_unflatten(enc.payload, out)


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

    def apply(self, plan: AggPlan, grads: Tree, *, coord_chunk: int = 0,
              use_kernels: bool = False, fused: "bool | str" = True,
              mesh_ctx: Optional[MeshContext] = None) -> Tree:
        """Plan application, shared across rules, dispatched on plan.kind.
        A wire container is decoded first: the apply mixes values across
        workers, so it runs on the decoded fp32 rows.  ``coord_chunk`` and
        ``fused`` pick a bulyan plan's substrate (:func:`_bulyan_leaf`).

        With ``mesh_ctx`` the apply runs mesh-native: ``grads`` is this
        rank's :class:`RowBlock` of a tree or a wire container, each rank
        applies the plan to its column tile of every leaf
        (:func:`_sharded_apply_leaf`, in sorted key-path order, so every
        rank reaches the collectives in the same order; a wire leaf with
        the dequant form is dequantised per tile,
        :func:`_sharded_apply_encoded`), and every rank returns the whole
        aggregate.  ``coord_chunk`` has no meaning there: each rank's tile
        is one piece already."""
        if mesh_ctx is not None:
            block = _row_block_arg(grads)
            if block.n != plan.n:
                raise ValueError(f"the plan is for n={plan.n} workers, the "
                                 f"row block for n={block.n}")
            kw = dict(coordinate_fn=self._coordinate_leaf,
                      use_kernels=use_kernels, fused=fused)
            enc = _as_encoded(block.rows)
            if enc is not None:
                return _sharded_apply_encoded(plan, enc, mesh_ctx, **kw)
            return tree_map(lambda x: _sharded_apply_leaf(
                plan, x, mesh_ctx, **kw).reshape(tuple(x.shape[1:])).to(
                    x.dtype), block.rows)
        enc = _as_encoded(grads)
        if enc is not None:
            from repro_torch.comm import codecs as CC
            grads = CC.get_codec(enc.spec).decode(enc)
        if plan.kind == "mean":
            return tree_map(lambda x: torch.mean(x, dim=0), grads)
        if plan.kind == "weighted":
            return tree_map(lambda x: _weighted_mean_leaf(plan.weights, x),
                            grads)
        if plan.kind == "bulyan":
            return tree_map(lambda x: _bulyan_leaf(
                plan.w_ext, plan.w_agr, plan.beta, x, coord_chunk=coord_chunk,
                use_kernels=use_kernels, fused=fused), grads)
        if plan.kind == "coordinate":
            return tree_map(lambda x: self._coordinate_leaf(plan, x), grads)
        raise ValueError(f"unknown plan kind {plan.kind!r}")

    def _coordinate_leaf(self, plan: AggPlan, leaf: Tensor) -> Tensor:
        raise NotImplementedError

    def __call__(self, grads: Tree, f: int, *, dists: Optional[Tensor] = None,
                 coord_chunk: int = 0, use_kernels: bool = False,
                 mesh_ctx: Optional[MeshContext] = None) -> Tree:
        """stats -> validate -> plan -> apply in one call (mesh-native
        with ``mesh_ctx``: ``grads`` is this rank's :class:`RowBlock`)."""
        stats = compute_stats(grads, f, needs_dists=self.needs_dists,
                              use_kernels=use_kernels, dists=dists,
                              mesh_ctx=mesh_ctx)
        self.validate(stats.n, stats.f)
        return self.apply(self.plan(stats), grads, coord_chunk=coord_chunk,
                          use_kernels=use_kernels, mesh_ctx=mesh_ctx)


@dataclasses.dataclass(frozen=True)
class AggregatorBackend:
    """One bound stats→validate→plan→apply pipeline, shared by the trainers
    and the robust serving ensemble (``dist.serving``).  With ``mesh_ctx`` the statistics and the apply run mesh-native: both
    then take this rank's :class:`RowBlock`."""

    gar: str
    f: int
    use_kernels: bool = True
    coord_chunk: int = 0
    fused: "bool | str" = True
    needs_dists: bool = False          # force stats for distance-free rules
    mesh_ctx: Optional[MeshContext] = None
    # the observability switchboard (obs.ObsConfig): every consumer of a
    # backend (trainers, async service) reads the same config, so
    # instrumentation cannot half-apply; None keeps them uninstrumented
    obs: Optional[Any] = None

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
            use_kernels=self.use_kernels, dists=dists,
            mesh_ctx=self.mesh_ctx)

    def plan(self, stats: AggStats) -> AggPlan:
        """Validate + selection on the statistics only."""
        agg = self.aggregator
        agg.validate(stats.n, stats.f)
        return agg.plan(stats)

    def plan_stats(self, grads: Tree, *, dists: Optional[Tensor] = None
                   ) -> Tuple[AggPlan, AggStats]:
        stats = self.stats(grads, dists=dists)
        return self.plan(stats), stats

    def apply(self, plan: AggPlan, grads: Tree) -> Tree:
        return self.aggregator.apply(plan, grads,
                                     coord_chunk=self.coord_chunk,
                                     use_kernels=self.use_kernels,
                                     fused=self.fused,
                                     mesh_ctx=self.mesh_ctx)

    def __call__(self, grads: Tree) -> Tree:
        """stats -> plan -> apply (the serving ensemble's fusion)."""
        plan, _ = self.plan_stats(grads)
        return self.apply(plan, grads)


def select_plan(pred: Tensor, on_true: AggPlan, on_false: AggPlan
                ) -> AggPlan:
    """``pred ? on_true : on_false`` over the data tensors (``weights``,
    ``w_ext``, ``w_agr``) of two plans of one kind, by ``torch.where``:
    ``pred`` is a 0-d bool tensor that is never read on the host, so the
    async service degrades an inadmissible round to the previous round's
    plan without a synchronisation.  The meta fields (kind, n, f, beta)
    must match, as they do for two plans of one backend."""
    meta = ("kind", "n", "f", "beta")
    if any(getattr(on_true, m) != getattr(on_false, m) for m in meta):
        raise ValueError(
            "select_plan needs two plans of one kind: "
            + ", ".join(f"{m}={getattr(on_true, m)!r}/"
                        f"{getattr(on_false, m)!r}" for m in meta))

    def pick(a, b):
        return None if a is None else torch.where(pred.to(a.device), a, b)

    return dataclasses.replace(
        on_true, **{k: pick(getattr(on_true, k), getattr(on_false, k))
                    for k in ("weights", "w_ext", "w_agr")})


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
                   coord_chunk: int = 0, use_kernels: bool = False,
                   fused: "bool | str" = True,
                   dists: Optional[Tensor] = None,
                   mesh_ctx: Optional[MeshContext] = None) -> Tree:
    """Aggregate a stacked gradient tree with the named registered rule;
    mesh-native with ``mesh_ctx``, where ``grads`` is this rank's
    :class:`RowBlock` and every rank returns the whole aggregate."""
    agg = get_aggregator(name)
    stats = compute_stats(grads, f, needs_dists=agg.needs_dists,
                          use_kernels=use_kernels, dists=dists,
                          mesh_ctx=mesh_ctx)
    agg.validate(stats.n, stats.f)
    return agg.apply(agg.plan(stats), grads, coord_chunk=coord_chunk,
                     use_kernels=use_kernels, fused=fused, mesh_ctx=mesh_ctx)


def aggregate_matrix(Gm: Tensor, f: int, name: str = "multi_bulyan", *,
                     coord_chunk: int = 0, use_kernels: bool = False,
                     fused: "bool | str" = True,
                     dists: Optional[Tensor] = None) -> Tensor:
    """(n, d) stack -> (d,) aggregate: the single-leaf special case."""
    return aggregate_tree(Gm, f, name, coord_chunk=coord_chunk,
                          use_kernels=use_kernels, fused=fused, dists=dists)


# ==========================================================================
# pre-aggregation transforms
# ==========================================================================
class Transform:
    """A composable stage rewriting the stacked gradients before the GAR.

    ``stateful`` transforms carry a per-worker state tree across steps
    (see :func:`init_transform_states`); ``needs_dists`` ones receive an
    :class:`AggStats` with the distance matrix of the *current* stack.
    Signature: ``(grads, stats=None, state=None, seed=None) -> (grads,
    state)``; ``seed`` is the counterpart of the JAX package's ``key``.
    """

    name: str = ""
    stateful: bool = False
    needs_dists: bool = False

    def init(self, grads: Tree) -> Tree:
        raise NotImplementedError(f"{self.name} is stateless")

    def __call__(self, grads: Tree, *, stats: Optional[AggStats] = None,
                 state: Optional[Tree] = None,
                 seed: Optional[int] = None) -> Tuple[Tree, Tree]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ClipByNorm(Transform):
    """Per-worker l2 clipping: ||g_i|| <= max_norm.

    A cheap prefilter against magnitude attacks — the GAR still provides
    the directional guarantee.
    """

    max_norm: float = 1.0
    name: str = "clip"

    def __call__(self, grads, *, stats=None, state=None, seed=None):
        norms = torch.sqrt(torch.clamp(tree_sq_norms(grads), min=1e-30))
        scale = torch.clamp(self.max_norm / norms, max=1.0)          # (n,)

        def clip_leaf(x):
            s = scale.reshape((-1,) + (1,) * (x.ndim - 1))
            return (x.float() * s).to(x.dtype)

        return tree_map(clip_leaf, grads), state


@dataclasses.dataclass(frozen=True)
class WorkerMomentum(Transform):
    """Resilient averaging of momentums (Farhadkhani et al. 2022).

    Each worker's gradient is replaced by its exponential momentum
    m_i <- β·m_i + g_i before aggregation.  The new state is a fresh
    tensor (the old one is left as it was); for fp32 gradients the
    returned stack *is* the new state, so a caller must not write into it
    in place (the trainer only reads it).
    """

    beta: float = 0.9
    name: str = "worker_momentum"
    stateful: bool = True

    def init(self, grads: Tree) -> Tree:
        return tree_map(lambda x: torch.zeros(
            tuple(x.shape), dtype=torch.float32, device=x.device), grads)

    def __call__(self, grads, *, stats=None, state=None, seed=None):
        if state is None:
            raise ValueError("worker_momentum needs a state tree; "
                             "seed it with init_transform_states()")
        # beta * m rounded, then + g rounded: the reference's two operations
        new = tree_map(lambda m, g: (m * self.beta).add_(g.float()),
                       state, grads)
        out = tree_map(lambda m, g: m.to(g.dtype), new, grads)
        return out, new


@dataclasses.dataclass(frozen=True)
class NearestNeighborMix(Transform):
    """Replace g_i by the mean of its k nearest neighbours (self included).

    The (n, n) mixing matrix depends only on the distances: each row's
    distances are ranked by a stable argsort, NaN last, as ``jnp.argsort``
    ranks them (a row forged at 1e30 has NaN distances to its kind and inf
    to the rest, so its neighbours are the first rows at inf).
    """

    k: int = 3
    name: str = "nn_mix"
    needs_dists: bool = True

    def __call__(self, grads, *, stats=None, state=None, seed=None):
        if stats is None or stats.dists is None:
            raise ValueError("nn_mix needs AggStats with the distance matrix")
        k = min(self.k, stats.n)
        order = torch.argsort(stats.dists, dim=1, stable=True)
        ranks = torch.argsort(order, dim=1, stable=True)
        W = (ranks < k).float() / float(k)                   # (n, n)
        return tree_map(lambda x: _mix_leaf(W, x), grads), state


def _mix_leaf(W: Tensor, leaf: Tensor) -> Tensor:
    x = leaf.float()
    return torch.tensordot(W.to(x.device), x, dims=([1], [0])).to(leaf.dtype)


TRANSFORMS: Dict[str, Callable[..., Transform]] = {
    "clip": ClipByNorm,
    "worker_momentum": WorkerMomentum,
    "nn_mix": NearestNeighborMix,
}


def init_transform_states(transforms: Sequence[Transform],
                          grads_like: Tree) -> Tuple[Tree, ...]:
    """Initial state tuple (one entry per transform; None when stateless).
    ``grads_like`` only lends its leaves' shapes and devices."""
    return tuple(t.init(grads_like) if t.stateful else None
                 for t in transforms)


def apply_transforms(grads: Tree, transforms: Sequence[Transform],
                     states: Optional[Sequence[Tree]] = None, *,
                     seed: Optional[int] = None, use_kernels: bool = False
                     ) -> Tuple[Tree, Tuple[Tree, ...]]:
    """Run the transform pipeline; returns (grads, new_states).  Transform
    i draws from ``fold_seed(seed, i)``; a ``needs_dists`` one gets the
    distances of the stack it sees (K1 per leaf under ``use_kernels``)."""
    if not transforms:
        return grads, ()
    if states is None:
        states = (None,) * len(transforms)
    new_states = []
    f0 = 0  # transforms are rule-agnostic; stats carry distances only
    for i, (t, st) in enumerate(zip(transforms, states)):
        stats = None
        if t.needs_dists:
            stats = compute_stats(grads, f0, needs_dists=True,
                                  use_kernels=use_kernels)
        s = ATK.fold_seed(seed, i) if seed is not None else None
        grads, st = t(grads, stats=stats, state=st, seed=s)
        new_states.append(st)
    return grads, tuple(new_states)
