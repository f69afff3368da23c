"""Dispatched-op auditors: prove the port's contracts on what a call runs
(cf. ``repro.analysis.jaxpr_audit``).

The port compiles no graph, so where the JAX auditors walk a jaxpr these
run the real call under an :class:`OpRecorder` (a ``TorchDispatchMode``)
that records every aten op it dispatches (name, input and output shapes
and dtypes) and every ``torch.distributed`` collective (c10d's ops, which
the dispatcher shows too) with its tensors and the group it ran on.  Each
audit returns a :class:`ContractResult` with the JAX fields and fails when
it audited nothing:

* **C201 apply shard gather** — in the mesh-native apply
  (``core/api.py::_sharded_apply_leaf``) a rank's worker-group gather
  carries at most the (n_pad, d_pad/M) column tile of a leaf and its
  model-group gather contributes at most the (d_pad/M,) result; any other
  collective in the apply is a violation.  At M > 1 no collective carries
  a full (n, d) leaf.  The statistics and the plan run first, outside the
  recorder, as the JAX audit runs them eagerly before it traces the apply.
* **C202 decode invariant** — under the mesh-native
  ``aggregate_tree`` pipeline on a ``qsgd:bits=8`` container, no int8 or
  bf16 → fp32 conversion in the apply (an op with a narrow input and an
  fp32 output) produces more than the rank's (n_pad, d_pad/M) of a leaf:
  ``_sharded_apply_encoded``'s promise.  The statistics phase, recorded
  apart, gathers and decodes each leaf's full (n_pad, d) rows on every
  rank, as JAX's ``sharded_raw_stats`` does inside its shard body
  (``repro/core/api.py:357-370``), which the JAX C202 exempts; the port
  has no "outside a shard body", so its bound is the apply's.
* **C204 single build** — the port never compiles a graph; its
  counterpart of single compile is single build: a callable run again
  adds zero ``nvcc`` runs and zero library loads
  (``kernels.build.build_counts``).
* **C205 hier decode** — ``hier``'s grouped path under a codec decodes
  per-group row slices of fewer than n rows, never the full stack.

C203 (the tensor-parallel reshape seam) has no counterpart: the port sets
no sharding constraints; ``core.api.column_tile`` cuts each rank's columns
itself.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_NARROW = (torch.int8, torch.uint8, torch.bfloat16)
#: c10d's gather ops (``dist.all_gather_into_tensor`` /
#: ``all_gather_single``, and the list form)
_GATHERS = ("c10d._allgather_base_", "c10d.allgather_")

Shape = Tuple[int, ...]


@dataclasses.dataclass
class ContractResult:
    contract: str                        # e.g. "C201-apply-shard-gather"
    status: str                          # "proven" | "violated"
    detail: str
    violations: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.status == "proven"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _result(contract: str, violations: List[str], detail: str
            ) -> ContractResult:
    return ContractResult(
        contract=contract,
        status="violated" if violations else "proven",
        detail=detail, violations=violations)


# ------------------------------------------------------------ recording
@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched op: its name (``aten.mul.Tensor``), the (shape,
    dtype) of each tensor argument and each tensor output, and for a
    collective the name of its group (:class:`OpRecorder`'s ``groups``)."""

    name: str
    inputs: Tuple[Tuple[Shape, str], ...]
    outputs: Tuple[Tuple[Shape, str], ...]
    group: Optional[str] = None

    @property
    def collective(self) -> bool:
        return self.name.startswith("c10d.")


def _tensors(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


def _sig(ts) -> Tuple[Tuple[Shape, str], ...]:
    return tuple((tuple(int(s) for s in t.shape), str(t.dtype)[6:])
                 for t in ts)


class OpRecorder(TorchDispatchMode):
    """Records every op dispatched while it is active (a context
    manager).  ``groups`` names process groups ({"worker": group, ...}),
    so each collective records the name of the group it ran on: None for
    any other, the names joined by "+" for a group of several roles (a
    one-rank mesh's worker and model group are one group)."""

    def __init__(self, groups: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.ops: List[OpRecord] = []
        self._groups: Dict[int, str] = {}
        for name, g in sorted((groups or {}).items()):
            if g is not None:
                known = self._groups.get(id(g))
                self._groups[id(g)] = name if known is None \
                    else f"{known}+{name}"

    def _group(self, args) -> Optional[str]:
        import torch.distributed as dist
        for a in args:
            if isinstance(a, torch.ScriptObject):
                return self._groups.get(id(dist.ProcessGroup.unbox(a)))
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket) if hasattr(func, "overloadpacket") \
            else str(func)
        self.ops.append(OpRecord(
            name=name, inputs=_sig(_tensors((args, kwargs))),
            outputs=_sig(_tensors(out)),
            group=self._group(args) if name.startswith("c10d.") else None))
        return out

    def collectives(self) -> List[OpRecord]:
        return [r for r in self.ops if r.collective]

    def decodes(self) -> List[OpRecord]:
        """Ops that take an int8 / uint8 / bf16 tensor and give an fp32
        one: a widening cast, or a product of a payload and its
        multipliers."""
        narrow = {str(d)[6:] for d in _NARROW}
        return [r for r in self.ops if not r.collective
                and any(dt in narrow for _, dt in r.inputs)
                and any(dt == "float32" for _, dt in r.outputs)]


def _numel(shape: Shape) -> int:
    return math.prod(shape)


# ------------------------------------------------------------------ C201
def apply_gather_bounds(grads, mesh_ctx) -> Tuple[int, int]:
    """(worker, model) bounds of the mesh-native apply over a stacked tree
    or container's leaves, in elements: the largest (n_pad, d_pad/M)
    column tile and the largest (d_pad/M,) result, n_pad = W ceil(n / W),
    d_pad = M ceil(numel / M)."""
    from repro_torch.core import api
    from repro_torch.tree import tree_leaves
    enc = api._as_encoded(grads)
    if enc is not None:
        shapes = [tuple(s) for s in enc.shapes]
    else:
        shapes = [tuple(x.shape) for x in tree_leaves(grads)]
    W, M = mesh_ctx.worker_size, mesh_ctx.model_size
    worker = model = 0
    for shape in shapes:
        n_pad = -(-shape[0] // W) * W
        tile = -(-_numel(shape[1:]) // M)
        worker = max(worker, n_pad * tile)
        model = max(model, tile)
    return worker, model


def gather_violations(rec: OpRecorder, *, worker: int, model: int
                      ) -> Tuple[List[str], int]:
    """The apply's collectives against C201's bounds (in elements): each
    worker-group gather's result at most ``worker``, each model-group
    gather's contribution at most ``model``, no other collective.
    Returns (violations, gathers audited)."""
    violations, gathers = [], 0
    for r in rec.collectives():
        sizes = [_numel(s) for s, _ in r.inputs]
        shapes = [s for s, _ in r.inputs]
        if r.name not in _GATHERS or r.group is None:
            violations.append(f"{r.name} on group {r.group!r} with tensors "
                              f"{shapes} inside the apply — only the worker "
                              "tile gather and the model result gather "
                              "belong there")
            continue
        gathers += 1
        # a gather within the bound of one of its group's roles passes
        found = []
        for role in r.group.split("+"):
            if role == "worker" and max(sizes) > worker:
                found.append(
                    f"worker-group gather of {max(shapes, key=_numel)} "
                    f"({max(sizes):,} elements) exceeds the (n_pad, "
                    f"d_pad/M) tile of {worker:,}")
            elif role == "model" and min(sizes) > model:
                found.append(
                    f"model-group gather of a {min(shapes, key=_numel)} "
                    f"contribution ({min(sizes):,} elements) exceeds the "
                    f"(d_pad/M,) result of {model:,}")
            elif role in ("worker", "model"):
                found = []
                break
        violations += found
    return violations, gathers


def _mesh_plan(block, f: int, rule: str, mesh_ctx):
    from repro_torch.core import api
    agg = api.get_aggregator(rule)
    stats = api.compute_stats(block, f, needs_dists=agg.needs_dists,
                              mesh_ctx=mesh_ctx)
    agg.validate(stats.n, stats.f)
    return agg, agg.plan(stats)


def _groups(mesh_ctx) -> Dict[str, Any]:
    return {"worker": mesh_ctx.worker_group, "model": mesh_ctx.model_group}


def audit_apply_gather(grads, f: int = 1, rule: str = "multi_bulyan", *,
                       mesh_ctx) -> ContractResult:
    """C201 on this rank: the apply gathers at most (n_pad, d_pad/M) over
    the worker group and (d_pad/M,) over the model group.  ``grads`` is
    the whole stacked tree (each rank cuts its row block)."""
    from repro_torch.core import api
    block = api.row_block(grads, mesh_ctx)
    agg, plan = _mesh_plan(block, f, rule, mesh_ctx)
    with OpRecorder(_groups(mesh_ctx)) as rec:
        agg.apply(plan, block, mesh_ctx=mesh_ctx)
    worker, model = apply_gather_bounds(grads, mesh_ctx)
    violations, gathers = gather_violations(rec, worker=worker, model=model)
    if gathers == 0:
        violations.append("no gather in the apply: the mesh-native apply "
                          "was not exercised")
    W, M = mesh_ctx.worker_size, mesh_ctx.model_size
    return _result(
        "C201-apply-shard-gather", violations,
        f"{gathers} gather(s) audited against the (n_pad, d_pad/M) tile of "
        f"{worker:,} and the (d_pad/M,) result of {model:,} elements "
        f"(rule={rule}, mesh W={W} M={M})")


# ------------------------------------------------------------------ C202
def decode_violations(rec: OpRecorder, bound: int) -> Tuple[List[str], int]:
    """Narrow → fp32 ops producing more than ``bound`` elements.  Returns
    (violations, decodes audited)."""
    violations = []
    decodes = rec.decodes()
    for r in decodes:
        for shape, dt in r.outputs:
            if dt == "float32" and _numel(shape) > bound:
                violations.append(
                    f"{r.name} {[s for s, _ in r.inputs]} -> {shape} fp32: "
                    f"{_numel(shape):,} elements, over the rank's "
                    f"(n_pad, d_pad/M) of {bound:,}")
    return violations, len(decodes)


def audit_decode_invariant(grads, f: int = 1, rule: str = "multi_bulyan",
                           *, mesh_ctx, codec_spec: str = "qsgd:bits=8"
                           ) -> ContractResult:
    """C202 on this rank: ``grads`` encoded with ``codec_spec`` (seed 0),
    the rank's row block of the container through ``aggregate_tree``'s
    pipeline (statistics, plan, apply), every decode of the apply within
    the rank's (n_pad, d_pad/M) of a leaf."""
    from repro_torch.comm import codecs as CC
    from repro_torch.core import api
    enc, _ = CC.get_codec(codec_spec).encode(grads, seed=0)
    block = api.row_block(enc, mesh_ctx)
    with OpRecorder() as stats_rec:
        agg, plan = _mesh_plan(block, f, rule, mesh_ctx)
    with OpRecorder() as rec:
        agg.apply(plan, block, mesh_ctx=mesh_ctx)
    bound, _ = apply_gather_bounds(enc, mesh_ctx)
    violations, decodes = decode_violations(rec, bound)
    if decodes == 0:
        violations.append(f"no {codec_spec} dequantization in the apply: "
                          "the encoded path was not exercised")
    return _result(
        "C202-decode-invariant", violations,
        f"{decodes} narrow->fp32 op(s) of the apply audited against the "
        f"rank's (n_pad, d_pad/M) of {bound:,} elements; the statistics "
        f"decoded {len(stats_rec.decodes())} gathered leaf piece(s) "
        f"(codec={codec_spec}, rule={rule}, mesh "
        f"W={mesh_ctx.worker_size} M={mesh_ctx.model_size})")


# ------------------------------------------------------------------ C204
def audit_single_build(fn: Callable, make_args: Callable[[], tuple], *,
                       label: str, repeats: int = 2) -> ContractResult:
    """C204: after one call of ``fn``, ``repeats`` more with fresh
    same-shape arguments from ``make_args`` run no ``nvcc`` and load no
    library."""
    from repro_torch.kernels import build
    before = build.build_counts()
    fn(*make_args())
    mid = build.build_counts()
    with OpRecorder() as rec:
        for _ in range(repeats):
            fn(*make_args())
    after = build.build_counts()
    first = {k: mid[k] - before[k] for k in mid}
    rest = {k: after[k] - mid[k] for k in after}
    violations = []
    if any(rest.values()):
        violations.append(
            f"{label}: {rest['nvcc_runs']} nvcc run(s) and "
            f"{rest['library_loads']} library load(s) on {repeats} repeated "
            "calls — the kernels are built or loaded again")
    if not rec.ops:
        violations.append(f"{label}: the repeated calls dispatched no op")
    return _result(
        "C204-single-build", violations,
        f"{label}: {first['nvcc_runs']} nvcc run(s) and "
        f"{first['library_loads']} load(s) on the first call, "
        f"{rest['nvcc_runs']} and {rest['library_loads']} on {repeats} "
        f"repeats ({len(rec.ops)} ops)")


# ------------------------------------------------------------------ C205
def full_stack_decodes(rec: OpRecorder, n: int) -> Tuple[List[str], int]:
    """Narrow → fp32 ops whose output holds n rows or more (2-d or
    more).  Returns (violations, decodes audited)."""
    violations = []
    decodes = rec.decodes()
    for r in decodes:
        for shape, dt in r.outputs:
            if dt == "float32" and len(shape) >= 2 and shape[0] >= n:
                violations.append(
                    f"{r.name} -> {shape} fp32: a decode of the full "
                    f"{n}-row stack")
    return violations, len(decodes)


def audit_hier_decode(grads, f: int = 1, spec: str = "g=7",
                      rule: str = "multi_bulyan",
                      codec_spec: str = "qsgd:bits=8") -> ContractResult:
    """C205: ``grads`` encoded with ``codec_spec`` (seed 0) through
    ``hier_aggregate_tree`` decodes per-group row slices, never the full
    n-row stack."""
    from repro_torch.comm import codecs as CC
    from repro_torch.hier import GroupConfig, hier_aggregate_tree
    enc, _ = CC.get_codec(codec_spec).encode(grads, seed=0)
    cfg = GroupConfig.from_spec(spec, rule=rule)
    with OpRecorder() as rec:
        hier_aggregate_tree(enc, f, cfg)
    violations, decodes = full_stack_decodes(rec, enc.n)
    if decodes == 0:
        violations.append("no dequantization in the grouped path")
    return _result(
        "C205-hier-decode", violations,
        f"{decodes} narrow->fp32 op(s) audited; every decode is a "
        f"per-group row slice (< n={enc.n} rows; {spec}, "
        f"codec={codec_spec})")
