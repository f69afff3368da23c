"""Wire byte accounting (cf. ``repro.comm.transport``).

The wire is accounted, not transmitted: every quantity here is a Python
int derived from leaf shapes and the codec's exact ``leaf_wire_bytes``.
The model is the gather the trainers imply: each of the n workers ships
its encoded gradient rows to the aggregator in ``chunk_bytes`` chunks;
under a grouped aggregation, to its group leader, and the leaders ship
their group aggregates on (:func:`hier_wire_stats`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

from repro_torch.comm.codecs import Codec, get_codec
from repro_torch.comm.container import EncodedGrads, _numel
from repro_torch.core.theory import group_sizes
from repro_torch.tree import tree_leaves

Tree = Any

DEFAULT_CHUNK_BYTES = 4 << 20          # 4 MiB receive-buffer chunks


@dataclasses.dataclass(frozen=True)
class WireStats:
    """One round's wire accounting for an n-worker gather.

    ``bytes_per_worker`` is exact (the codec's ``leaf_wire_bytes`` summed
    over leaves); ``fp32_bytes_per_worker`` is the uncompressed reference
    for the same shapes, so ``compression`` is the wire's gain.
    ``chunks_per_worker`` is how many ``chunk_bytes`` transfers the gather
    schedules per worker.
    """

    codec: str
    n: int
    bytes_per_worker: int
    fp32_bytes_per_worker: int
    chunk_bytes: int
    #: the hierarchy level of the gather (``"workers_to_leaders"`` /
    #: ``"leaders_to_server"``, :func:`hier_wire_stats`); None when flat
    level: Optional[str] = None

    @property
    def total_bytes(self) -> int:
        return self.n * self.bytes_per_worker

    @property
    def compression(self) -> float:
        return self.fp32_bytes_per_worker / max(self.bytes_per_worker, 1)

    @property
    def chunks_per_worker(self) -> int:
        return -(-self.bytes_per_worker // self.chunk_bytes)

    def to_json(self) -> Dict[str, Any]:
        out = {
            "codec": self.codec,
            "n_workers": self.n,
            "bytes_per_worker": self.bytes_per_worker,
            "total_bytes": self.total_bytes,
            "fp32_bytes_per_worker": self.fp32_bytes_per_worker,
            "compression": round(self.compression, 4),
            "chunk_bytes": self.chunk_bytes,
            "chunks_per_worker": self.chunks_per_worker,
        }
        if self.level is not None:
            out["level"] = self.level
        return out


def _shapes_of(grads_like: Tree, n: Optional[int]
               ) -> Tuple[Tuple[int, ...], ...]:
    """Leaf shapes of a stacked tree, or of a parameter tree with the
    worker axis ``n`` prepended."""
    shapes = tuple(tuple(x.shape) for x in tree_leaves(grads_like))
    if n is None:
        return shapes
    return tuple((n,) + s for s in shapes)


def wire_stats(codec: Union[str, Codec], grads_like: Tree, *,
               n: Optional[int] = None,
               chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> WireStats:
    """Byte accounting for one gather round of ``grads_like``: a stacked
    gradient tree (leaves ``(n, ...)``, ``n=None``) or a parameter tree
    with ``n`` given (shapes only, nothing is allocated)."""
    c = get_codec(codec) if isinstance(codec, str) else codec
    shapes = _shapes_of(grads_like, n)
    if not shapes:
        raise ValueError("empty tree")
    n_workers = shapes[0][0]
    total = sum(c.leaf_wire_bytes(s) for s in shapes)
    fp32 = sum(4 * s[0] * _numel(s) for s in shapes)
    return WireStats(codec=c.spec(), n=n_workers,
                     bytes_per_worker=total // n_workers,
                     fp32_bytes_per_worker=fp32 // n_workers,
                     chunk_bytes=chunk_bytes)


def gather_stats(enc: EncodedGrads, *,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> WireStats:
    """WireStats straight off a wire container."""
    fp32 = sum(4 * s[0] * _numel(s) for s in enc.shapes)
    return WireStats(codec=enc.spec, n=enc.n,
                     bytes_per_worker=enc.bytes_per_worker,
                     fp32_bytes_per_worker=fp32 // enc.n,
                     chunk_bytes=chunk_bytes)


def hier_wire_stats(codec: Union[str, Codec], grads_like: Tree, *,
                    n: int, g: int,
                    chunk_bytes: int = DEFAULT_CHUNK_BYTES
                    ) -> Tuple[WireStats, WireStats]:
    """Per-level byte accounting of a two-level grouped gather, for the
    parameter tree ``grads_like`` (shapes only): ``workers_to_leaders``,
    all ``n`` workers to their group leaders, and ``leaders_to_server``,
    the ``ceil(n/g)`` leaders' group aggregates, re-encoded with the same
    codec, to the server."""
    n_groups = len(group_sizes(n, g))
    inner = dataclasses.replace(
        wire_stats(codec, grads_like, n=n, chunk_bytes=chunk_bytes),
        level="workers_to_leaders")
    outer = dataclasses.replace(
        wire_stats(codec, grads_like, n=n_groups, chunk_bytes=chunk_bytes),
        level="leaders_to_server")
    return inner, outer
