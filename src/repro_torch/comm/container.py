"""The wire container (cf. ``repro.comm.codecs.EncodedGrads``).

Its own module, free of the codecs' imports, so that ``core.api`` can
recognise a container with a plain ``isinstance`` check.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

Tree = Any
Shape = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class EncodedGrads:
    """One round's wire messages from all n workers.

    ``payload`` mirrors the gradient tree (per-leaf payload tensors; top-k
    leaves are ``(n, k)`` value stacks); ``sidecar`` holds the per-leaf
    per-row dequant multipliers (or int32 indices for top-k), ``None`` for
    sidecar-free codecs.  ``shapes`` are the original leaf shapes in leaf
    order; ``wire_bytes`` is the exact byte count all n workers put on the
    wire this round.
    """

    payload: Tree
    sidecar: Optional[Tree]
    spec: str
    n: int
    shapes: Tuple[Shape, ...]
    wire_bytes: int

    @property
    def bytes_per_worker(self) -> int:
        return self.wire_bytes // self.n


def is_encoded(x: Any) -> bool:
    return isinstance(x, EncodedGrads)


def _numel(shape: Shape) -> int:
    """Coordinates per worker row of an ``(n, ...)`` leaf shape."""
    m = 1
    for s in shape[1:]:
        m *= s
    return m
