"""Microbatched robust serving (cf. ``repro.serve.batching``).

The robust serving ensemble (``dist.serving.make_robust_serve_step``)
fuses replica logits one request batch at a time, every request at one
position.  This module packs many independent decode requests, each at
its *own* absolute position, into one fixed-size microbatch, decodes the
``n`` replicas one after another, each once over the whole microbatch
with per-lane positions (``models.decode_fn`` takes a (B,) position
tensor), and fuses the (n, B, V) logit stack with a **single**
plan/apply through the shared :class:`~repro_torch.core.api.
AggregatorBackend`: one K1 launch and one K2 launch on the (n, B·V) stack
under ``use_kernels``, instead of B separate per-request ones.

The JAX package's GSPMD layouts of the replica stacks
(``replica_param_specs``, ``replica_cache_specs``) have no counterpart on
one card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from repro_torch import models as MD
from repro_torch.configs.base import ArchConfig, RobustConfig
from repro_torch.core import api
from repro_torch.device import resolve_device
from repro_torch.tree import tree_map

Tensor = torch.Tensor
Tree = Any


@dataclasses.dataclass(frozen=True)
class RequestBatch:
    """A fixed-size microbatch of decode requests.

    ``tokens``/``pos`` are (B,) int32: each request's next input token and
    its absolute decode position; ``active`` is the (B,) bool validity
    mask (False = padding slot).
    """

    tokens: Tensor
    pos: Tensor
    active: Tensor

    @property
    def size(self) -> int:
        return int(self.tokens.shape[0])


def pack_requests(tokens: Sequence[int], pos: Sequence[int], size: int, *,
                  device=None) -> RequestBatch:
    """Pack up to ``size`` requests into one padded :class:`RequestBatch`
    on ``device`` (``cuda`` unless asked otherwise)."""
    k = len(tokens)
    if k != len(pos):
        raise ValueError(f"tokens/pos length mismatch ({k} vs {len(pos)})")
    if k > size:
        raise ValueError(f"{k} requests exceed microbatch size {size}")
    dev = resolve_device(device)
    pad = size - k

    def vec(values, dtype):
        return torch.tensor(values, dtype=dtype, device=dev)

    return RequestBatch(
        tokens=vec([int(t) for t in tokens] + [0] * pad, torch.int32),
        pos=vec([int(p) for p in pos] + [0] * pad, torch.int32),
        active=vec([True] * k + [False] * pad, torch.bool))


def _replica(tree: Tree, i: int) -> Tree:
    return tree_map(lambda t: t[i], tree)


def make_microbatch_serve_step(cfg: ArchConfig, rcfg: RobustConfig, *,
                               window: int = 0, seq_chunks: int = 1,
                               backend: Optional[api.AggregatorBackend] = None):
    """Build the microbatched robust decode step.

    ``(stacked_params, stacked_caches, rb: RequestBatch) -> ((B, V) fused
    logits, new stacked_caches)``; the caches carry the lanes on their
    batch axis (dim 1 of a stacked leaf) and the returned ones hold every
    lane's write, the padded lanes' included.

    Each replica decodes once over the B lanes, lane b at ``rb.pos[b]``;
    the (n, B, V) logit stack is multiplied by ``rb.active`` (padded lanes
    contribute zeros to the replica distances) and fused with one
    plan/apply.  An MoE layer dispatches the B lanes together; its expert
    capacity (at least 8 slots) drops no token up to B = 8, as the JAX
    package's one-lane dispatch drops none.
    """
    rcfg.validate()
    if backend is None:
        backend = api.AggregatorBackend.for_config(rcfg)

    @torch.no_grad()
    def step(stacked_params, stacked_caches, rb: RequestBatch):
        outs = [MD.decode_fn(_replica(stacked_params, i), cfg, rb.tokens,
                             _replica(stacked_caches, i), rb.pos,
                             window=window, seq_chunks=seq_chunks)
                for i in range(rcfg.n_workers)]
        logits = torch.stack([lg for lg, _ in outs])
        caches = tree_map(lambda *xs: torch.stack(xs),
                          *[c for _, c in outs])
        # (n, B, V); inactive lanes must not perturb the (n, n) statistics
        logits = logits * rb.active[None, :, None].to(logits.dtype)
        return backend(logits), caches

    return step
