"""Serving path: batched prefill, then token-by-token decode over the KV
caches (cf. ``repro.dist.serving``).

``generate`` is the entry point (``launch/serve.py``, the example);
``make_serve_step`` is the single-token step.

``make_robust_serve_step`` is the byzantine-tolerant ensemble: n model
replicas decode in lockstep and their per-token logits are fused by the
configured GAR through the same :class:`~repro_torch.core.api.
AggregatorBackend` the trainers use.  Under ``RobustConfig.use_kernels``
the statistics are one K1 launch and the multi-Bulyan apply one K2 launch
on the (n, B·V) logit stack per token.  An encoder-decoder's replicas each
carry their own cross K/V in their caches.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import models as MD
from repro_torch.configs.base import ArchConfig, RobustConfig
from repro_torch.core import api
from repro_torch.tree import tree_map

Tree = Any
Tensor = torch.Tensor


def make_serve_step(cfg: ArchConfig, *, window: int = 0,
                    seq_chunks: int = 1):
    """One decode step ``(params, cache, token, pos) -> (logits, cache)``."""

    @torch.no_grad()
    def step(params, cache, token, pos):
        return MD.decode_fn(params, cfg, token, cache, pos, window=window,
                            seq_chunks=seq_chunks)

    return step


def aggregate_replica_logits(logits: Tensor, rcfg: RobustConfig,
                             backend: Optional[api.AggregatorBackend] = None
                             ) -> Tensor:
    """(n, B, V) replica logits -> (B, V) robust consensus via ``rcfg.gar``.

    The replica axis plays the worker role: the backend plans on the (n, n)
    logit distances and applies the plan (K1 and K2 under
    ``use_kernels``), so up to f corrupted replicas cannot steer the served
    distribution outside the honest replicas' spread.
    """
    if backend is None:
        backend = api.AggregatorBackend.for_config(rcfg)
    return backend(logits)


def _replica(tree: Tree, i: int) -> Tree:
    return tree_map(lambda t: t[i], tree)


def make_robust_serve_step(cfg: ArchConfig, rcfg: RobustConfig, *,
                           window: int = 0, seq_chunks: int = 1,
                           backend: Optional[api.AggregatorBackend] = None):
    """Ensemble decode step over ``rcfg.n_workers`` stacked replicas.

    ``(stacked_params, stacked_caches, token, pos) -> (logits, caches)``:
    every leaf of ``stacked_params`` / ``stacked_caches`` carries a leading
    replica axis of size n.  The replicas decode one after another; their
    (B, V) logits are stacked and fused once.  The returned caches are new
    tensors (the decode writes out of place), so a stack whose replicas
    share storage, one built by ``expand``, is left as it was and gives
    what real copies give.
    """
    rcfg.validate()
    if backend is None:
        backend = api.AggregatorBackend.for_config(rcfg)

    @torch.no_grad()
    def step(stacked_params, stacked_caches, token, pos):
        outs = [MD.decode_fn(_replica(stacked_params, i), cfg, token,
                             _replica(stacked_caches, i), pos,
                             window=window, seq_chunks=seq_chunks)
                for i in range(rcfg.n_workers)]
        logits = torch.stack([lg for lg, _ in outs])
        caches = tree_map(lambda *xs: torch.stack(xs),
                          *[c for _, c in outs])
        return aggregate_replica_logits(logits, rcfg, backend), caches

    return step


def _step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator seeded from (seed, step) alone, the counterpart of
    ``jax.random.fold_in(key, step)``: a step's draw does not depend on
    the draws before it."""
    gen = torch.Generator(device=device)
    words = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)
    gen.manual_seed(int(words[0]))
    return gen


def _select_token(logits: Tensor, sample: str, seed: Optional[int],
                  step: int) -> Tensor:
    """(B, V) logits -> (B,) int32 tokens: the argmax, or a categorical
    draw (Gumbel-max, as ``jax.random.categorical``) from the generator of
    (``seed``, ``step``)."""
    if sample == "greedy":
        return torch.argmax(logits, dim=-1).int()
    if sample == "categorical":
        if seed is None:
            raise ValueError("categorical sampling needs a seed")
        gen = _step_generator(seed, step, logits.device)
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return torch.argmax(logits.float() - torch.log(-torch.log(u)),
                            dim=-1).int()
    raise ValueError(f"unknown sample mode {sample!r}")


@torch.no_grad()
def generate(params: Tree, cfg: ArchConfig, prompt: Tensor, new_tokens: int,
             *, window: int = 0, chunk_q: int = 512, sample: str = "greedy",
             seed: Optional[int] = None,
             extra_batch: Optional[Dict[str, Tensor]] = None) -> Tensor:
    """Prefill ``prompt`` (B, S) and decode ``new_tokens`` continuations on
    the prompt's device.  Returns (B, new_tokens) int32.  ``window > 0``
    serves from the sliding-window ring cache; otherwise the cache holds
    prefix + prompt + new_tokens exactly.  ``extra_batch`` carries the
    family's inputs: a VLM's ``prefix_embeds`` (B, n_patches, d_model),
    which take the cache slots before the prompt, so the decode positions
    start after them, or an encoder-decoder's audio ``frames``
    (B, n_frames, d_model), whose encoder memory takes no cache slots."""
    batch: Dict[str, Tensor] = {"tokens": prompt}
    if extra_batch:
        batch.update(extra_batch)
    n_prefix = 0
    if not cfg.is_encdec and batch.get("prefix_embeds") is not None:
        n_prefix = batch["prefix_embeds"].shape[1]
    prompt_total = prompt.shape[1] + n_prefix
    logits, cache = MD.prefill_fn(params, cfg, batch, window=window,
                                  chunk_q=chunk_q,
                                  cache_len=prompt_total + new_tokens)
    out: List[Tensor] = []
    for t in range(new_tokens):
        tok = _select_token(logits, sample, seed, t)
        out.append(tok)
        if t + 1 < new_tokens:
            logits, cache = MD.decode_fn(params, cfg, tok, cache,
                                         prompt_total + t, window=window)
    return torch.stack(out, dim=1)
