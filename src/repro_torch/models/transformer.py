"""Decoder-only dense LM (cf. ``repro.models.transformer``, dense branch).

Layers are grouped into superblocks of one layer each; every group leaf is
stacked along a leading axis of length ``n_layers`` (the JAX package's
``lax.scan`` layout), so the parameter tree has the reference's leaves in
the reference's sorted key-path order.  The forward is a Python loop over
the stack.  MoE, SSM, hybrid and VLM/audio families are not ported yet.

Three execution modes share the parameters:
* ``apply_lm``    — full-sequence forward (training loss / logits);
* ``prefill``     — the same forward, also emitting each layer's KV cache
                    (stacked like the parameters: leading axis
                    ``n_layers``) and only the last position's logits;
* ``decode_step`` — one token against the cache (full or ring buffer).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import modules as M
from repro_torch.models import mlp as F
from repro_torch.tree import tree_map

Tensor = torch.Tensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def act_dtype(cfg: ArchConfig) -> torch.dtype:
    """The activation type (the JAX package casts to bf16 at the embedding)."""
    return _DTYPES[cfg.dtype]


def check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: only the dense decoder family is ported")


def _layer_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dev = gen.device
    p: dict = {"norm1": M.norm_init(cfg.norm, cfg.d_model, dev),
               "attn": A.attn_init(gen, cfg)}
    if cfg.d_ff:
        p["norm2"] = M.norm_init(cfg.norm, cfg.d_model, dev)
        p["mlp"] = F.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation)
    return p


def init_lm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random fp32 parameters on the generator's device."""
    check_dense(cfg)
    layers = [{"l0": _layer_init(gen, cfg)} for _ in range(cfg.n_layers)]
    groups = tree_map(lambda *xs: torch.stack(xs), *layers)
    params = {
        "embed": M.embedding_init(gen, cfg.vocab_size, cfg.d_model),
        "groups": groups,
        "final_norm": M.norm_init(cfg.norm, cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = M.linear_init(
            gen, cfg.d_model, cfg.vocab_size,
            stddev=1.0 / math.sqrt(cfg.d_model))
    return params


def check_decodable(cfg: ArchConfig) -> None:
    """The serving entry points: the dense family with rotary positions
    (the sinusoid of ``rope='none'`` comes with the whisper family)."""
    check_dense(cfg)
    if cfg.rope == "none":
        raise NotImplementedError(
            f"{cfg.name}: rope='none' (absolute sinusoid positions) is not "
            f"ported")


def _mlp_block(p: dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    if "mlp" in p:
        h2 = M.norm_apply(cfg.norm, p["norm2"], x)
        x = x + F.mlp_apply(p["mlp"], h2, cfg.activation)
    return x


def _layer_apply(p: dict, x: Tensor, cfg: ArchConfig, *, positions: Tensor,
                 window: int, chunk_q: int, cache_len: int = 0
                 ) -> Tuple[Tensor, Optional[dict]]:
    """Returns (x, the layer's KV cache if ``cache_len`` else None)."""
    h = M.norm_apply(cfg.norm, p["norm1"], x)
    b, s, _ = h.shape
    q, k, v = A.project_qkv(p["attn"], h, cfg, positions=positions)
    out = A.attend_full(q, k, v, causal=True, window=window, chunk_q=chunk_q)
    x = x + M.linear_apply(p["attn"]["o"], out.reshape(b, s, -1))
    cache = A.cache_from_prefill(k, v, cache_len, window) if cache_len \
        else None
    return _mlp_block(p, x, cfg), cache


def _forward(params: dict, cfg: ArchConfig, tokens: Tensor, *, window: int,
             chunk_q: int, cache_len: int = 0
             ) -> Tuple[Tensor, Optional[dict]]:
    """Embedding, the layers and the final norm: (hidden, the stacked
    cache if ``cache_len`` else None)."""
    x = M.embedding_apply(params["embed"], tokens, act_dtype(cfg))
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    groups = params["groups"]
    caches = []
    for g in range(cfg.n_layers):
        gp = tree_map(lambda t: t[g], groups)
        x, cache = _layer_apply(gp["l0"], x, cfg, positions=positions,
                                window=window, chunk_q=chunk_q,
                                cache_len=cache_len)
        if cache_len:
            caches.append({"l0": cache})
    x = M.norm_apply(cfg.norm, params["final_norm"], x)
    if not cache_len:
        return x, None
    return x, tree_map(lambda *xs: torch.stack(xs), *caches)


def apply_lm(params: dict, cfg: ArchConfig, tokens: Tensor, *,
             window: int = 0, chunk_q: int = 1024, logits_tail: int = 0,
             return_hidden: bool = False) -> Tensor:
    """Full-sequence forward: logits, or the hidden state after the final
    norm when ``return_hidden`` (the chunked loss does its own readout).
    ``logits_tail > 0`` reads out only the last positions (0: all)."""
    x, _ = _forward(params, cfg, tokens, window=window, chunk_q=chunk_q)
    if return_hidden:
        return x
    if logits_tail:
        x = x[:, -logits_tail:]
    return _readout(params, cfg, x)


def _readout(params: dict, cfg: ArchConfig, x: Tensor) -> Tensor:
    if cfg.tie_embeddings:
        return M.embedding_attend(params["embed"], x)
    return M.linear_apply(params["lm_head"], x)


def lm_loss(params: dict, cfg: ArchConfig, batch: Dict[str, Tensor], *,
            window: int = 0, chunk_q: int = 1024,
            xent_chunk: int = 4096) -> Tensor:
    """Next-token cross entropy with a chunked readout.
    batch: tokens, labels, optional loss_mask."""
    from repro_torch.models.losses import chunked_xent
    x = apply_lm(params, cfg, batch["tokens"], window=window,
                 chunk_q=chunk_q, return_hidden=True)
    if cfg.tie_embeddings:
        rp, tied = {"embed": params["embed"]}, True
    else:
        rp, tied = {"lm_head": params["lm_head"]}, False
    return chunked_xent(x, batch["labels"], rp, tied=tied,
                        mask=batch.get("loss_mask"), chunk=xent_chunk)


# ----------------------------------------------------------------- caches
def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               window: int = 0, device=None) -> dict:
    """Empty bf16 cache, stacked per layer (leading axis ``n_layers``)."""
    check_decodable(cfg)
    layer = A.init_kv_cache(batch, window or cache_len, cfg.n_kv_heads,
                            cfg.resolved_head_dim,
                            device=resolve_device(device))
    return {"l0": tree_map(
        lambda t: t[None].repeat((cfg.n_layers,) + (1,) * t.dim()), layer)}


def prefill(params: dict, cfg: ArchConfig, tokens: Tensor, *,
            window: int = 0, chunk_q: int = 1024, cache_len: int = 0
            ) -> Tuple[Tensor, dict]:
    """Process the prompt (B, S): (last position's logits (B, vocab),
    cache).  ``cache_len``, the cache's capacity (prompt and the decode
    steps to come), defaults to S + 64; a ring buffer holds ``window``."""
    check_decodable(cfg)
    if not cache_len:
        cache_len = tokens.shape[1] + 64
    x, cache = _forward(params, cfg, tokens, window=window, chunk_q=chunk_q,
                        cache_len=cache_len)
    x = x[:, -1:]
    return _readout(params, cfg, x)[:, 0], cache


def decode_step(params: dict, cfg: ArchConfig, token: Tensor, cache: dict,
                pos, *, window: int = 0, seq_chunks: int = 1
                ) -> Tuple[Tensor, dict]:
    """One decode step.  token: (B,) ints; ``pos``: the absolute position
    (an int or a 0-d tensor).  Returns (logits (B, vocab), the updated
    cache, a new tree: ``cache`` is not written)."""
    check_decodable(cfg)
    x = M.embedding_apply(params["embed"], token[:, None], act_dtype(cfg))
    # once a step, on the device; no layer reads the position back
    pos = A.position(pos, x.device)
    groups = params["groups"]
    new = []
    for g in range(cfg.n_layers):
        lp = tree_map(lambda t: t[g], groups)["l0"]
        lc = tree_map(lambda t: t[g], cache)["l0"]
        h = M.norm_apply(cfg.norm, lp["norm1"], x)
        out, lc = A.attend_cached(lp["attn"], h, lc, pos, cfg,
                                  window=window, seq_chunks=seq_chunks)
        x = _mlp_block(lp, x + out, cfg)
        new.append({"l0": lc})
    x = M.norm_apply(cfg.norm, params["final_norm"], x)
    return _readout(params, cfg, x)[:, 0], \
        tree_map(lambda *xs: torch.stack(xs), *new)
