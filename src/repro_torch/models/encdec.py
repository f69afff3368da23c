"""Whisper-style encoder-decoder transformer (cf. ``repro.models.encdec``).

The audio frontend (mel spectrogram + conv feature extractor) is a stub, as
in the JAX package: the encoder takes precomputed frame embeddings
``frames`` (B, n_frames, d_model).  From there on: a bidirectional encoder,
a causal decoder with cross attention to the encoder memory, and serving
by prefill and decode with a self-attention KV cache beside the cross K/V
computed once at prefill.

The tree is the JAX package's: ``embed``, ``enc_layers`` and
``dec_layers`` (every leaf stacked over the layers), ``enc_norm``,
``final_norm`` and an untied ``lm_head``.  Positions are absolute
sinusoids added at the input of each stack (``rope='none'``).  A decode
cache is ``{"self": {"k", "v"}, "cross": {"k", "v"}}``, each leaf stacked
over the decoder layers: bf16 self-attention caches, the cross K/V in the
activation type (the JAX package keeps the cross pair as a tuple;
``api.cache_from_jax`` carries it across).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import mlp as F
from repro_torch.models import modules as M
from repro_torch.models.transformer import act_dtype, stacked_draws
from repro_torch.tree import tree_map

Tensor = torch.Tensor


def _enc_layer_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dev = gen.device
    return {"norm1": M.norm_init(cfg.norm, cfg.d_model, dev),
            "attn": A.attn_init(gen, cfg),
            "norm2": M.norm_init(cfg.norm, cfg.d_model, dev),
            "mlp": F.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation)}


def _dec_layer_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dev = gen.device
    return {"norm1": M.norm_init(cfg.norm, cfg.d_model, dev),
            "self": A.attn_init(gen, cfg),
            "norm_x": M.norm_init(cfg.norm, cfg.d_model, dev),
            "cross": A.attn_init(gen, cfg),
            "norm2": M.norm_init(cfg.norm, cfg.d_model, dev),
            "mlp": F.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation)}


def init_encdec(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random fp32 parameters on the generator's device, the layers
    stacked (``transformer.stacked_draws``)."""
    dev = gen.device
    return {
        "embed": M.embedding_init(gen, cfg.vocab_size, cfg.d_model),
        "enc_layers": stacked_draws(cfg.n_encoder_layers,
                                    lambda: _enc_layer_init(gen, cfg)),
        "dec_layers": stacked_draws(cfg.n_layers,
                                    lambda: _dec_layer_init(gen, cfg)),
        "enc_norm": M.norm_init(cfg.norm, cfg.d_model, dev),
        "final_norm": M.norm_init(cfg.norm, cfg.d_model, dev),
        "lm_head": M.linear_init(gen, cfg.d_model, cfg.vocab_size,
                                 stddev=1.0 / math.sqrt(cfg.d_model)),
    }


def _layer(stacked: dict, i: int) -> dict:
    return tree_map(lambda t: t[i], stacked)


def _with_positions(x: Tensor, d: int) -> Tensor:
    return x + M.sinusoidal_positions(x.shape[1], d,
                                      device=x.device)[None].to(x.dtype)


def encode(params: dict, cfg: ArchConfig, frames: Tensor, *,
           chunk_q: int = 1024) -> Tensor:
    """frames (B, n_frames, d_model), the stub's embeddings -> the encoder
    memory (B, n_frames, d_model) in the activation type."""
    x = _with_positions(frames.to(act_dtype(cfg)), cfg.d_model)
    b, s, _ = x.shape
    for i in range(cfg.n_encoder_layers):
        lp = _layer(params["enc_layers"], i)
        h = M.norm_apply(cfg.norm, lp["norm1"], x)
        q, k, v = A.project_qkv(lp["attn"], h, cfg)
        out = A.attend_full(q, k, v, causal=False, chunk_q=chunk_q)
        x = x + M.linear_apply(lp["attn"]["o"], out.reshape(b, s, -1))
        h2 = M.norm_apply(cfg.norm, lp["norm2"], x)
        x = x + F.mlp_apply(lp["mlp"], h2, cfg.activation)
    return M.norm_apply(cfg.norm, params["enc_norm"], x)


def decode_train(params: dict, cfg: ArchConfig, tokens: Tensor,
                 memory: Tensor, *, window: int = 0, chunk_q: int = 1024,
                 logits_tail: int = 0, emit_cache: bool = False,
                 cache_len: int = 0, return_hidden: bool = False):
    """Teacher-forced decoder pass over tokens (B, S) against the memory
    (B, Sm, d): the logits (of the last ``logits_tail`` positions; 0: all),
    or the hidden states after the final norm if ``return_hidden``; with
    ``emit_cache`` also the self-attention caches, stacked over the layers
    (``cache_len`` slots, default S + 64)."""
    x = _with_positions(
        M.embedding_apply(params["embed"], tokens, act_dtype(cfg)),
        cfg.d_model)
    b, s, _ = x.shape
    if not cache_len:
        cache_len = s + 64
    caches = []
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)
        h = M.norm_apply(cfg.norm, lp["norm1"], x)
        q, k, v = A.project_qkv(lp["self"], h, cfg)
        out = A.attend_full(q, k, v, causal=True, window=window,
                            chunk_q=chunk_q)
        x = x + M.linear_apply(lp["self"]["o"], out.reshape(b, s, -1))
        hx = M.norm_apply(cfg.norm, lp["norm_x"], x)
        x = x + A.attend_cross(lp["cross"], hx,
                               A.cross_kv(lp["cross"], memory, cfg), cfg)
        h2 = M.norm_apply(cfg.norm, lp["norm2"], x)
        x = x + F.mlp_apply(lp["mlp"], h2, cfg.activation)
        if emit_cache:
            caches.append(A.cache_from_prefill(k, v, cache_len, window))
    x = M.norm_apply(cfg.norm, params["final_norm"], x)
    if not return_hidden:
        if logits_tail:
            x = x[:, -logits_tail:]
        x = M.linear_apply(params["lm_head"], x)
    if not emit_cache:
        return x
    return x, tree_map(lambda *xs: torch.stack(xs), *caches)


def encdec_loss(params: dict, cfg: ArchConfig, batch: Dict[str, Tensor], *,
                chunk_q: int = 1024, xent_chunk: int = 4096) -> Tensor:
    """Next-token cross entropy of the decoder, given the batch's
    ``frames``, ``tokens`` and ``labels`` (chunked readout, untied)."""
    from repro_torch.models.losses import chunked_xent
    memory = encode(params, cfg, batch["frames"], chunk_q=chunk_q)
    x = decode_train(params, cfg, batch["tokens"], memory, chunk_q=chunk_q,
                     return_hidden=True)
    return chunked_xent(x, batch["labels"], {"lm_head": params["lm_head"]},
                        tied=False, chunk=xent_chunk)


# ---------------------------------------------------------------- serving
def _cross_kv_stack(params: dict, cfg: ArchConfig, memory: Tensor) -> dict:
    """Every decoder layer's cross K/V of the memory, stacked over the
    layers: ``{"k": (L, B, Sm, Hkv, hd), "v": ...}``."""
    kv = [A.cross_kv(_layer(params["dec_layers"], i)["cross"], memory, cfg)
          for i in range(cfg.n_layers)]
    return {"k": torch.stack([k for k, _ in kv]),
            "v": torch.stack([v for _, v in kv])}


def init_decode_cache(params: dict, cfg: ArchConfig, memory: Tensor,
                      batch: int, cache_len: int, *, window: int = 0
                      ) -> dict:
    """An empty self-attention cache (``window`` slots for a ring buffer,
    else ``cache_len``) beside the memory's cross K/V, per decoder layer."""
    one = A.init_kv_cache(batch, window or cache_len, cfg.n_kv_heads,
                          cfg.resolved_head_dim, device=memory.device)
    return {"self": tree_map(
                lambda t: t[None].repeat((cfg.n_layers,) + (1,) * t.dim()),
                one),
            "cross": _cross_kv_stack(params, cfg, memory)}


def encdec_prefill(params: dict, cfg: ArchConfig, frames: Tensor,
                   tokens: Tensor, *, window: int = 0, chunk_q: int = 1024,
                   cache_len: int = 0) -> Tuple[Tensor, dict]:
    """Encode the frames and warm the decoder's self-attention cache on
    the prompt: (the last position's logits (B, vocab), cache)."""
    memory = encode(params, cfg, frames, chunk_q=chunk_q)
    logits, self_c = decode_train(
        params, cfg, tokens, memory, window=window, chunk_q=chunk_q,
        logits_tail=1, emit_cache=True, cache_len=cache_len)
    return logits[:, 0], {"self": self_c,
                          "cross": _cross_kv_stack(params, cfg, memory)}


def encdec_decode_step(params: dict, cfg: ArchConfig, token: Tensor,
                       cache: dict, pos, *, window: int = 0,
                       seq_chunks: int = 1) -> Tuple[Tensor, dict]:
    """One decoder token.  token: (B,) ints; ``pos``: the absolute
    position (an int or a 0-d tensor) or a (B,) tensor of per-lane
    positions.  Returns (logits (B, vocab), a new cache: the
    self-attention caches written out of place, the cross K/V the same
    tensors)."""
    x = M.embedding_apply(params["embed"], token[:, None], act_dtype(cfg))
    pos = A.position(pos, x.device)
    x = x + M.sinusoid(pos, cfg.d_model).reshape(-1, 1, cfg.d_model).to(
        x.dtype)
    cross = cache["cross"]
    new_self = []
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)
        h = M.norm_apply(cfg.norm, lp["norm1"], x)
        out, sc = A.attend_cached(lp["self"], h, _layer(cache["self"], i),
                                  pos, cfg, window=window,
                                  seq_chunks=seq_chunks)
        x = x + out
        hx = M.norm_apply(cfg.norm, lp["norm_x"], x)
        x = x + A.attend_cross(lp["cross"], hx,
                               (cross["k"][i], cross["v"][i]), cfg)
        h2 = M.norm_apply(cfg.norm, lp["norm2"], x)
        x = x + F.mlp_apply(lp["mlp"], h2, cfg.activation)
        new_self.append(sc)
    x = M.norm_apply(cfg.norm, params["final_norm"], x)
    logits = M.linear_apply(params["lm_head"], x)[:, 0]
    return logits, {"self": tree_map(lambda *xs: torch.stack(xs), *new_self),
                    "cross": cross}
