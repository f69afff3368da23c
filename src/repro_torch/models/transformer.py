"""Decoder-only LM assembly: dense / GQA / MoE / SSM / hybrid / VLM prefix
(cf. ``repro.models.transformer``).

Layers are grouped into *superblocks* of ``period`` layers (period = 1 for
homogeneous stacks; the lcm of the hybrid period and the MoE interleave
for jamba-style models).  A group's tree is keyed ``l0 … l{period-1}``
and every group leaf is stacked along a leading axis of length
``n_groups`` (the JAX package's ``lax.scan`` layout), so the parameter
tree has the reference's leaves in the reference's sorted key-path order.
The forward is a Python loop over the groups.

Three execution modes share the parameters:
* ``apply_lm``    — full-sequence forward (training loss / logits);
* ``prefill``     — the same forward, also emitting each layer's cache (a
                    bf16 KV cache for attention, ``{conv, h}`` for a mamba
                    mixer; stacked like the parameters) and only the last
                    position's logits;
* ``decode_step`` — one token against the cache (full or ring buffer).

A VLM's ``prefix_embeds`` (B, P, d) are prepended to the token embeddings
and take positions 0 … P-1; the loss drops the prefix positions.
``rope='none'`` adds absolute sinusoid positions at the embedding.  The
encoder-decoder family is ``models/encdec.py``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import mlp as F
from repro_torch.models import modules as M
from repro_torch.models import moe as E
from repro_torch.models import ssm as S
from repro_torch.tree import tree_map

Tensor = torch.Tensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def act_dtype(cfg: ArchConfig) -> torch.dtype:
    """The activation type (the JAX package casts to bf16 at the embedding)."""
    return _DTYPES[cfg.dtype]


# ------------------------------------------------------------ layer specs
def layer_specs(cfg: ArchConfig) -> List[Tuple[str, Optional[str]]]:
    """Per-layer (mixer, mlp) kinds for one superblock period."""
    if cfg.family == "ssm":
        return [("mamba", None)]
    period = 1
    if cfg.hybrid is not None:
        period = cfg.hybrid.period
    if cfg.moe is not None:
        period = math.lcm(period, cfg.moe.every)
    specs: List[Tuple[str, Optional[str]]] = []
    for i in range(period):
        if cfg.hybrid is not None:
            mixer = "attn" if (i % cfg.hybrid.period) == cfg.hybrid.attn_index else "mamba"
        else:
            mixer = "attn"
        if cfg.d_ff == 0 and cfg.moe is None:
            mlp_kind: Optional[str] = None
        elif cfg.moe is not None and (i % cfg.moe.every) == cfg.moe.every - 1:
            mlp_kind = "moe"
        else:
            mlp_kind = "dense"
        specs.append((mixer, mlp_kind))
    return specs


def n_groups(cfg: ArchConfig) -> int:
    period = len(layer_specs(cfg))
    if cfg.n_layers % period:
        raise ValueError(
            f"{cfg.name}: n_layers={cfg.n_layers} is not a multiple of the "
            f"layer period {period}")
    return cfg.n_layers // period


# ------------------------------------------------------------------ init
def _layer_init(gen: torch.Generator, cfg: ArchConfig, mixer: str,
                mlp_kind: Optional[str]) -> dict:
    dev = gen.device
    p: dict = {"norm1": M.norm_init(cfg.norm, cfg.d_model, dev)}
    if mixer == "attn":
        p["attn"] = A.attn_init(gen, cfg)
    else:
        p["mamba"] = S.mamba_init(gen, cfg)
    if mlp_kind is not None:
        p["norm2"] = M.norm_init(cfg.norm, cfg.d_model, dev)
        if mlp_kind == "moe":
            p["moe"] = E.moe_init(gen, cfg.d_model, cfg.moe, cfg.activation)
        else:
            p["mlp"] = F.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.activation)
    return p


def _group_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {f"l{i}": _layer_init(gen, cfg, mx, mk)
            for i, (mx, mk) in enumerate(layer_specs(cfg))}


def stacked_draws(n: int, draw: Callable[[], dict]) -> dict:
    """``n`` trees from ``draw()``, every leaf stacked along a new leading
    axis.  They are drawn one after another into the stacked leaves, so
    at most one draw's tree exists twice."""
    first = draw()
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    tree_map(lambda s, t: s[0].copy_(t), out, first)
    del first
    for i in range(1, n):
        tree_map(lambda s, t: s[i].copy_(t), out, draw())
    return out


def init_lm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random fp32 parameters on the generator's device, the groups stacked
    (:func:`stacked_draws`)."""
    groups = stacked_draws(n_groups(cfg), lambda: _group_init(gen, cfg))
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


# --------------------------------------------------------------- forward
def _mlp_block(p: dict, x: Tensor, cfg: ArchConfig, mlp_kind: Optional[str],
               *, lane_capacity: bool = False
               ) -> Tuple[Tensor, Optional[Tensor]]:
    """The layer's MLP half: (x, the MoE auxiliary loss or None);
    ``lane_capacity`` as in ``moe.capacity``."""
    if mlp_kind is None:
        return x, None
    h2 = M.norm_apply(cfg.norm, p["norm2"], x)
    if mlp_kind == "moe":
        y, aux = E.moe_apply(p["moe"], h2, cfg.moe, cfg.activation,
                             lane_capacity=lane_capacity)
        return x + y, aux
    return x + F.mlp_apply(p["mlp"], h2, cfg.activation), None


def _layer_apply(p: dict, x: Tensor, cfg: ArchConfig, mixer: str,
                 mlp_kind: Optional[str], *, positions: Tensor,
                 window: int, chunk_q: int, cache_len: int = 0
                 ) -> Tuple[Tensor, Optional[Tensor], Optional[dict]]:
    """Returns (x, the MoE auxiliary loss or None, the layer's cache if
    ``cache_len`` else None)."""
    h = M.norm_apply(cfg.norm, p["norm1"], x)
    cache = None
    if mixer == "attn":
        b, s, _ = h.shape
        q, k, v = A.project_qkv(p["attn"], h, cfg, positions=positions)
        out = A.attend_full(q, k, v, causal=True, window=window,
                            chunk_q=chunk_q)
        out = M.linear_apply(p["attn"]["o"], out.reshape(b, s, -1))
        if cache_len:
            cache = A.cache_from_prefill(k, v, cache_len, window)
    elif cache_len:
        # prefill emits the final recurrent state for decode continuation
        out, cache = S.mamba_apply(p["mamba"], h, cfg, emit_cache=True)
    else:
        out = S.mamba_apply(p["mamba"], h, cfg)
    x, aux = _mlp_block(p, x + out, cfg, mlp_kind)
    return x, aux, cache


def _check_prefix(cfg: ArchConfig, tokens: Tensor,
                  prefix_embeds: Optional[Tensor]) -> int:
    """The prefix length (0 without one); a prefix that is not (batch,
    n_patches, d_model) raises."""
    if prefix_embeds is None:
        return 0
    b, d = tokens.shape[0], cfg.d_model
    if prefix_embeds.dim() != 3 or prefix_embeds.shape[0] != b or \
            prefix_embeds.shape[2] != d:
        raise ValueError(
            f"prefix_embeds: want (batch={b}, n_patches, d_model={d}), got "
            f"{tuple(prefix_embeds.shape)}")
    return prefix_embeds.shape[1]


def _embed_inputs(params: dict, cfg: ArchConfig, tokens: Tensor,
                  prefix_embeds: Optional[Tensor]) -> Tensor:
    x = M.embedding_apply(params["embed"], tokens, act_dtype(cfg))
    if _check_prefix(cfg, tokens, prefix_embeds):
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    if cfg.rope == "none":  # absolute sinusoid (whisper-style decoder)
        pos = torch.arange(x.shape[1], device=x.device)
        x = x + M.sinusoid(pos, cfg.d_model)[None].to(x.dtype)
    return x


def _forward(params: dict, cfg: ArchConfig, tokens: Tensor, *,
             prefix_embeds: Optional[Tensor], window: int, chunk_q: int,
             cache_len: int = 0
             ) -> Tuple[Tensor, Optional[Tensor], Optional[dict]]:
    """Embedding, the groups and the final norm: (hidden, the summed MoE
    auxiliary loss (None without MoE layers), the stacked cache if
    ``cache_len`` else None)."""
    x = _embed_inputs(params, cfg, tokens, prefix_embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    specs = layer_specs(cfg)
    groups = params["groups"]
    aux = None
    caches = []
    for g in range(n_groups(cfg)):
        gp = tree_map(lambda t: t[g], groups)
        aux_g, cache_g = None, {}
        for i, (mx, mk) in enumerate(specs):
            x, aux_l, cache_g[f"l{i}"] = _layer_apply(
                gp[f"l{i}"], x, cfg, mx, mk, positions=positions,
                window=window, chunk_q=chunk_q, cache_len=cache_len)
            if aux_l is not None:
                # the JAX package's order: per group 0 + a_l0 + a_l1 ...,
                # then the running total + the group's
                aux_g = aux_l if aux_g is None else aux_g + aux_l
        if aux_g is not None:
            aux = aux_g if aux is None else aux + aux_g
        if cache_len:
            caches.append(cache_g)
    x = M.norm_apply(cfg.norm, params["final_norm"], x)
    if not cache_len:
        return x, aux, None
    return x, aux, tree_map(lambda *xs: torch.stack(xs), *caches)


def apply_lm(params: dict, cfg: ArchConfig, tokens: Tensor, *,
             prefix_embeds: Optional[Tensor] = None, window: int = 0,
             chunk_q: int = 1024, logits_tail: int = 0,
             return_hidden: bool = False) -> Tuple[Tensor, Optional[Tensor]]:
    """Full-sequence forward: ``(logits, aux)``, or ``(hidden, aux)``
    after the final norm when ``return_hidden`` (the chunked loss does its
    own readout); ``aux`` is the MoE auxiliary loss, None without MoE
    layers.  ``logits_tail > 0`` reads out only the last positions (0:
    all)."""
    x, aux, _ = _forward(params, cfg, tokens, prefix_embeds=prefix_embeds,
                         window=window, chunk_q=chunk_q)
    if return_hidden:
        return x, aux
    if logits_tail:
        x = x[:, -logits_tail:]
    return _readout(params, cfg, x), aux


def _readout(params: dict, cfg: ArchConfig, x: Tensor) -> Tensor:
    if cfg.tie_embeddings:
        return M.embedding_attend(params["embed"], x)
    return M.linear_apply(params["lm_head"], x)


def lm_loss(params: dict, cfg: ArchConfig, batch: Dict[str, Tensor], *,
            window: int = 0, chunk_q: int = 1024,
            xent_chunk: int = 4096) -> Tensor:
    """Next-token cross entropy with a chunked readout, plus the MoE
    auxiliary loss.  batch: tokens, labels, optional prefix_embeds,
    optional loss_mask."""
    from repro_torch.models.losses import chunked_xent
    x, aux = apply_lm(params, cfg, batch["tokens"],
                      prefix_embeds=batch.get("prefix_embeds"),
                      window=window, chunk_q=chunk_q, return_hidden=True)
    labels = batch["labels"]
    n_prefix = x.shape[1] - labels.shape[1]
    if n_prefix > 0:
        x = x[:, n_prefix:]
    if cfg.tie_embeddings:
        rp, tied = {"embed": params["embed"]}, True
    else:
        rp, tied = {"lm_head": params["lm_head"]}, False
    loss = chunked_xent(x, labels, rp, tied=tied,
                        mask=batch.get("loss_mask"), chunk=xent_chunk)
    # without MoE layers the JAX package adds an exact 0
    return loss if aux is None else loss + aux


# ----------------------------------------------------------------- caches
def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               window: int = 0, device=None) -> dict:
    """Empty cache, stacked per group (leading axis ``n_groups``): a bf16
    KV cache for each attention layer, fp32 ``{conv, h}`` for each mamba
    mixer."""
    dev = resolve_device(device)
    group = {}
    for i, (mx, _) in enumerate(layer_specs(cfg)):
        if mx == "attn":
            group[f"l{i}"] = A.init_kv_cache(
                batch, window or cache_len, cfg.n_kv_heads,
                cfg.resolved_head_dim, device=dev)
        else:
            group[f"l{i}"] = S.init_mamba_cache(batch, cfg, device=dev)
    ng = n_groups(cfg)
    return tree_map(lambda t: t[None].repeat((ng,) + (1,) * t.dim()), group)


def prefill(params: dict, cfg: ArchConfig, tokens: Tensor, *,
            prefix_embeds: Optional[Tensor] = None, window: int = 0,
            chunk_q: int = 1024, cache_len: int = 0) -> Tuple[Tensor, dict]:
    """Process the prompt (B, S), after the prefix if one is given: (last
    position's logits (B, vocab), cache).  ``cache_len``, the cache's
    capacity (prefix, prompt and the decode steps to come), defaults to
    the prefilled length + 64; a ring buffer holds ``window``."""
    if not cache_len:
        cache_len = tokens.shape[1] + 64 + _check_prefix(cfg, tokens,
                                                          prefix_embeds)
    x, _, cache = _forward(params, cfg, tokens, prefix_embeds=prefix_embeds,
                           window=window, chunk_q=chunk_q,
                           cache_len=cache_len)
    x = x[:, -1:]
    return _readout(params, cfg, x)[:, 0], cache


def decode_step(params: dict, cfg: ArchConfig, token: Tensor, cache: dict,
                pos, *, window: int = 0, seq_chunks: int = 1,
                lane_capacity: bool = False) -> Tuple[Tensor, dict]:
    """One decode step.  token: (B,) ints; ``pos``: the absolute position
    (an int or a 0-d tensor) or a (B,) tensor of per-lane positions.
    ``lane_capacity`` gives an MoE layer's experts a slot for every lane
    (``moe.capacity``), so no lane's token drops.  Returns (logits (B,
    vocab), the updated cache, a new tree: ``cache`` is not written)."""
    x = M.embedding_apply(params["embed"], token[:, None], act_dtype(cfg))
    # once a step, on the device; no layer reads the position back
    pos = A.position(pos, x.device)
    if cfg.rope == "none":
        # the sinusoid of the current absolute position (of each lane's)
        x = x + M.sinusoid(pos, cfg.d_model).reshape(
            -1, 1, cfg.d_model).to(x.dtype)
    specs = layer_specs(cfg)
    groups = params["groups"]
    new = []
    for g in range(n_groups(cfg)):
        gp = tree_map(lambda t: t[g], groups)
        gc = tree_map(lambda t: t[g], cache)
        new_c = {}
        for i, (mx, mk) in enumerate(specs):
            lp, lc = gp[f"l{i}"], gc[f"l{i}"]
            h = M.norm_apply(cfg.norm, lp["norm1"], x)
            if mx == "attn":
                out, new_c[f"l{i}"] = A.attend_cached(
                    lp["attn"], h, lc, pos, cfg, window=window,
                    seq_chunks=seq_chunks)
            else:
                out, new_c[f"l{i}"] = S.mamba_step(lp["mamba"], h, lc, cfg)
            x, _ = _mlp_block(lp, x + out, cfg, mk,
                              lane_capacity=lane_capacity)
        new.append(new_c)
    x = M.norm_apply(cfg.norm, params["final_norm"], x)
    return _readout(params, cfg, x)[:, 0], \
        tree_map(lambda *xs: torch.stack(xs), *new)
