"""GQA self attention with RoPE and KV caches (cf. ``repro.models.attention``).

* :func:`attend_full`   — training / prefill self attention over a whole
  sequence, query-chunked.
* :func:`attend_cached` — one-token decode against a KV cache: a full cache
  or a sliding-window ring buffer (slot of absolute position p is
  ``p % window``), with an optional flash-style partial softmax over
  ``seq_chunks`` blocks of the cache.

* :func:`cross_kv` / :func:`attend_cross` — the encoder-decoder's cross
  attention: K/V of the encoder memory (computed once at prefill), then
  non-causal attention of the decoder's queries over the whole memory.

Self-attention caches are bf16 whatever the activation type, as in the
JAX package; the cross K/V keep the activation type.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import modules as M

Tensor = torch.Tensor

_NEG = -1e30  # additive mask value (fp32 logits)


def rope_freqs(head_dim: int, fraction: float, theta: float,
               device=None) -> Tensor:
    """Inverse frequencies for the rotating sub-dimension."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, cfg: ArchConfig) -> Tensor:
    """Rotate ``x`` (..., S, H, head_dim) by absolute ``positions`` (..., S)
    (half-split layout; ``partial`` rotates ``rope_fraction`` of it)."""
    if cfg.rope == "none":
        return x
    hd = x.shape[-1]
    fraction = 1.0 if cfg.rope == "full" else cfg.rope_fraction
    inv = rope_freqs(hd, fraction, cfg.rope_theta, device=x.device)
    rot = 2 * inv.shape[0]
    ang = positions[..., None].float() * inv             # (..., S, rot/2)
    sin = torch.sin(ang)[..., None, :]                   # (..., S, 1, rot/2)
    cos = torch.cos(ang)[..., None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1f = xr[..., : rot // 2].float()
    x2f = xr[..., rot // 2:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                    dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if xp.shape[-1] else out


def attn_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    bias = cfg.qkv_bias
    return {
        "q": M.linear_init(gen, d, cfg.n_heads * hd, bias=bias),
        "k": M.linear_init(gen, d, cfg.n_kv_heads * hd, bias=bias),
        "v": M.linear_init(gen, d, cfg.n_kv_heads * hd, bias=bias),
        "o": M.linear_init(gen, cfg.n_heads * hd, d, bias=False,
                           stddev=1.0 / math.sqrt(
                               cfg.n_heads * hd * 2 * cfg.n_layers)),
    }


def _split_heads(x: Tensor, n_heads: int) -> Tensor:
    return x.reshape(x.shape[:-1] + (n_heads, x.shape[-1] // n_heads))


def project_qkv(p: dict, x: Tensor, cfg: ArchConfig,
                positions: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """x (B, S, d) -> q (B, S, H, hd), k/v (B, S, Hkv, hd), roped."""
    q = _split_heads(M.linear_apply(p["q"], x), cfg.n_heads)
    k = _split_heads(M.linear_apply(p["k"], x), cfg.n_kv_heads)
    v = _split_heads(M.linear_apply(p["v"], x), cfg.n_kv_heads)
    if positions is not None:
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)
    return q, k, v


def _expand_kv(k: Tensor, n_heads: int) -> Tensor:
    """(B, S, Hkv, hd) -> (B, S, H, hd) by group broadcast."""
    b, s, hkv, hd = k.shape
    rep = n_heads // hkv
    return k[:, :, :, None, :].expand(b, s, hkv, rep, hd).reshape(
        b, s, n_heads, hd)


def attend_full(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                window: int = 0, chunk_q: int = 1024) -> Tensor:
    """Self attention over full sequences, query-chunked, fp32 logits.

    q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd).  Returns (B, Sq, H, hd).
    ``window > 0`` keeps each query's ``window`` most recent keys.
    """
    n_heads = q.shape[2]
    k = _expand_kv(k, n_heads)
    v = _expand_kv(v, n_heads)
    sq, hd = q.shape[1], q.shape[3]
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    kt = k.permute(0, 2, 3, 1).float()                  # (B, H, hd, Sk)
    vt = v.permute(0, 2, 1, 3).float()                  # (B, H, Sk, hd)
    kpos = torch.arange(sk, device=q.device)
    outs = []
    for q0 in range(0, sq, chunk_q):
        qc = q[:, q0:q0 + chunk_q]
        cq = qc.shape[1]
        qct = qc.permute(0, 2, 1, 3).float()            # (B, H, cq, hd)
        logits = torch.matmul(qct, kt) * scale           # (B, H, cq, Sk)
        qpos = q0 + torch.arange(cq, device=q.device)
        mask = torch.ones((cq, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        logits = torch.where(mask[None, None], logits,
                             torch.full_like(logits, _NEG))
        probs = torch.softmax(logits, dim=-1)
        out = torch.matmul(probs, vt)                    # (B, H, cq, hd)
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# ------------------------------------------------------------------ cross
def attend_cross(p: dict, x: Tensor, memory_kv: Tuple[Tensor, Tensor],
                 cfg: ArchConfig) -> Tensor:
    """Cross attention of x (B, S, d) against precomputed encoder K/V
    (B, Sm, Hkv, hd): every query sees the whole memory."""
    b, s, _ = x.shape
    q = _split_heads(M.linear_apply(p["q"], x), cfg.n_heads)
    k, v = memory_kv
    out = attend_full(q, k, v, causal=False, chunk_q=max(s, 1))
    return M.linear_apply(p["o"], out.reshape(b, s, -1))


def cross_kv(p: dict, memory: Tensor, cfg: ArchConfig
             ) -> Tuple[Tensor, Tensor]:
    """Cross-attention K/V (B, Sm, Hkv, hd) of the encoder output."""
    k = _split_heads(M.linear_apply(p["k"], memory), cfg.n_kv_heads)
    v = _split_heads(M.linear_apply(p["v"], memory), cfg.n_kv_heads)
    return k, v


# ---------------------------------------------------------- cached decode
def cache_from_prefill(k: Tensor, v: Tensor, cache_len: int, window: int,
                       dtype: torch.dtype = torch.bfloat16) -> dict:
    """Pack prompt K/V (B, S, Hkv, hd) into a decode cache.

    Full cache: slots [0, S) of a ``cache_len``-slot buffer.  Ring buffer:
    the last ``min(window, S)`` tokens in their ring slots ``p % window``.
    """
    b, s = k.shape[:2]
    if window:
        keep = min(window, s)
        kw = torch.zeros((b, window) + tuple(k.shape[2:]), dtype=dtype,
                         device=k.device)
        vw = torch.zeros_like(kw)
        slots = torch.arange(s - keep, s, device=k.device) % window
        kw[:, slots] = k[:, s - keep:].to(dtype)
        vw[:, slots] = v[:, s - keep:].to(dtype)
        return {"k": kw, "v": vw}
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} < prompt length {s}")
    kc = torch.zeros((b, cache_len) + tuple(k.shape[2:]), dtype=dtype,
                     device=k.device)
    vc = torch.zeros_like(kc)
    kc[:, :s] = k.to(dtype)
    vc[:, :s] = v.to(dtype)
    return {"k": kc, "v": vc}


def init_kv_cache(batch: int, length: int, n_kv: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Cache for one attention layer.  ``length`` is the max context (full
    cache) or the window size (ring buffer)."""
    shape = (batch, length, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def position(pos, device) -> Tensor:
    """A decode position as a 0-d int64 tensor on ``device``.  An int is
    written by a fill on the device: no host-to-device copy, which would
    wait for the queued work."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.long).reshape(())
    return torch.full((), pos, dtype=torch.long, device=device)


def attend_cached(p: dict, x: Tensor, cache: dict, pos, cfg: ArchConfig, *,
                  window: int = 0, seq_chunks: int = 1
                  ) -> Tuple[Tensor, dict]:
    """One-token decode.  x: (B, 1, d); ``pos``: the absolute position, an
    int or a 0-d integer tensor (never read on the host).

    Full cache (window == 0): write at slot ``pos``, attend to [0, pos].
    Ring buffer (window > 0): write at ``pos % window``; slot validity is
    reconstructed from the absolute position each slot holds.  Returns
    ``(y (B, 1, d), updated cache)``: the cache is written out of place,
    so the caller's cache (or a replica stack sharing its storage) is left
    as it was.
    """
    bsz = x.shape[0]
    pos = position(pos, x.device)
    q, k_new, v_new = project_qkv(p, x, cfg,
                                  positions=pos.expand(bsz, 1))
    slot = (pos % window if window else pos).reshape(1)
    k = cache["k"].index_copy(1, slot, k_new.to(cache["k"].dtype))
    v = cache["v"].index_copy(1, slot, v_new.to(cache["v"].dtype))

    length = k.shape[1]
    sidx = torch.arange(length, device=x.device)
    if window:
        # absolute position held by slot s after the write at `pos`
        # (floor modulo: torch's % on tensors, not fmod)
        abs_pos = pos - torch.remainder(pos - sidx, window)
        valid = abs_pos >= 0                     # since abs_pos <= pos
    else:
        valid = sidx <= pos

    n_heads = cfg.n_heads
    hd = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(hd)
    if seq_chunks > 1 and length % seq_chunks == 0:
        # flash-style partial softmax over seq chunks, grouped-query
        # einsums (no expanded copy of the cache)
        lc = length // seq_chunks
        hkv = cfg.n_kv_heads
        rep = n_heads // hkv
        kc = k.float().reshape(bsz, seq_chunks, lc, hkv, hd)
        vc = v.float().reshape(bsz, seq_chunks, lc, hkv, hd)
        qg = q.float().reshape(bsz, 1, hkv, rep, hd)
        logits = torch.einsum("bqgrd,bckgd->bgrck", qg, kc) * scale
        vmask = valid.reshape(seq_chunks, lc)[None, None, None]
        logits = torch.where(vmask, logits, torch.full_like(logits, _NEG))
        m_c = torch.amax(logits, dim=-1)                     # (B,g,r,c)
        e = torch.exp(logits - m_c[..., None])
        e = torch.where(vmask, e, torch.zeros_like(e))
        s_c = torch.sum(e, dim=-1)                           # (B,g,r,c)
        o_c = torch.einsum("bgrck,bckgd->bgrcd", e, vc)      # (B,g,r,c,hd)
        m_g = torch.amax(m_c, dim=-1, keepdim=True)
        w_c = torch.exp(m_c - m_g)                           # (B,g,r,c)
        denom = torch.sum(w_c * s_c, dim=-1)                 # (B,g,r)
        out = torch.sum(w_c[..., None] * o_c, dim=3) / denom[..., None]
        out = out.reshape(bsz, n_heads, hd).to(x.dtype)[:, None]
    else:
        ke = _expand_kv(k, n_heads).float()                  # (B, L, H, hd)
        ve = _expand_kv(v, n_heads).float()
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), ke) * scale
        logits = torch.where(valid[None, None, None], logits,
                             torch.full_like(logits, _NEG))
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, ve).to(x.dtype)
    y = M.linear_apply(p["o"], out.reshape(bsz, 1, -1))
    return y, {"k": k, "v": v}
