"""GQA self attention with RoPE, full sequences (cf. ``repro.models.attention``).

Only :func:`attend_full` (training) is ported; the cached decode and cross
attention paths wait for the serving slice.
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
