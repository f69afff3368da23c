"""Mamba-1 selective state-space mixer (falcon-mamba-7b, jamba mixers; cf.
``repro.models.ssm``).

The recurrence ``h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t x_t`` runs as a
chunked scan, as in the JAX package: a loop over sequence chunks of 256
carries the (B, d_i, d_state) state, and inside a chunk a log-depth scan
combines ``(decay, inp)`` pairs by doubling steps (``ceil(log2 C)`` steps
of a few tensor operations each, not a loop over time).  The doubling
scan associates the products in another order than
``lax.associative_scan``'s tree, so the two agree within fp32 rounding,
not bit for bit.

Decode is the O(1) single-step update with a (conv window, ssm state)
cache.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.models import modules as M

Tensor = torch.Tensor

#: the scan's chunk length, as the JAX package's
CHUNK = 256


def mamba_init(gen: torch.Generator, cfg: ArchConfig) -> dict:
    ssm = cfg.ssm
    assert ssm is not None
    d = cfg.d_model
    di = ssm.expand * d
    dtr = ssm.resolved_dt_rank(d)
    st = ssm.d_state
    dev = gen.device
    # S4D-real initialisation of A
    a = torch.arange(1, st + 1, dtype=torch.float32,
                     device=dev)[None].expand(di, st)
    # bias so that softplus(b) spans [1e-3, 1e-1], the standard mamba init
    u = torch.empty((di,), dtype=torch.float32, device=dev)
    u.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
    p = {
        "in_proj": M.linear_init(gen, d, 2 * di),
        "conv_w": M.truncated_normal(gen, (ssm.d_conv, di),
                                     1.0 / math.sqrt(ssm.d_conv)),
        "conv_b": torch.zeros((di,), dtype=torch.float32, device=dev),
        "x_proj": M.linear_init(gen, di, dtr + 2 * st),
        "dt_proj": {
            "w": M.truncated_normal(gen, (dtr, di), dtr ** -0.5),
            "b": torch.log(torch.expm1(torch.exp(u))),
        },
        "A_log": torch.log(a),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": M.linear_init(gen, di, d),
    }
    return p


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 history: Optional[Tensor] = None) -> Tensor:
    """Depthwise causal conv1d.  x: (B, S, di); w: (K, di).  ``history``:
    an optional (B, K-1, di) left context (the decode path)."""
    k = w.shape[0]
    if history is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = history.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                          # (B, S+K-1, di)
    s = x.shape[1]
    out = xp[:, 0:s].float() * w[0].float()
    for i in range(1, k):  # K taps, unrolled, in fp32
        out = out + xp[:, i:i + s].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _ssm_inputs(p: dict, xc: Tensor, ssm: SSMConfig, d_model: int
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Shared projections: xc (B, S, di) -> (decay, inp (B, S, di, st),
    C (B, S, st)), fp32."""
    dtr = ssm.resolved_dt_rank(d_model)
    st = ssm.d_state
    proj = M.linear_apply(p["x_proj"], xc)                   # (B, S, dtr+2st)
    dt_low, b_mat, c_mat = torch.split(proj, [dtr, st, st], dim=-1)
    dt = F.softplus(dt_low.float() @ p["dt_proj"]["w"]
                    + p["dt_proj"]["b"])                     # (B, S, di)
    a = -torch.exp(p["A_log"])                               # (di, st)
    decay = torch.exp(dt[..., None] * a)                     # (B, S, di, st)
    inp = (dt * xc.float())[..., None] * b_mat.float()[:, :, None, :]
    return decay, inp, c_mat.float()


def _scan_chunk(h0: Tensor, decay: Tensor, inp: Tensor
                ) -> Tuple[Tensor, Tensor]:
    """Inclusive scan of ``h_t = decay_t h_{t-1} + inp_t`` within a chunk
    by doubling: after the step of offset o each position holds the
    combination of the 2o entries ending there.  h0: (B, di, st); decay,
    inp: (B, C, di, st).  Returns (h_all (B, C, di, st), h_last)."""
    d_cum, x_cum = decay, inp
    off = 1
    while off < decay.shape[1]:
        x_cum = torch.cat([x_cum[:, :off],
                           x_cum[:, :-off] * d_cum[:, off:] + x_cum[:, off:]],
                          dim=1)
        d_cum = torch.cat([d_cum[:, :off], d_cum[:, :-off] * d_cum[:, off:]],
                          dim=1)
        off *= 2
    h_all = x_cum + d_cum * h0[:, None]
    return h_all, h_all[:, -1]


def _scan(decay: Tensor, inp: Tensor) -> Tuple[Tensor, Tensor]:
    """The whole sequence's states from h = 0: chunks of CHUNK (when the
    sequence is a multiple longer than one) carry the state across.
    Returns (h_seq (B, S, di, st), h_last)."""
    b, s, di, st = decay.shape
    h = decay.new_zeros((b, di, st))
    if s > CHUNK and s % CHUNK == 0:
        outs = []
        for c0 in range(0, s, CHUNK):
            h_all, h = _scan_chunk(h, decay[:, c0:c0 + CHUNK],
                                   inp[:, c0:c0 + CHUNK])
            outs.append(h_all)
        return torch.cat(outs, dim=1), h
    return _scan_chunk(h, decay, inp)


def _output(p: dict, h_seq: Tensor, c_mat: Tensor, xc: Tensor, z: Tensor,
            dtype: torch.dtype) -> Tensor:
    y = torch.sum(h_seq * c_mat[:, :, None, :], dim=-1)      # (B, S, di)
    y = y + p["D"].float() * xc.float()
    y = y * F.silu(z.float())
    return M.linear_apply(p["out_proj"], y.to(dtype))


def mamba_apply(p: dict, x: Tensor, cfg: ArchConfig, *,
                emit_cache: bool = False):
    """Full-sequence mixer (train / prefill).  x: (B, S, d).  Returns the
    output, or ``(output, cache)`` with ``emit_cache``: the decode cache
    after the sequence, ``{"conv": the last K-1 pre-conv inputs (fp32),
    "h": the final state}``, from this pass (the JAX package's
    ``_mamba_prefill_cache`` recomputes the same values in a second
    pass)."""
    ssm = cfg.ssm
    assert ssm is not None
    xz = M.linear_apply(p["in_proj"], x)
    x_raw, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(_causal_conv(x_raw, p["conv_w"], p["conv_b"]))
    decay, inp, c_mat = _ssm_inputs(p, xc, ssm, cfg.d_model)
    h_seq, h_last = _scan(decay, inp)
    out = _output(p, h_seq, c_mat, xc, z, x.dtype)
    if not emit_cache:
        return out
    conv = x_raw[:, -(ssm.d_conv - 1):].float()
    return out, {"conv": conv, "h": h_last}


# ------------------------------------------------------------------ decode
def init_mamba_cache(batch: int, cfg: ArchConfig, device=None) -> dict:
    """The empty decode cache of one mixer, fp32 as the JAX package's."""
    ssm = cfg.ssm
    di = ssm.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, ssm.d_conv - 1, di), dtype=torch.float32,
                            device=device),
        "h": torch.zeros((batch, di, ssm.d_state), dtype=torch.float32,
                         device=device),
    }


def mamba_step(p: dict, x: Tensor, cache: dict, cfg: ArchConfig
               ) -> Tuple[Tensor, dict]:
    """Single-token decode.  x: (B, 1, d).  Returns (y (B, 1, d), the new
    cache; ``cache`` is not written)."""
    ssm = cfg.ssm
    xz = M.linear_apply(p["in_proj"], x)
    x_raw, z = torch.chunk(xz, 2, dim=-1)                    # pre-conv input
    xc = F.silu(_causal_conv(x_raw, p["conv_w"], p["conv_b"],
                             history=cache["conv"]))
    new_conv = torch.cat(
        [cache["conv"][:, 1:], x_raw.to(cache["conv"].dtype)], dim=1
    ) if ssm.d_conv > 1 else cache["conv"]
    decay, inp, c_mat = _ssm_inputs(p, xc, ssm, cfg.d_model)
    h = decay[:, 0] * cache["h"] + inp[:, 0]                 # (B, di, st)
    y = _output(p, h[:, None], c_mat, xc, z, x.dtype)
    return y, {"conv": new_conv, "h": h}
