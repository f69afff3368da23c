"""Mixture-of-Experts layer (qwen3-moe 128e/top-8, jamba 16e/top-2; cf.
``repro.models.moe``).

Dispatch is capacity-based gather/scatter, as in the JAX package: each
expert holds ``C = capacity(T)`` slots, a token's position in its expert
comes from a cumulative count over the token-major ``(T·k)`` stream, and
tokens overflowing an expert's capacity are dropped (their slots combine
as zeros, so the residual passes through).  The same tokens drop as in
JAX.  A microbatched decode (``serve.batching``) asks for ``lane_capacity``:
each of its T lane tokens is one request, which the JAX package decodes
alone, so an expert gets at least T slots and no lane token drops.

Both directions between tokens and slots are gathers, so the layer's
forward and backward are the same bits from run to run on CUDA, where a
scatter-add with repeated indices sums in an order that varies:

* the combine: each token gathers its k slots (a dropped one reads the
  zero sentinel row) and sums them in slot order;
* the dispatch's backward (:class:`_Dispatch`): each token gathers its k
  slots' gradients and sums them in slot order.

The scatters left write to unique slots.  JAX's scatter-add sums a token's
slots in its own order, so the two packages agree within fp32 rounding.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models import modules as M

Tensor = torch.Tensor


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             activation: str) -> dict:
    e, dff = cfg.n_experts, cfg.d_expert
    std_in = 1.0 / math.sqrt(d_model)
    std_out = 1.0 / math.sqrt(dff)
    p = {
        "router": M.linear_init(gen, d_model, e, stddev=0.02),
        # expert-stacked weights: leading E axis
        "w_in": M.truncated_normal(gen, (e, d_model, dff), std_in),
        "w_out": M.truncated_normal(gen, (e, dff, d_model), std_out),
    }
    if activation == "swiglu":
        p["w_gate"] = M.truncated_normal(gen, (e, d_model, dff), std_in)
    return p


def capacity(n_tokens: int, cfg: MoEConfig, *,
             lane_capacity: bool = False) -> int:
    """Slots an expert holds for ``n_tokens`` tokens.  With
    ``lane_capacity`` at least ``n_tokens``: a token sends at most one
    entry to an expert (top-k picks distinct experts), so none drops, as
    none drops from a one-token dispatch; up to 8 tokens that is the
    plain capacity."""
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    c = max(8, -(-c // 8) * 8)  # a multiple of 8, as in the JAX package
    return max(c, n_tokens) if lane_capacity else c


def _gather_slots(rows: Tensor, dest: Tensor,
                  gate: Optional[Tensor] = None) -> Tensor:
    """(S, d) slot rows, (T, k) slot indices in [0, S] ascending along k
    -> (T, d): each token's rows (times its ``gate``, if given) summed in
    slot order, S the zero sentinel."""
    pad = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))], dim=0)
    g = pad[dest]                                        # (T, k, d)
    if gate is not None:
        g = g * gate[..., None]
    out = g[:, 0]
    for j in range(1, dest.shape[1]):
        out = out + g[:, j]
    return out


class _Dispatch(torch.autograd.Function):
    """Token rows into expert slots: ``xpad[slot_token]``.  The backward
    gathers each token's k slot gradients (:func:`_gather_slots`) where
    autograd would scatter-add them."""

    @staticmethod
    def forward(ctx, xf: Tensor, slot_token: Tensor, dest: Tensor) -> Tensor:
        ctx.save_for_backward(dest)
        pad = torch.cat([xf, xf.new_zeros((1, xf.shape[1]))], dim=0)
        return pad[slot_token]

    @staticmethod
    def backward(ctx, grad: Tensor):
        (dest,) = ctx.saved_tensors
        return _gather_slots(grad, dest), None, None


def route(xf: Tensor, router: dict, cfg: MoEConfig, *,
          lane_capacity: bool = False):
    """Router, top-k and the slot assignment of (T, d) tokens
    (``lane_capacity`` as in :func:`capacity`).

    Returns ``(gate (T, k) fp32 renormalised, expert_ids (T, k), dest
    (T·k,) slot of each stream entry with E·C for a dropped one, aux)``.
    """
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(t, cfg, lane_capacity=lane_capacity)
    logits = M.linear_apply(router, xf).float()                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, expert_ids = torch.topk(probs, k, dim=-1)              # (T, k)
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)

    # load-balance auxiliary loss (Switch-style)
    density = torch.mean(torch.sum(
        F.one_hot(expert_ids, e).float(), dim=1), dim=0)        # (E,)
    mean_prob = torch.mean(probs, dim=0)
    aux = cfg.aux_loss_weight * e * torch.sum(density / k * mean_prob)

    # position-in-expert from the cumulative count over the (T*k) stream
    eid = expert_ids.reshape(t * k)
    onehot = F.one_hot(eid, e)                                   # (T*k, E)
    pos_in_e = torch.sum(torch.cumsum(onehot, dim=0) * onehot, dim=1) - 1
    dest = torch.where(pos_in_e < c, eid * c + pos_in_e,
                       torch.full_like(eid, e * c))
    return gate, expert_ids, dest, aux


def moe_apply(p: dict, x: Tensor, cfg: MoEConfig, activation: str, *,
              lane_capacity: bool = False) -> Tuple[Tensor, Tensor]:
    """x: (B, S, d) -> (y (B, S, d), aux_loss scalar fp32);
    ``lane_capacity`` as in :func:`capacity`."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(t, cfg, lane_capacity=lane_capacity)
    gate, _, dest, aux = route(xf, p["router"], cfg,
                               lane_capacity=lane_capacity)

    # slot -> token index (sentinel t for an empty slot); every kept
    # stream entry owns its slot, the dropped ones all land on slot E*C,
    # which is cut off
    token_of = torch.arange(t * k, device=x.device) // k
    slot_token = torch.full((e * c + 1,), t, dtype=torch.long,
                            device=x.device)
    slot_token = slot_token.index_put((dest,), token_of)[: e * c]

    # each token's k slots in ascending slot order (its dropped ones,
    # E*C, last), and its gates in that order
    dest_tk, order = torch.sort(dest.reshape(t, k), dim=1, stable=True)
    gate_tk = torch.gather(gate, 1, order)

    expert_in = _Dispatch.apply(xf, slot_token, dest_tk).reshape(e, c, d)
    w_in = p["w_in"].to(x.dtype)
    w_out = p["w_out"].to(x.dtype)
    if activation == "swiglu":
        g = torch.bmm(expert_in, p["w_gate"].to(x.dtype))
        h = F.silu(g) * torch.bmm(expert_in, w_in)
    else:
        h = M.ACTIVATIONS[activation](torch.bmm(expert_in, w_in))
    expert_out = torch.bmm(h, w_out).reshape(e * c, d)          # (E*C, d)

    # combine: the gate cast to the activation type before the multiply
    # (as in the JAX package), each token's slots summed in slot order
    y = _gather_slots(expert_out, dest_tk, gate_tk.to(x.dtype))
    return y.reshape(b, s, d), aux
