"""Dense MLP blocks: swiglu (qwen), squared-relu, gelu (cf. ``repro.models.mlp``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import modules as M


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             activation: str) -> dict:
    p = {
        "in": M.linear_init(gen, d_model, d_ff),
        "out": M.linear_init(gen, d_ff, d_model),
    }
    if activation == "swiglu":
        p["gate"] = M.linear_init(gen, d_model, d_ff)
    return p


def mlp_apply(p: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "swiglu":
        h = F.silu(M.linear_apply(p["gate"], x)) * M.linear_apply(p["in"], x)
    else:
        h = M.ACTIVATIONS[activation](M.linear_apply(p["in"], x))
    return M.linear_apply(p["out"], h)
