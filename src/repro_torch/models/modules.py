"""Functional building blocks over nested-dict parameters (cf.
``repro.models.modules``).

Each module is ``<name>_init(gen, ...) -> params`` and
``<name>_apply(params, x, ...) -> y``.  Layouts are the JAX package's: a
linear ``w`` is ``(d_in, d_out)``, so a JAX tree converts leaf for leaf.
Parameters are fp32; activations take the type of the input (the model
casts at the embedding, ``cfg.dtype``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def truncated_normal(gen: torch.Generator, shape, stddev: float) -> Tensor:
    """N(0, 1) truncated to [-2, 2], scaled by ``stddev`` (fp32, on the
    generator's device)."""
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(stddev)


# ----------------------------------------------------------------- linear
def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, stddev: Optional[float] = None) -> dict:
    if stddev is None:
        stddev = 1.0 / math.sqrt(d_in)
    p = {"w": truncated_normal(gen, (d_in, d_out), stddev)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=gen.device)
    return p


def linear_apply(p: dict, x: Tensor) -> Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# -------------------------------------------------------------- embedding
def embedding_init(gen: torch.Generator, vocab: int, d: int) -> dict:
    # ~N(0, 1/sqrt(d)): keeps tied-readout logits O(1) at init
    return {"table": truncated_normal(gen, (vocab, d), 1.0 / math.sqrt(d))}


def embedding_apply(p: dict, ids: Tensor, dtype: torch.dtype) -> Tensor:
    # cast, then gather (as the JAX package does): the table's gradient is
    # accumulated in ``dtype`` and cast back, like the reference's
    return p["table"].to(dtype)[ids]


def embedding_attend(p: dict, x: Tensor) -> Tensor:
    """Tied readout: x @ table.T (its own cast of the table)."""
    return x @ p["table"].to(x.dtype).T


def sinusoid(pos: Tensor, d: int) -> Tensor:
    """Classic transformer sinusoids of absolute positions ``pos`` (any
    shape, on its device): (..., d) fp32, sines then cosines."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    inv = torch.exp(-math.log(10000.0) * 2.0 * dim / d)
    ang = pos.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(n: int, d: int, device=None) -> Tensor:
    """The (n, d) fp32 sinusoid table of positions 0 … n-1 (the whisper
    encoder's and decoder's)."""
    return sinusoid(torch.arange(n, device=device), d)


# ------------------------------------------------------------------ norms
def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm_apply(p: dict, x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm_apply(p: dict, x: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def norm_init(kind: str, d: int, device) -> dict:
    return rmsnorm_init(d, device) if kind == "rmsnorm" \
        else layernorm_init(d, device)


def norm_apply(kind: str, p: dict, x: Tensor) -> Tensor:
    return rmsnorm_apply(p, x) if kind == "rmsnorm" else layernorm_apply(p, x)


# ------------------------------------------------------------ activations
def relu2(x: Tensor) -> Tensor:
    """Squared ReLU (nemotron-4)."""
    r = F.relu(x)
    return r * r


def _gelu(x: Tensor) -> Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "gelu": _gelu,
    "silu": F.silu,
    "relu2": relu2,
    "relu": F.relu,
}
