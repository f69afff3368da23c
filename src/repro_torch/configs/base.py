"""Configuration for the port (own copy of ``repro.configs.base``).

* :class:`ArchConfig` — an architecture description, copied from the JAX
  package so configs and their ``reduced()`` variants mean the same thing
  on both sides; :class:`MoEConfig`, :class:`SSMConfig` and
  :class:`HybridConfig` are its family sub-configs.
* :class:`RobustConfig` — the paper's technique (n workers, f byzantine,
  which GAR), validated against the port's own GAR registry.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    n_experts: int
    top_k: int
    d_expert: int              # per-expert hidden size
    capacity_factor: float = 1.25
    every: int = 1             # MoE replaces the MLP every `every` layers
    aux_loss_weight: float = 0.01  # router load-balance auxiliary loss


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective state space configuration."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0           # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank > 0 else max(1, math.ceil(d_model / 16))


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Jamba-style attention/Mamba interleave.

    A block of ``period`` layers contains one attention layer at index
    ``attn_index`` (the rest are Mamba mixers).
    """

    period: int = 8
    attn_index: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """An architecture, field for field as in the JAX package, less the
    mesh-only ``sharding_strategy``, ``long_context_window`` and
    ``attn_window``."""

    # identification
    name: str
    family: str                        # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                   # citation for the config values

    # transformer backbone
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: int = 0                  # 0 -> d_model // n_heads

    # flavour knobs
    activation: str = "swiglu"         # swiglu | relu2 | gelu
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope: str = "full"                 # full | partial | none
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0         # fraction of head_dim that rotates

    # family-specific sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None

    # encoder (audio enc-dec): shares d_model / n_heads with the decoder
    n_encoder_layers: int = 0
    n_frames: int = 0                  # stub audio frontend: frames fed to encoder
    n_patches: int = 0                 # stub vision frontend: patches prefixed to LM

    # the activation type; the JAX package casts activations to bf16 at
    # the embedding whatever this says, the port honours it.  Parameters
    # are fp32.
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim > 0 else self.d_model // self.n_heads

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def moe_layer_indices(self) -> Tuple[int, ...]:
        if self.moe is None:
            return ()
        return tuple(
            i for i in range(self.n_layers) if (i % self.moe.every) == self.moe.every - 1
        )

    def param_count(self) -> int:
        """Analytic parameter count; equals the materialised model's
        (``tests/test_torch_archs.py``)."""
        d, v = self.d_model, self.vocab_size
        ns = (2 if self.norm == "layernorm" else 1) * d   # norm params
        total = v * d                         # embedding
        if not self.tie_embeddings:
            total += v * d                    # lm head
        for i in range(self.n_layers):
            n_norms = 1 + (1 if self._mlp_params(i) else 0)
            total += self._mixer_params(i) + self._mlp_params(i) + n_norms * ns
        total += ns                           # final norm
        if self.is_encdec:
            for _ in range(self.n_encoder_layers):
                total += self._attn_params() + self._dense_mlp_params() + 2 * ns
            total += ns                       # encoder output norm
            total += self.n_layers * (self._attn_params() + ns)  # cross + norm_x
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        e = self.moe
        per_expert = 3 * d * e.d_expert
        dense = self.param_count() - len(self.moe_layer_indices()) * (
            e.n_experts * per_expert
        )
        return dense + len(self.moe_layer_indices()) * e.top_k * per_expert

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        b = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + b

    def _mamba_params(self) -> int:
        assert self.ssm is not None
        d = self.d_model
        di = self.ssm.expand * d
        dtr = self.ssm.resolved_dt_rank(d)
        st = self.ssm.d_state
        return (
            d * 2 * di              # in_proj
            + di * self.ssm.d_conv + di  # depthwise conv (w + b)
            + di * (dtr + 2 * st)   # x_proj
            + dtr * di + di         # dt_proj
            + di * st + di          # A_log, D
            + di * d                # out_proj
        )

    def _mixer_params(self, layer: int) -> int:
        if self.family == "ssm":
            return self._mamba_params()
        if self.family == "hybrid":
            assert self.hybrid is not None
            if layer % self.hybrid.period == self.hybrid.attn_index:
                return self._attn_params()
            return self._mamba_params()
        return self._attn_params()

    def _dense_mlp_params(self) -> int:
        mults = 3 if self.activation == "swiglu" else 2
        return mults * self.d_model * self.d_ff

    def _mlp_params(self, layer: int) -> int:
        if self.family == "ssm":
            return 0  # mamba1 blocks have no separate MLP
        if self.moe is not None and layer in self.moe_layer_indices():
            e = self.moe
            return e.n_experts * 3 * self.d_model * e.d_expert + self.d_model * e.n_experts
        if self.d_ff == 0:
            return 0
        return self._dense_mlp_params()

    def reduced(self) -> "ArchConfig":
        """Reduced same-family variant for CPU smoke tests (as in JAX).

        2 layers (one hybrid period when hybrid), d_model<=256, <=4 experts.
        """
        kw: dict = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=min(self.d_model, 256),
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=0,
        )
        if self.moe is not None:
            # capacity_factor 8: no token drops, so prefill+decode agree
            # exactly with the full forward in the smoke tests
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                d_expert=128, capacity_factor=8.0
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, dt_rank=16)
        if self.hybrid is not None:
            # one block period of 2: attn at index 1, mamba at 0
            kw["hybrid"] = HybridConfig(period=2, attn_index=1)
            kw["n_layers"] = 2
        if self.is_encdec:
            kw["n_encoder_layers"] = 2
            kw["n_frames"] = 16
        if self.n_patches:
            kw["n_patches"] = 8
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Parameters of the paper's technique.

    ``use_kernels`` routes the statistics and the multi-Bulyan apply
    through the hand-written CUDA kernels for CUDA tensors (their plain
    PyTorch versions for CPU tensors).  ``grouped`` marks a hierarchical
    aggregation (``repro_torch.hier``): its per-level budget check
    (``core.theory.split_f_budget``) owns feasibility, so the flat rule's
    ``min_n`` is not checked (a grouped (n, f) may be flat-infeasible).
    """

    n_workers: int = 16
    f: int = 3
    gar: str = "multi_bulyan"
    use_kernels: bool = True
    grouped: bool = False

    def __post_init__(self):
        self.validate()

    def validate(self) -> "RobustConfig":
        """Enforce the paper's resilience preconditions at construction:
        Krum-family rules need n >= 2f+3, Bulyan-family n >= 4f+3 (not
        checked when ``grouped``)."""
        if self.n_workers <= 0:
            raise ValueError(f"n_workers must be positive, got {self.n_workers}")
        if self.f < 0:
            raise ValueError(f"f must be nonnegative, got {self.f}")
        if self.f >= self.n_workers:
            raise ValueError(
                f"need more workers than byzantine ones "
                f"(n={self.n_workers}, f={self.f})")
        from repro_torch.core.api import get_aggregator
        try:
            rule = get_aggregator(self.gar)
        except KeyError as e:
            raise ValueError(e.args[0]) from None
        if not self.grouped:
            rule.validate(self.n_workers, self.f)
        return self
