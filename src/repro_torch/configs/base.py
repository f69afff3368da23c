"""Configuration for the port (own copy of ``repro.configs.base``).

* :class:`ArchConfig` — an architecture description, copied from the JAX
  package so configs and their ``reduced()`` variants mean the same thing
  on both sides.
* :class:`RobustConfig` — the paper's technique (n workers, f byzantine,
  which GAR), validated against the port's own GAR registry.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """An architecture, field for field as in the JAX package's dense
    subset (the MoE, SSM, hybrid and encoder fields come with their model
    families)."""

    # identification
    name: str
    family: str                        # only 'dense' is ported
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

    # the activation type; the JAX package casts activations to bf16 at
    # the embedding whatever this says, the port honours it.  Parameters
    # are fp32.
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim > 0 else self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """Reduced same-family variant for CPU smoke tests (as in JAX)."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            d_model=min(self.d_model, 256),
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=0,
        )


@dataclasses.dataclass(frozen=True)
class RobustConfig:
    """Parameters of the paper's technique.

    ``use_kernels`` routes the statistics and the multi-Bulyan apply
    through the hand-written CUDA kernels for CUDA tensors (their plain
    PyTorch versions for CPU tensors).
    """

    n_workers: int = 16
    f: int = 3
    gar: str = "multi_bulyan"
    use_kernels: bool = True

    def __post_init__(self):
        self.validate()

    def validate(self) -> "RobustConfig":
        """Enforce the paper's resilience preconditions at construction:
        Krum-family rules need n >= 2f+3, Bulyan-family n >= 4f+3."""
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
        rule.validate(self.n_workers, self.f)
        return self
