"""Config registry of the port: the ten architectures of the JAX package
(nine decoder-only and the encoder-decoder ``whisper-tiny``)."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    HybridConfig,
    MoEConfig,
    RobustConfig,
    SSMConfig,
)

_MODULES: Dict[str, str] = {
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG
