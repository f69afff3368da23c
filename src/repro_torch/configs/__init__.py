"""Config registry of the port: only the architectures it runs so far."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ArchConfig, RobustConfig  # noqa: F401

_MODULES: Dict[str, str] = {
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG
