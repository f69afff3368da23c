"""Model API of the port (cf. ``repro.models.api``): dense decoders only.

* ``init_model(cfg, seed=..., device=...)`` -> nested-dict fp32 parameters
* ``loss_fn(params, cfg, batch)``           -> scalar training loss
* ``params_from_jax(tree, device=...)``     -> JAX parameters carried across
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.tree import tree_map

Tree = Any


def init_model(cfg: ArchConfig, *, seed: int = 0,
               device: Optional[Union[str, torch.device]] = None) -> Tree:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return T.init_lm(gen, cfg)


def loss_fn(params: Tree, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, window: int = 0, chunk_q: int = 1024) -> torch.Tensor:
    return T.lm_loss(params, cfg, batch, window=window, chunk_q=chunk_q)


def params_from_jax(tree: Tree, *, device: Optional[Union[str, torch.device]]
                    = None) -> Tree:
    """A JAX parameter tree (nested dicts of arrays, converted with
    ``numpy.asarray``) as the port's tree: same keys, same layouts, fp32.
    It carries any fp32 tree across, such as the trainer's error-feedback
    residual; ``comm.codecs.encoded_from_jax`` carries a wire container."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(dev), tree)

