"""Model API of the port (cf. ``repro.models.api``): dense decoders only.

* ``init_model(cfg, seed=..., device=...)``   -> nested-dict fp32 parameters
* ``loss_fn(params, cfg, batch)``             -> scalar training loss
* ``forward_fn(params, cfg, batch)``          -> tail logits (inference)
* ``prefill_fn(params, cfg, batch)``          -> (last logits, cache)
* ``decode_fn(params, cfg, token, cache, pos)`` -> (logits, cache)
* ``init_cache_fn(params, cfg, batch, cache_len)`` -> empty cache
* ``params_from_jax(tree, device=...)``       -> JAX parameters carried across
* ``cache_from_jax(tree, device=...)``        -> a JAX decode cache carried
  across

The batch dict holds ``tokens`` (and ``labels`` for the loss).  The VLM
``prefix_embeds`` and the audio ``frames`` come with their model families
and are refused until then.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

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


def _check_batch(batch: Dict[str, torch.Tensor]) -> None:
    for key, family in (("prefix_embeds", "vlm"), ("frames", "audio "
                                                   "encoder-decoder")):
        if batch.get(key) is not None:
            raise NotImplementedError(
                f"batch[{key!r}]: the {family} family is not ported")


def forward_fn(params: Tree, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
               *, window: int = 0, chunk_q: int = 1024,
               logits_tail: int = 1) -> torch.Tensor:
    """Inference forward (no cache): logits of the last ``logits_tail``
    positions."""
    _check_batch(batch)
    T.check_decodable(cfg)
    return T.apply_lm(params, cfg, batch["tokens"], window=window,
                      chunk_q=chunk_q, logits_tail=logits_tail)


def prefill_fn(params: Tree, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
               *, window: int = 0, chunk_q: int = 1024, cache_len: int = 0
               ) -> Tuple[torch.Tensor, Tree]:
    _check_batch(batch)
    return T.prefill(params, cfg, batch["tokens"], window=window,
                     chunk_q=chunk_q, cache_len=cache_len)


def decode_fn(params: Tree, cfg: ArchConfig, token: torch.Tensor, cache: Tree,
              pos, *, window: int = 0, seq_chunks: int = 1
              ) -> Tuple[torch.Tensor, Tree]:
    return T.decode_step(params, cfg, token, cache, pos, window=window,
                         seq_chunks=seq_chunks)


def init_cache_fn(params: Tree, cfg: ArchConfig, batch: int, cache_len: int,
                  *, window: int = 0, memory: Optional[torch.Tensor] = None
                  ) -> Tree:
    """An empty cache on the parameters' device."""
    if memory is not None:
        raise NotImplementedError(
            "memory: the encoder-decoder family is not ported")
    return T.init_cache(cfg, batch, cache_len, window=window,
                        device=params["embed"]["table"].device)


def params_from_jax(tree: Tree, *, device: Optional[Union[str, torch.device]]
                    = None) -> Tree:
    """A JAX parameter tree (nested dicts of arrays, converted with
    ``numpy.asarray``) as the port's tree: same keys, same layouts, fp32.
    It carries any fp32 tree across, such as the trainer's error-feedback
    residual; ``comm.codecs.encoded_from_jax`` carries a wire container."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(dev), tree)


def cache_from_jax(tree: Tree, *, device: Optional[Union[str, torch.device]]
                   = None) -> Tree:
    """A JAX decode cache (nested dicts of arrays, converted with
    ``np.asarray(x.astype(jnp.float32))``) as the port's: same keys and
    layouts, bf16 as the JAX package keeps it (the values are
    bf16-representable, so the cast back is exact)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(torch.bfloat16).to(dev), tree)
