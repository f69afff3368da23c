"""Model API of the port (cf. ``repro.models.api``): every family of the
registry, the decoder-only ones (dense, MoE, SSM, hybrid, VLM prefix) and
the encoder-decoder one (``cfg.is_encdec``, ``models/encdec.py``).

* ``init_model(cfg, seed=..., device=...)``   -> nested-dict fp32 parameters
* ``loss_fn(params, cfg, batch)``             -> scalar training loss
* ``forward_fn(params, cfg, batch)``          -> tail logits (inference)
* ``prefill_fn(params, cfg, batch)``          -> (last logits, cache)
* ``decode_fn(params, cfg, token, cache, pos)`` -> (logits, cache); ``pos``
  one position for the batch or a (B,) tensor, one a lane;
  ``lane_capacity=True`` keeps every lane's MoE tokens (``moe.capacity``)
* ``init_cache_fn(params, cfg, batch, cache_len, memory=...)`` -> empty
  cache (an encoder-decoder's with the memory's cross K/V)
* ``params_from_jax(tree, device=...)``       -> JAX parameters carried across
* ``cache_from_jax(tree, device=...)``        -> a JAX decode cache carried
  across
* ``arch_config(name, reduced=..., layers=...)`` -> the config the
  launchers run
* ``prefix_embeds(cfg, batch, seed, device)`` -> a VLM's random soft prefix
* ``frames(cfg, batch, seed, device)``        -> an encoder-decoder's
  random audio frames

The batch dict holds ``tokens`` (and ``labels`` for the loss), for a VLM
``prefix_embeds`` (B, n_patches, d_model) and for an encoder-decoder
``frames`` (B, n_frames, d_model), the stub frontend's embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as T
from repro_torch.tree import tree_items, tree_map, tree_unflatten

Tree = Any

#: the seed stream of a VLM's soft prefix: training step i draws it from
#: ``fold_seed(seed, PREFIX_STREAM + i)``, as the JAX launcher's
#: ``fold_in(key, 20_000 + i)``; serving draws it from step 0's
PREFIX_STREAM = 20_000
#: the seed stream of an encoder-decoder's frames: training step i draws
#: them from ``fold_seed(seed, FRAMES_STREAM + i)``, as the JAX launcher's
#: ``fold_in(key, 10_000 + i)``; serving draws them from step 0's
FRAMES_STREAM = 10_000


def arch_config(name: str, *, reduced: bool = False, layers: int = 0
                ) -> ArchConfig:
    """The registered config ``name``, its smoke-scale variant if
    ``reduced``, cut to ``layers`` layers if nonzero.  A depth that is not
    a multiple of the layer period (the superblock of
    ``transformer.layer_specs``) raises ``ValueError``."""
    cfg = get_config(name)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        period = len(T.layer_specs(cfg))
        if layers % period:
            raise ValueError(
                f"--layers {layers}: {cfg.name} repeats a period of "
                f"{period} layers; pass a multiple of {period}")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def prefix_embeds(cfg: ArchConfig, batch: int, seed: int,
                  device: Union[str, torch.device]) -> torch.Tensor:
    """A VLM's soft prefix (batch, n_patches, d_model): bf16 standard
    normals from the generator of ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn((batch, cfg.n_patches, cfg.d_model), generator=gen,
                       device=device).to(torch.bfloat16)


def frames(cfg: ArchConfig, batch: int, seed: int,
           device: Union[str, torch.device]) -> torch.Tensor:
    """An encoder-decoder's audio frames (batch, n_frames, d_model): bf16
    standard normals from the generator of ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn((batch, cfg.n_frames, cfg.d_model), generator=gen,
                       device=device).to(torch.bfloat16)


def init_model(cfg: ArchConfig, *, seed: int = 0,
               device: Optional[Union[str, torch.device]] = None) -> Tree:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if cfg.is_encdec:
        return ED.init_encdec(gen, cfg)
    return T.init_lm(gen, cfg)


def loss_fn(params: Tree, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, window: int = 0, chunk_q: int = 1024) -> torch.Tensor:
    if cfg.is_encdec:
        return ED.encdec_loss(params, cfg, batch, chunk_q=chunk_q)
    return T.lm_loss(params, cfg, batch, window=window, chunk_q=chunk_q)


def forward_fn(params: Tree, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
               *, window: int = 0, chunk_q: int = 1024,
               logits_tail: int = 1) -> torch.Tensor:
    """Inference forward (no cache): logits of the last ``logits_tail``
    positions."""
    if cfg.is_encdec:
        memory = ED.encode(params, cfg, batch["frames"], chunk_q=chunk_q)
        return ED.decode_train(params, cfg, batch["tokens"], memory,
                               window=window, chunk_q=chunk_q,
                               logits_tail=logits_tail)
    logits, _ = T.apply_lm(params, cfg, batch["tokens"],
                           prefix_embeds=batch.get("prefix_embeds"),
                           window=window, chunk_q=chunk_q,
                           logits_tail=logits_tail)
    return logits


def prefill_fn(params: Tree, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
               *, window: int = 0, chunk_q: int = 1024, cache_len: int = 0
               ) -> Tuple[torch.Tensor, Tree]:
    if cfg.is_encdec:
        return ED.encdec_prefill(params, cfg, batch["frames"],
                                 batch["tokens"], window=window,
                                 chunk_q=chunk_q, cache_len=cache_len)
    return T.prefill(params, cfg, batch["tokens"],
                     prefix_embeds=batch.get("prefix_embeds"),
                     window=window, chunk_q=chunk_q, cache_len=cache_len)


def decode_fn(params: Tree, cfg: ArchConfig, token: torch.Tensor, cache: Tree,
              pos, *, window: int = 0, seq_chunks: int = 1,
              lane_capacity: bool = False) -> Tuple[torch.Tensor, Tree]:
    """One decode step; ``lane_capacity`` gives an MoE layer's experts a
    slot for every lane, so that each lane keeps its token as it would
    decoding alone (the encoder-decoder has no MoE layer)."""
    if cfg.is_encdec:
        return ED.encdec_decode_step(params, cfg, token, cache, pos,
                                     window=window, seq_chunks=seq_chunks)
    return T.decode_step(params, cfg, token, cache, pos, window=window,
                         seq_chunks=seq_chunks, lane_capacity=lane_capacity)


def init_cache_fn(params: Tree, cfg: ArchConfig, batch: int, cache_len: int,
                  *, window: int = 0, memory: Optional[torch.Tensor] = None
                  ) -> Tree:
    """An empty cache on the parameters' device; an encoder-decoder's
    needs the encoder ``memory`` (B, n_frames, d_model) for its cross
    K/V."""
    if cfg.is_encdec:
        if memory is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder cache needs "
                             f"the encoder memory")
        return ED.init_decode_cache(params, cfg, memory, batch, cache_len,
                                    window=window)
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
    layouts, each leaf in the type the JAX package keeps it: an attention
    layer's ``k`` / ``v`` bf16 (the values are bf16-representable, so the
    cast back is exact), a mamba mixer's ``conv`` / ``h`` fp32.  An
    encoder-decoder's ``cross`` pair (a tuple ``(k, v)`` in JAX, in its
    activation type) becomes ``{"k": k, "v": v}`` in fp32, which holds
    either type's values exactly; the cross attention reads them in fp32
    whatever their type."""
    dev = resolve_device(device)
    if isinstance(tree, dict) and isinstance(tree.get("cross"),
                                             (tuple, list)):
        k, v = tree["cross"]
        tree = {**tree, "cross": {"k": k, "v": v}}
    items = list(tree_items(tree))
    leaves = [torch.from_numpy(np.array(a, dtype=np.float32)).to(
        torch.bfloat16 if path[-1] in ("k", "v") and path[0] != "cross"
        else torch.float32).to(dev) for path, a in items]
    return tree_unflatten(tree, leaves)
