"""Decoder-only models of the port: dense, MoE, SSM, hybrid and the VLM
prefix (cf. ``repro.models``)."""
from repro_torch.models.api import (  # noqa: F401
    PREFIX_STREAM,
    arch_config,
    cache_from_jax,
    decode_fn,
    forward_fn,
    init_cache_fn,
    init_model,
    loss_fn,
    params_from_jax,
    prefill_fn,
    prefix_embeds,
)
