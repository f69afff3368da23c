"""Models of the port: the decoder-only families (dense, MoE, SSM, hybrid,
VLM prefix) and the encoder-decoder (cf. ``repro.models``)."""
from repro_torch.models.api import (  # noqa: F401
    FRAMES_STREAM,
    PREFIX_STREAM,
    arch_config,
    cache_from_jax,
    decode_fn,
    forward_fn,
    frames,
    init_cache_fn,
    init_model,
    loss_fn,
    params_from_jax,
    prefill_fn,
    prefix_embeds,
)
