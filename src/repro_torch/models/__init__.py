"""Dense decoder models of the port (cf. ``repro.models``)."""
from repro_torch.models.api import (  # noqa: F401
    cache_from_jax,
    decode_fn,
    forward_fn,
    init_cache_fn,
    init_model,
    loss_fn,
    params_from_jax,
    prefill_fn,
)
