"""Dense decoder models of the port (cf. ``repro.models``)."""
from repro_torch.models.api import init_model, loss_fn, params_from_jax  # noqa: F401
