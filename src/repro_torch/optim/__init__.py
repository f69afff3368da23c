"""Optimizers and schedules of the port (cf. ``repro.optim``)."""
from repro_torch.optim.optimizers import (  # noqa: F401
    OptState, Optimizer, adamw, make_optimizer, sgd)
from repro_torch.optim.schedules import (  # noqa: F401
    constant, cosine_decay, warmup_cosine)
