"""Stacked byzantine-SGD trainer of the port (cf. ``repro.dist``)."""
from repro_torch.dist.trainer import (  # noqa: F401
    TrainerState, init_train_state, inject_byzantine, inject_wire,
    make_train_step, per_worker_grads, split_workers)
