"""The port's byzantine-SGD trainers (cf. ``repro.dist``): the stacked one
(``trainer``) and the streaming one (``streaming``)."""
from repro_torch.dist.streaming import make_streaming_train_step  # noqa: F401
from repro_torch.dist.trainer import (  # noqa: F401
    TrainerState, as_trainer_state, honest_dev_accumulate,
    honest_dev_finalize, init_train_state, inject_byzantine, inject_wire,
    make_train_step, per_worker_grads, split_workers)
