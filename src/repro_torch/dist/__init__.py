"""The port's distributed drivers (cf. ``repro.dist``): the byzantine-SGD
trainers, stacked (``trainer``) and streaming (``streaming``), and the
serving path with its robust replica ensemble (``serving``)."""
from repro_torch.dist.serving import (  # noqa: F401
    aggregate_replica_logits, generate, make_robust_serve_step,
    make_serve_step)
from repro_torch.dist.streaming import make_streaming_train_step  # noqa: F401
from repro_torch.dist.trainer import (  # noqa: F401
    TrainerState, as_trainer_state, honest_dev_accumulate,
    honest_dev_finalize, init_train_state, inject_byzantine, inject_wire,
    make_train_step, per_worker_grads, split_workers)
