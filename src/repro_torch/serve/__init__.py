"""repro_torch.serve: the async bounded-staleness aggregation service (cf.
``repro.serve``).

The plan/apply split of the robust aggregation pipeline, packaged as a
service: a bounded-staleness gradient buffer (``buffer``), the plan/apply
service loop and the async trainer step built on it (``service``),
microbatched robust serving that fuses many decode requests, each at its
own position, through one shared plan (``batching``), and the
closed-loop throughput model (``loadgen``).  The JAX package's replica
PartitionSpecs have no counterpart on one card.
"""
from repro_torch.serve.batching import (RequestBatch,  # noqa: F401
                                        make_microbatch_serve_step,
                                        pack_requests)
from repro_torch.serve.buffer import (BufferState, admit,  # noqa: F401
                                      buffered_round, init_buffer_state,
                                      staleness_info)
from repro_torch.serve.loadgen import LoadConfig, run_closed_loop  # noqa: F401
from repro_torch.serve.service import (AsyncAggService,  # noqa: F401
                                       make_async_train_step, with_buffer)

__all__ = [
    "AsyncAggService",
    "BufferState",
    "LoadConfig",
    "RequestBatch",
    "admit",
    "buffered_round",
    "init_buffer_state",
    "make_async_train_step",
    "make_microbatch_serve_step",
    "pack_requests",
    "run_closed_loop",
    "staleness_info",
    "with_buffer",
]
