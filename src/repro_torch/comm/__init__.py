"""The compressed gradient wire of the port (cf. ``repro.comm``).

* ``container`` — :class:`~repro_torch.comm.container.EncodedGrads`, the
  wire container (free of the codecs' imports, for ``core.api``);
* ``codecs``    — encode/decode pairs over stacked gradient trees,
  addressed by spec string (``get_codec("qsgd:bits=8")``), with an
  optional error-feedback residual;
* ``transport`` — exact per-worker byte accounting (:class:`WireStats`,
  per hierarchy level: ``hier_wire_stats``).

Statistics on a wire container run on the payloads through the K5 kernel
(``kernels.ops.dequant_stats``); ``core.api`` accepts containers.
"""
from repro_torch.comm.codecs import (  # noqa: F401
    CODECS,
    Codec,
    EncodedGrads,
    available_codecs,
    encoded_pairwise_stats,
    get_codec,
    is_encoded,
    slice_workers,
)
from repro_torch.comm.transport import (  # noqa: F401
    WireStats,
    gather_stats,
    hier_wire_stats,
    wire_stats,
)
