"""Core: the paper's gradient aggregation rules and byzantine machinery.

The public aggregation surface is the plan/apply ``Aggregator`` registry in
:mod:`repro_torch.core.api`; ``aggregate`` / ``tree_aggregate`` are legacy
shims over it.
"""
from repro_torch.core.api import (  # noqa: F401
    AggPlan,
    AggStats,
    Aggregator,
    ClipByNorm,
    NearestNeighborMix,
    REGISTRY,
    TRANSFORMS,
    Transform,
    WorkerMomentum,
    aggregate_matrix,
    aggregate_tree,
    apply_transforms,
    available_gars,
    compute_stats,
    get_aggregator,
    init_transform_states,
    register_gar,
)
from repro_torch.core.gar import (  # noqa: F401
    GARS,
    aggregate,
    average,
    bulyan,
    coordinate_median,
    extraction_plan,
    get_gar,
    krum,
    multi_bulyan,
    multi_krum,
    pairwise_sqdist,
    trimmed_mean,
)
from repro_torch.core.robust import (  # noqa: F401
    RobustAggregator,
    tree_aggregate,
    tree_pairwise_sqdist,
)
from repro_torch.core.attacks import (  # noqa: F401
    ADAPTIVE,
    ATTACKS,
    apply_attack,
    get_adaptive,
    get_attack,
    is_adaptive,
    parse_spec,
)
from repro_torch.core import theory  # noqa: F401
