"""Hierarchical (grouped) robust aggregation for large n (cf.
``repro.hier``).

Robust-aggregate within ceil(n/g) groups of at most g workers, then
robust-aggregate the group outputs, with per-level byzantine budgets
derived and checked by ``core.theory.split_f_budget``; ``g >= n`` is the
flat rule bit for bit.  Turn it on per trainer with
``hier=GroupConfig(g=7)``, or ``launch/train.py --hier g=7``.
"""
from repro_torch.hier.plan import GroupConfig, HierPlan  # noqa: F401
from repro_torch.hier.aggregate import (  # noqa: F401
    LEADER_ENCODE_STREAM,
    hier_aggregate_tree,
)
