"""GAR primitives, the plan/apply aggregation API, attacks and theory."""
