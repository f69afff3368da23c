"""repro_torch.sim — the Byzantine campaign simulator (cf. ``repro.sim``).

Turns the port into a scenario lab: declarative
:class:`~repro_torch.sim.scenario.Scenario` descriptions (attack
schedules, time-varying effective f, Dirichlet non-IID data, worker
churn) executed by :func:`~repro_torch.sim.engine.run_campaign` on either
trainer, the async service or the hierarchical aggregation, with
plan-level telemetry (per-worker selection, Krum score spectra,
honest-mean deviation, suspicion EMA) and JSON/CSV campaign reports in
the JAX package's ``sim.campaign.v1`` schema.
"""
from repro_torch.sim.engine import CampaignResult, run_campaign  # noqa: F401
from repro_torch.sim.scenario import (  # noqa: F401
    AttackPhase,
    AttackSchedule,
    DataConfig,
    Scenario,
    switch_scenario,
)
from repro_torch.sim import report, telemetry  # noqa: F401
