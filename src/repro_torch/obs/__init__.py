"""repro_torch.obs — the part of the observability subsystem (cf.
``repro.obs``) that the campaign simulator (``repro_torch.sim``) reads:

* :mod:`~repro_torch.obs.metrics` — the per-worker suspicion EMA
  (:func:`init_suspicion`, :func:`update_suspicion`, :func:`update_ema`);
* :mod:`~repro_torch.obs.export` — the per-phase campaign digest
  (:func:`phase_summary`, the ``summary`` of a ``sim.campaign.v1``
  report).

The metrics registry, the span ring, the ``obs.v1`` snapshot export, the
kernel profile hooks and ``TrainerState.mstate`` are not ported yet.
"""
from repro_torch.obs.export import phase_summary  # noqa: F401
from repro_torch.obs.metrics import (init_suspicion,  # noqa: F401
                                     update_ema, update_suspicion)

__all__ = ["init_suspicion", "phase_summary", "update_ema",
           "update_suspicion"]
