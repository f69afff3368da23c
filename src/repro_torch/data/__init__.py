"""Synthetic data of the port (cf. ``repro.data``)."""
from repro_torch.data.synthetic import (  # noqa: F401
    dirichlet_mixture, lm_batches, lm_walk, make_lm_batch,
    make_noniid_lm_batch)
