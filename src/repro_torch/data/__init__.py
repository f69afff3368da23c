"""Synthetic data of the port (cf. ``repro.data``)."""
from repro_torch.data.synthetic import lm_batches, make_lm_batch  # noqa: F401
