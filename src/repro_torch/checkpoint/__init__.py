"""Checkpointing: npz save / restore of the port's trees (cf.
``repro.checkpoint``), in the JAX package's file format."""
from repro_torch.checkpoint.store import latest_step, restore, save  # noqa: F401
