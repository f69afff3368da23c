"""Static contract verification for the port (cf. ``repro.analysis``).

Three passes:

* :mod:`repro_torch.analysis.lint` — an AST lint of the port's tree
  (R001, R003, R004, R006, R007; R002 and R005 have no counterpart);
* :mod:`repro_torch.analysis.op_audit` — records the aten ops and the
  collectives a call dispatches and proves the contracts C201, C202,
  C204 (single build) and C205 on them (C203 has no counterpart);
* :mod:`repro_torch.analysis.smem` — the Hopper estimator: each kernel
  function's grid, threads, static and dynamic shared memory, HBM bytes
  and fp32 operations, the bound, and with ptxas's registers the blocks
  an SM holds.

:mod:`repro_torch.analysis.bounds` holds the bound arithmetic that the
estimator and ``chip_smoke.py`` share; it imports nothing of the package.

``repro_torch.launch.analyze`` runs all three and prints the
``analysis.v1`` report; ``--strict`` makes any violation fatal.
"""
from repro_torch.analysis.lint import (  # noqa: F401
    Violation, lint_paths, lint_source)

__all__ = ["Violation", "lint_paths", "lint_source"]
