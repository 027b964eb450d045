"""Contract bounds of a run (the port's own part of
``elmkernels_tpu/utils/guard.py``; ``StepGuard`` with its rollback is
still to port)."""

from __future__ import annotations

import math


def errsol_bound(ncol: int, nsteps: int = 48, base: float = 2.5e-5) -> float:
    """Batch- and horizon-scaled shortwave-closure bound of the
    mixed-radiation production flags (float32 SNICAR and two-stream inside
    the float64 step).

    ``errsol`` is checked as the largest over ``ncol`` columns and
    ``nsteps`` steps of a float32 roundoff, whose maximum grows like
    sqrt(log N) in the number of samples N; the bound scales from the
    calibration size of 8192 columns by one 48-step window.  The
    grazing-zenith columns of a global grid come closest to it.
    Pure-float64 radiation closes to ~1e-13 and needs no scaling."""
    n = ncol * nsteps / (8192.0 * 48.0)
    return base * math.sqrt(1.0 + max(0.0, math.log2(n)) / 2.0)
