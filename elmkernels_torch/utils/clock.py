"""Wall-clock section timing.

Counterpart of ``elmkernels_tpu/utils/clock.py``, after the reference's
perf ``Clock`` (``src/utils/utils.hh:92-103``, ``utils.cc:73-89``).  The
host clock times what the host waits for: a section that launches work on
the card must synchronize inside it to time the card's work.  Given a
:class:`~elmkernels_torch.parallel.ColumnMesh`, :meth:`Clock.min_max_mean`
spans its ranks.
"""

from __future__ import annotations

import collections
import contextlib
import time


class Clock:
    def __init__(self, mesh=None):
        self.mesh = mesh
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_s": self.totals[k] / max(1, self.counts[k])}
                for k in self.totals}

    def min_max_mean(self, name: str):
        """A section's mean as (min, max, mean) across the mesh's ranks
        (three times the local mean with no mesh).  Every rank must call
        it: it is a collective."""
        local = self.totals[name] / max(1, self.counts[name])
        if self.mesh is None or self.mesh.group is None:
            return local, local, local
        import torch
        from elmkernels_torch.parallel.reductions import min_max_mean
        mmm = min_max_mean(torch.tensor([local], dtype=torch.float64),
                           self.mesh)
        return tuple(float(v) for v in mmm)
