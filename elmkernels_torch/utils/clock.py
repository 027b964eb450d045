"""Wall-clock section timing, and the port's spans on the profiler's clock.

Counterpart of ``elmkernels_tpu/utils/clock.py``, after the reference's
perf ``Clock`` (``src/utils/utils.hh:92-103``, ``utils.cc:73-89``).  The
host clock times what the host waits for: a section that launches work on
the card must synchronize inside it to time the card's work.  Given a
:class:`~elmkernels_torch.parallel.ColumnMesh`, :meth:`Clock.min_max_mean`
spans its ranks.

:func:`span` marks a section of the host's work in a ``torch.profiler``
trace, on the calling thread: a profiler that is recording turns the port's
spans on, and nothing else does.  Names are ``elm.<layer>.<what>``:

- ``elm.run.<section>``: each :meth:`Clock.time` section (``run_model``'s
  ``advance``, ``validate``, ``checkpoint``);
- ``elm.coupled.inputs``, ``.copy_in``, ``.step``, ``.exchange``:
  ``MinimalInterface.advance_with_forcing``'s host arrays checked and
  stacked into the step's inputs, their copies to the device, the eager
  step issued, and the wait for the card with the exchange fluxes' copies
  back (``driver/interface.py``);
- ``elm.window.wait``, ``.copy``, ``.step``: ``Model.run_windows``' wait
  for the host thread's next payload, that payload's copy issued on the
  side stream, and each step issued (its inputs' gather, the graph's
  buffer copies and launch, the reductions' row copy and the poll)
  (``driver/model.py``).

A span is a host operation (``cpu_op``), not a ``record_function`` range
(``user_annotation``), which a CUDA trace also draws over the kernels it
encloses on the device timeline: a span adds no device work to a trace
and no node to a captured graph.  None opens inside the captured step.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks its body as ``name`` in the trace of a
    profiler recording now, and does nothing otherwise."""
    return _RecordFunctionFast(name) if _profiler_enabled() else _OFF


class Clock:
    def __init__(self, mesh=None):
        self.mesh = mesh
        self.totals = collections.defaultdict(float)
        self.counts = collections.defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str):
        """Time the body as section ``name``, in the span
        ``elm.run.<name>``."""
        t0 = time.perf_counter()
        try:
            with span("elm.run." + name):
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
        from elmkernels_torch.parallel.reductions import min_max_mean
        mmm = min_max_mean(torch.tensor([local], dtype=torch.float64),
                           self.mesh)
        return tuple(float(v) for v in mmm)
