"""Structured per-step and per-window metrics, one JSON line per call.

Counterpart of ``elmkernels_tpu/utils/metrics.py``; the reference prints
conservation errors and prognostics to ``std::cout``
(``conserved_quantity_kokkos.cc:72-80``, ``kokkos_driver.cc:59-81``).
Every record is reduced on the device into one small tensor and pulled to
the host once.  Given a :class:`~elmkernels_torch.parallel.ColumnMesh`,
the records are the domain's over every rank (every rank must log each
record: the reduction is a collective) and rank 0 writes them.
"""

from __future__ import annotations

import json
import pathlib
import time

import torch

_FLUX_FIELDS = ("eflx_sh_tot", "eflx_lh_tot", "fsa", "t_ref2m")
# the window means of ScanDiagnostics, in _FLUX_FIELDS order
_WINDOW_FLUX_FIELDS = ("eflx_sh_mean", "eflx_lh_mean", "fsa_mean",
                       "t_ref2m_mean")
_ERR_FIELDS = ("errh2o", "errh2o_led", "errh2osno", "errh2osno_steady",
               "errsol", "errlon", "errseb")


def _pull(state, errs, fluxes, niters, mesh=None,
          reduced=False) -> list[float]:
    """Max |err|, mean flux, max iterations and the state means, reduced
    on the device and pulled in one copy.  On a mesh the state means, and
    unless ``reduced`` (a sharded model's window diagnostics, already the
    domain's) the rest, are combined over the ranks."""
    maxima = [e.abs().max() for e in errs] + [niters.max()]
    means = [f.mean() for f in fluxes]
    state_means = [state.h2osno.mean(), state.t_grnd.mean()]
    if mesh is not None and mesh.group is not None:
        from elmkernels_torch.parallel.reductions import (combine,
                                                          global_means)
        if not reduced:
            maxima = list(combine(mesh, maxima=maxima)[0])
            means = list(global_means(mesh, fluxes))
        state_means = list(global_means(mesh, [state.h2osno,
                                               state.t_grnd]))
    vals = maxima[:-1] + means + maxima[-1:] + state_means
    return torch.stack([v.to(torch.float64).to(state.t_grnd.device)
                        for v in vals]).tolist()


class MetricsLogger:
    """Append-mode JSONL writer of diagnostics summaries."""

    def __init__(self, path, mesh=None):
        self.path = pathlib.Path(path)
        self.mesh = mesh
        self._fh = None
        if mesh is None or mesh.rank == 0:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a", buffering=1)

    def _write(self, rec: dict, vals: list[float]) -> dict:
        it = iter(vals)
        for k in _ERR_FIELDS:
            rec[k + "_max"] = next(it)
        for k in _FLUX_FIELDS:
            rec[k + "_mean"] = next(it)
        rec["niters_canopy_max"] = int(next(it))
        rec["h2osno_mean"] = next(it)
        rec["t_grnd_mean"] = next(it)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        return rec

    def log_step(self, date, state, diags) -> dict:
        """One record of a step's :class:`StepDiagnostics`."""
        vals = _pull(state, [getattr(diags, k) for k in _ERR_FIELDS],
                     [getattr(diags, k) for k in _FLUX_FIELDS],
                     diags.niters_canopy, self.mesh)
        return self._write({"date": f"{date.year:04d}-{date.doy:03d}",
                            "sec": date.sec}, vals)

    def log_window(self, date, state, diags) -> dict:
        """One record of a window's :class:`ScanDiagnostics` ([steps] of
        device reductions): errors as the window's max, fluxes as its
        mean."""
        vals = _pull(state, [getattr(diags, k + "_max") for k in _ERR_FIELDS],
                     [getattr(diags, k) for k in _WINDOW_FLUX_FIELDS],
                     diags.niters_canopy_max, self.mesh, reduced=True)
        return self._write({"ts": round(time.time(), 3),
                            "date": f"{date.year:04d}-{date.doy:03d}",
                            "sec": date.sec,
                            "window": int(diags.errsol_max.shape[0])}, vals)

    def close(self):
        if self._fh is not None:
            self._fh.close()
