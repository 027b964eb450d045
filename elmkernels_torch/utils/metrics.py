"""Structured per-step and per-window metrics, one JSON line per call.

Counterpart of ``elmkernels_tpu/utils/metrics.py``; the reference prints
conservation errors and prognostics to ``std::cout``
(``conserved_quantity_kokkos.cc:72-80``, ``kokkos_driver.cc:59-81``).
Every record is reduced on the device into one small tensor and pulled to
the host once.
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


def _pull(state, errs, fluxes, niters) -> list[float]:
    """Max |err|, mean flux, max iterations and the state means, reduced
    on the device and pulled in one copy."""
    vals = ([e.abs().max() for e in errs] + [f.mean() for f in fluxes]
            + [niters.max(), state.h2osno.mean(), state.t_grnd.mean()])
    return torch.stack([v.to(torch.float64) for v in vals]).tolist()


class MetricsLogger:
    """Append-mode JSONL writer of diagnostics summaries."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
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
        self._fh.write(json.dumps(rec) + "\n")
        return rec

    def log_step(self, date, state, diags) -> dict:
        """One record of a step's :class:`StepDiagnostics`."""
        vals = _pull(state, [getattr(diags, k) for k in _ERR_FIELDS],
                     [getattr(diags, k) for k in _FLUX_FIELDS],
                     diags.niters_canopy)
        return self._write({"date": f"{date.year:04d}-{date.doy:03d}",
                            "sec": date.sec}, vals)

    def log_window(self, date, state, diags) -> dict:
        """One record of a window's :class:`ScanDiagnostics` ([steps] of
        device reductions): errors as the window's max, fluxes as its
        mean."""
        vals = _pull(state, [getattr(diags, k + "_max") for k in _ERR_FIELDS],
                     [getattr(diags, k) for k in _WINDOW_FLUX_FIELDS],
                     diags.niters_canopy_max)
        return self._write({"ts": round(time.time(), 3),
                            "date": f"{date.year:04d}-{date.doy:03d}",
                            "sec": date.sec,
                            "window": int(diags.errsol_max.shape[0])}, vals)

    def close(self):
        self._fh.close()
