"""Atmospheric forcing and phenology providers (numpy, host side).

The port's own copy of ``elmkernels_tpu/data/forcing.py``: per step a
provider yields the raw bracketing samples plus interpolation weights
(``window``), or for a run of steps the samples on the forcing-time grid
plus per-step bracket indices (``series``); the derived-forcing physics
runs on the device inside the step.  Point data is interpolated at the
step midpoint; flux data (FSDS/PREC) is piecewise constant over the
forcing interval (reference ``atm_data.h:23-78``).

- :class:`SyntheticForcing` — analytic diurnal/seasonal cycles.

(The benchmark's copy keeps the synthetic providers here; its copy of the
port's month-file reader, over scipy, is ``forcing_files.py``.)
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from portbench.reference.elm.data.state import StepForcing, StepPhenology
from portbench.reference.elm.utils.dates import (Date, month_indices,
                                          monthly_data_weights)


class ForcingSeries(NamedTuple):
    """Raw forcing samples on the forcing-time grid, [nt, ncol] each —
    the reference's own windowed layout (``atm_data_impl.hh:248-319``).
    Consecutive model steps share bracketing samples (dt < forcing
    interval), so shipping the series + per-step indices moves ~dtf/dt
    times fewer bytes than per-step-broadcast bracketing pairs."""
    tbot: np.ndarray
    pbot: np.ndarray
    qbot: np.ndarray
    flds: np.ndarray
    wind: np.ndarray
    fsds: np.ndarray
    prec: np.ndarray


class SeriesSteps(NamedTuple):
    """Per-step bracket indices into a :class:`ForcingSeries` + weights
    ([nsteps] each; idx2 = idx1 + 1 by construction)."""
    idx1: np.ndarray    # i32
    wt1: np.ndarray
    wt2: np.ndarray
    decday: np.ndarray


@dataclasses.dataclass
class SyntheticForcing:
    """Analytic forcing: seasonal + diurnal temperature cycle, periodic
    precipitation events, clear-sky-ish shortwave."""
    ncol: int
    lat_r: np.ndarray
    lon_r: np.ndarray
    dt_forcing: float = 3600.0  # forcing data interval [s]

    def _sample_point(self, tsec: np.ndarray):
        doy = (tsec / 86400.0) % 365.0
        hour = (tsec / 3600.0) % 24.0
        seasonal = -12.0 * np.cos(2.0 * np.pi * doy / 365.0)
        diurnal = 6.0 * np.sin(2.0 * np.pi * (hour - 9.0) / 24.0)
        tbot = 278.0 + seasonal + diurnal + 0.0 * self.lat_r
        pbot = 98000.0 + 500.0 * np.sin(2.0 * np.pi * doy / 29.0) \
            + 0.0 * self.lat_r
        qbot = np.maximum(1.0e-4, 0.004 + 0.003
                          * np.sin(2.0 * np.pi * doy / 365.0))
        qbot = qbot + 0.0 * self.lat_r
        flds = 220.0 + 60.0 * np.cos(2.0 * np.pi * (doy - 200.0) / 365.0) \
            + 0.0 * self.lat_r
        wind = 3.0 + 2.0 * np.sin(2.0 * np.pi * doy / 13.0) + 0.0 * self.lat_r
        return tbot, pbot, qbot, flds, wind

    def _sample_flux(self, tsec: np.ndarray):
        doy = (tsec / 86400.0) % 365.0
        hour = (tsec / 3600.0) % 24.0
        sun = np.maximum(0.0, np.sin(np.pi * (hour - 6.0) / 12.0))
        fsds = 600.0 * sun * (0.6 + 0.4 * np.sin(2.0 * np.pi * doy / 365.0))
        fsds = fsds + 0.0 * self.lat_r
        # precipitation: episodic, a few mm/day equivalent
        wet = (np.floor(doy * 3.0) % 7.0) < 2.0
        prec = np.where(wet, 2.5e-5, 0.0) + 0.0 * self.lat_r
        return fsds, prec

    def window(self, date: Date, dtime: float) -> StepForcing:
        """Raw bracketing samples + weights for the step starting at
        ``date`` (point data interpolated at t + dt/2)."""
        tsec = (date.year * 365.0 + date.doy) * 86400.0 + date.sec
        tmid = tsec + 0.5 * dtime
        i0 = np.floor(tmid / self.dt_forcing)
        t0 = i0 * self.dt_forcing
        wt2 = (tmid - t0) / self.dt_forcing
        wt1 = 1.0 - wt2

        p0 = self._sample_point(np.asarray(t0))
        p1 = self._sample_point(np.asarray(t0 + self.dt_forcing))
        fsds, prec = self._sample_flux(np.asarray(t0))
        return StepForcing(
            wt1=wt1, wt2=wt2,
            tbot=np.stack([p0[0], p1[0]]), pbot=np.stack([p0[1], p1[1]]),
            qbot=np.stack([p0[2], p1[2]]), flds=np.stack([p0[3], p1[3]]),
            wind=np.stack([p0[4], p1[4]]), fsds=fsds, prec=prec,
            decday=date.decimal_doy() + 1.0)

    def series(self, start: Date, nsteps: int,
               dtime: float) -> tuple[ForcingSeries, SeriesSteps]:
        """The forcing-grid sample series covering ``nsteps`` steps plus
        per-step bracket indices/weights.  Gathering rows ``idx1``/
        ``idx1+1`` and applying ``wt1/wt2`` reproduces :meth:`window`'s
        per-step samples bit-for-bit (same sampling arithmetic)."""
        date = start.copy()
        i0s, wt1s, wt2s, decdays = [], [], [], []
        for _ in range(nsteps):
            tsec = (date.year * 365.0 + date.doy) * 86400.0 + date.sec
            tmid = tsec + 0.5 * dtime
            i0 = np.floor(tmid / self.dt_forcing)
            t0 = i0 * self.dt_forcing
            wt2 = (tmid - t0) / self.dt_forcing
            i0s.append(i0)
            wt1s.append(1.0 - wt2)
            wt2s.append(wt2)
            decdays.append(date.decimal_doy() + 1.0)
            date.increment_seconds(int(dtime))
        i0s = np.asarray(i0s)
        imin = i0s.min()
        nt = int(i0s.max() - imin) + 2
        tgrid = ((imin + np.arange(nt)) * self.dt_forcing)[:, None]
        tb, pb, qb, fl, wd = self._sample_point(tgrid)
        fsds, prec = self._sample_flux(tgrid)
        return (ForcingSeries(tbot=tb, pbot=pb, qbot=qb, flds=fl, wind=wd,
                              fsds=fsds, prec=prec),
                SeriesSteps(idx1=(i0s - imin).astype(np.int32),
                            wt1=np.asarray(wt1s), wt2=np.asarray(wt2s),
                            decday=np.asarray(decdays)))


@dataclasses.dataclass
class SyntheticPhenology:
    """Monthly LAI/SAI/height climatology with a seasonal cycle."""
    ncol: int

    def monthly(self, m: int):
        phase = np.cos(2.0 * np.pi * (m - 6.5) / 12.0)
        lai = np.full(self.ncol, 1.0 + 2.0 * max(0.0, phase))
        sai = np.full(self.ncol, 0.3 + 0.2 * max(0.0, phase))
        htop = np.full(self.ncol, 0.5)
        hbot = np.full(self.ncol, 0.01)
        return lai, sai, htop, hbot

    def window(self, date: Date) -> StepPhenology:
        m1, m2 = month_indices(date)
        wt1, wt2 = monthly_data_weights(date)
        a = self.monthly(m1)
        b = self.monthly(m2)
        return StepPhenology(
            wt1=wt1, wt2=wt2,
            mlai=np.stack([a[0], b[0]]), msai=np.stack([a[1], b[1]]),
            mhtop=np.stack([a[2], b[2]]), mhbot=np.stack([a[3], b[3]]))
