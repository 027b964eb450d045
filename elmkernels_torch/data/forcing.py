"""Atmospheric forcing and phenology providers (numpy, host side).

The port's own copy of ``elmkernels_tpu/data/forcing.py``: per step a
provider yields the raw bracketing samples plus interpolation weights
(``window``), or for a run of steps the samples on the forcing-time grid
plus per-step bracket indices (``series``); the derived-forcing physics
runs on the device inside the step.  Point data is interpolated at the
step midpoint; flux data (FSDS/PREC) is piecewise constant over the
forcing interval (reference ``atm_data.h:23-78``).

- :class:`SyntheticForcing` — analytic diurnal/seasonal cycles.
- :class:`NetCDFForcing` — the reference's month-per-file layout
  (``basenameYYYY-MM.nc``), read by hyperslab through the native reader,
  the next month loaded on its background thread.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import NamedTuple

import numpy as np

from elmkernels_torch.data import netcdf
from elmkernels_torch.data.state import StepForcing, StepPhenology
from elmkernels_torch.utils.dates import (Date, month_indices,
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


class NetCDFForcing:
    """Reference-format forcing reader: month-per-file NetCDF, windowed
    host buffers (reference: ``atm_data_impl.hh:248-319``).

    File layout: ``<basename>YYYY-MM.nc`` with variables named like the
    reference's (TBOT/PBOT/QBOT-or-RH/FLDS/FSDS/PRECTmms/WIND) with dims
    in any order containing DTIME (discovery per variable, reference
    ``atm_data_impl.hh:219-245``); DTIME in days since the file start.
    Cells are flattened in C order and sliced [col0, col0+ncol).

    Robustness semantics matching the reference:

    - humidity may be specific humidity (QBOT) or relative humidity (RH,
      percent); ``qbot_is_rh`` reports which, and the device step converts
      RH after time interpolation via Lowe esat (``atm_data.h:95-186``,
      ``atm_physics.h:119-140``);
    - the month window is extended with the next month's first sample so
      interpolation bridges month boundaries (the reference's windows are
      continuous in global time);
    - a step outside the loaded forcing span raises instead of silently
      reusing stale forcing (``forc_t_idx_check_bounds``,
      ``atm_data_impl.hh:144-169``).
    """

    VAR_NAMES = {"tbot": "TBOT", "pbot": "PBOT", "qbot": "QBOT",
                 "flds": "FLDS", "wind": "WIND", "fsds": "FSDS",
                 "prec": "PRECTmms"}

    def __init__(self, basename: str, ncol: int, lat_r, lon_r,
                 col0: int = 0, ship_source_dtype: bool = True):
        self.basename = basename
        self.ncol = ncol
        self.col0 = col0
        self.lat_r = np.asarray(lat_r)
        self.lon_r = np.asarray(lon_r)
        self._cache: dict[tuple[int, int], dict] = {}
        # (path, open native file) of the month after the last one loaded:
        # its bridge rows were read from it, and its own load takes it
        self._next_file = None
        self.qbot_is_rh = self._probe_humidity()
        # ship the series payload at SOURCE precision: variables stored
        # on disk as NC_FLOAT with no scale/offset packing carry exactly
        # 32 bits/value, so the series H2D bytes halve losslessly — the
        # f64 host read is a round-trip identity over the f32 values and
        # the device promotes after the bracket gather
        # (netcdf.var_packing)
        self.ship_source_dtype = ship_source_dtype

    def _probe_humidity(self) -> bool:
        """QBOT-or-RH discovery from any existing forcing file (static:
        it selects the compiled conversion path)."""
        files = sorted(glob.glob(self.basename + "*.nc"))
        if not files:
            return False
        if netcdf.has_variable(files[0], "QBOT"):
            return False
        if netcdf.has_variable(files[0], "RH"):
            return True
        raise ValueError(f"{files[0]}: neither QBOT nor RH present")

    def _path(self, year: int, month: int) -> str:
        return f"{self.basename}{year:04d}-{month:02d}.nc"

    def _read_cells(self, path: str, vname: str, f) -> np.ndarray:
        """Read this host's [t, col0:col0+ncol) shard of a forcing
        variable from ``path``, open in the native reader as ``f``, as
        (t, cell) regardless of the file's dim order (reference
        ``atm_data_impl.hh:219-245``).

        The read is a per-host HYPERSLAB, not full-grid-then-slice
        (reference rank-local start/count reads, ``read_input.cc:52-87``
        and PNetCDF collective hyperslabs, ``read_pnetcdf.hh:151-170``):
        the flattened cell range [col0, col0+ncol) maps to a contiguous
        span [j0, j1] of the leading non-time ("major") grid dimension —
        the (lat, lon)-box of the reference — so each host reads only
        its rows plus at most one partial row on each side.  Per-host
        read bytes scale with ncol_local, not the global grid.
        """
        dims = netcdf.get_var_dimnames(path, vname)
        shape = f.shape(vname)
        taxes = [i for i, d in enumerate(dims)
                 if d.lower() in ("dtime", "time")]
        if len(taxes) != 1:
            raise ValueError(f"{path}:{vname}: cannot identify the time "
                             f"axis among dims {dims}")
        taxis = taxes[0]
        other = [i for i in range(len(shape)) if i != taxis]
        # cells flatten C-order over the non-time dims in file order:
        # the first is the major axis, the rest fold into the minor span
        kminor = 1
        for i in other[1:]:
            kminor *= shape[i]
        ncell = kminor * (shape[other[0]] if other else 1)
        if self.col0 + self.ncol > ncell:
            raise ValueError(f"{path}:{vname}: {ncell} cells < col0+ncol "
                             f"{self.col0 + self.ncol}")
        start = [0] * len(shape)
        count = list(shape)
        j0 = 0
        if other:
            j0 = self.col0 // kminor
            j1 = (self.col0 + self.ncol - 1) // kminor
            start[other[0]] = j0
            count[other[0]] = j1 - j0 + 1
        arr = netcdf.read_var(f, vname, start=start, count=count)
        arr = np.moveaxis(arr, taxis, 0)
        arr = arr.reshape(arr.shape[0], -1)
        off = self.col0 - j0 * kminor
        return arr[:, off:off + self.ncol]

    def _open_month(self, path: str):
        """``path`` open in the native reader: the file the last load kept
        for it, or a prefetched or cold open."""
        if self._next_file is not None:
            kept, self._next_file = self._next_file, None
            if kept[0] == path:
                return kept[1]
            kept[1].close()
        return netcdf.open_native(path)

    def _load_month(self, year: int, month: int) -> dict:
        key = (year, month)
        if key in self._cache:
            return self._cache[key]
        path = self._path(year, month)
        names = dict(self.VAR_NAMES)
        if self.qbot_is_rh:
            names["qbot"] = "RH"
        ny, nm = (year, month + 1) if month < 12 else (year + 1, 1)
        npath = self._path(ny, nm)
        has_bridge = os.path.exists(npath)
        if has_bridge and (self._next_file is None
                           or self._next_file[0] != npath):
            # the next month loads on the reader's thread while this one
            # is read; its bridge rows below take it
            netcdf.prefetch(npath)
        with self._open_month(path) as f:
            data = {"dtime": netcdf.read_var(f, "DTIME")}
            # the series layout's fixed-window padding (ntfix) assumes ONE
            # uniform sample interval across all months; validate each
            # loaded month against the probed interval so a mixed-cadence
            # file set fails loudly instead of silently varying the
            # payload's shape from window to window
            if len(data["dtime"]) > 1:
                dt_month = (float(data["dtime"][1] - data["dtime"][0])
                            * 86400.0)
                if abs(dt_month - self.dt_forcing) > 1e-6 * self.dt_forcing:
                    raise ValueError(
                        f"{path}: DTIME spacing {dt_month:.1f}s differs "
                        f"from the file set's probed interval "
                        f"{self.dt_forcing:.1f}s; month files must share "
                        f"one uniform forcing cadence")
            for k, vname in names.items():
                data[k] = self._read_cells(path, vname, f)
            # which variables this month stores as exact f32 (on-disk
            # NC_FLOAT, no scale/offset packing) — the set of vars whose
            # cached f64 rows can be demoted back to f32 losslessly for
            # source-precision series shipping
            data["f32_exact"] = frozenset(
                k for k, vname in names.items()
                if netcdf.var_packing(f, vname) == ("f4", 1.0, 0.0))
        # bridge the month boundary: append the next month's first sample
        # so the last in-month interval has its right bracket (reference
        # windows are continuous in global time, atm_data_impl.hh:100-130)
        data["has_bridge"] = has_bridge
        if has_bridge:
            dt = (data["dtime"][1] - data["dtime"][0]
                  if len(data["dtime"]) > 1 else 1.0)
            data["dtime"] = np.concatenate(
                [data["dtime"], [data["dtime"][-1] + dt]])
            g = self._open_month(npath)
            for k, vname in names.items():
                nxt = self._read_cells(npath, vname, g)[:1]
                data[k] = np.concatenate([data[k], nxt], axis=0)
            # the bridge row is the next file's: a variable ships as f32
            # only if that file stores it as exact f32 too
            data["f32_exact"] = frozenset(
                k for k in data["f32_exact"]
                if netcdf.var_packing(g, names[k]) == ("f4", 1.0, 0.0))
            # kept open for the next month's own load
            self._next_file = (npath, g)
        self._cache[key] = data
        # keep at most two months resident (double-buffer semantics)
        if len(self._cache) > 2:
            self._cache.pop(next(iter(self._cache)))
        return data

    def _locate(self, date: Date, dtime: float, data: dict,
                y: int, m: int) -> tuple[int, float, float]:
        """In-month bracket index + interpolation weights for the step
        starting at ``date`` — the single arithmetic shared by
        :meth:`window` and :meth:`series` (so the two ingest layouts are
        bit-identical by construction)."""
        dt_forc = ((data["dtime"][1] - data["dtime"][0]) * 86400.0
                   if len(data["dtime"]) > 1 else 86400.0)
        file_start_doy = Date.from_ymd(y, m, 1).doy
        tmid = (date.doy - file_start_doy) * 86400.0 + date.sec \
            + 0.5 * dtime
        idx = int(np.floor(tmid / dt_forc))
        # hard bounds: reusing stale forcing silently is the reference's
        # assert-failure case (atm_data_impl.hh:144-169)
        if not 0 <= idx <= len(data["dtime"]) - 2:
            nxt = self._path(*((y, m + 1) if m < 12 else (y + 1, 1)))
            raise ValueError(
                f"step at {y:04d}-{m:02d} doy={date.doy} sec={date.sec} "
                f"needs forcing interval {idx}, but {self._path(y, m)} "
                f"spans {len(data['dtime'])} samples"
                + ("" if data["has_bridge"] else
                   f" and {nxt} does not exist to bridge the month "
                   "boundary"))
        t0 = idx * dt_forc
        wt2 = float((tmid - t0) / dt_forc)
        return idx, 1.0 - wt2, wt2

    @property
    def dt_forcing(self) -> float:
        """Forcing sample interval [s], probed from the first file's
        DTIME (used by the series layout's fixed-window padding)."""
        if getattr(self, "_dt_forcing", None) is None:
            files = sorted(glob.glob(self.basename + "*.nc"))
            if not files:
                raise FileNotFoundError(f"{self.basename}*.nc: no files")
            # the header and one small variable, through scipy's map: the
            # native reader would load the whole month for them
            dt = netcdf.mapped(files[0],
                               lambda f: netcdf.read_var(f, "DTIME"))
            self._dt_forcing = (float(dt[1] - dt[0]) * 86400.0
                                if len(dt) > 1 else 86400.0)
        return self._dt_forcing

    def series(self, start: Date, nsteps: int,
               dtime: float) -> tuple[ForcingSeries, SeriesSteps]:
        """The raw forcing-grid sample series covering ``nsteps`` steps
        plus per-step bracket indices/weights — the production ingest
        layout, from actual month files (the reference's own windowed
        read, ``atm_data_impl.hh:248-319``).  Gathering rows ``idx1``/
        ``idx1+1`` with ``wt1/wt2`` reproduces :meth:`window`'s per-step
        samples bit-for-bit: both paths read the same file rows (month
        bridges dedupe to the next month's row 0) and share
        :meth:`_locate`'s arithmetic."""
        # pass 1: per-step (year, month, in-month idx, weights)
        date = start.copy()
        info, months = [], []
        for _ in range(nsteps):
            y, m, _ = date.date()
            data = self._load_month(y, m)
            idx, wt1, wt2 = self._locate(date, dtime, data, y, m)
            if (y, m) not in months:
                months.append((y, m))
            info.append((y, m, idx, wt1, wt2, date.decimal_doy() + 1.0))
            date.increment_seconds(int(dtime))
        # pass 2: concatenate the months' sample rows in time order,
        # dropping every non-final month's bridge row (it duplicates the
        # next month's row 0); record each month's global row offset
        keys = list(self.VAR_NAMES)
        rows = {k: [] for k in keys}
        offsets, off = {}, 0
        ship = set(keys) if self.ship_source_dtype else set()
        for i, (y, m) in enumerate(months):
            data = self._load_month(y, m)
            ship &= data["f32_exact"]
            n = data["tbot"].shape[0]
            take = n if i == len(months) - 1 else \
                n - (1 if data["has_bridge"] else 0)
            offsets[(y, m)] = off
            for k in keys:
                rows[k].append(data[k][:take])
            off += take
        cat = {k: np.concatenate(rows[k], axis=0) for k in keys}
        idx1 = np.asarray([offsets[(y, m)] + idx
                           for y, m, idx, _, _, _ in info], np.int64)
        if idx1.max() + 1 >= off:
            raise ValueError("series bracket exceeds the assembled span "
                             "(missing month-boundary bridge file?)")
        imin = int(idx1.min())
        # trim to the bracketed span [first idx1, last idx1+1] so the
        # payload ships only the rows the window gathers (not the rest
        # of the month) and window-sized payloads share a shape
        # regardless of where in a month they fall
        cat = {k: v[imin:int(idx1.max()) + 2] for k, v in cat.items()}
        # demote ship-safe variables back to their on-disk f32 (exact:
        # every month in the span stores them as unpacked NC_FLOAT, so
        # the cached f64 values originated as f32 and the round trip is
        # an identity); the device promotes after the bracket gather, so
        # trajectories are bit-identical while those variables' H2D
        # payload halves
        for k in ship:
            cat[k] = cat[k].astype(np.float32)
        return (ForcingSeries(**cat),
                SeriesSteps(idx1=(idx1 - imin).astype(np.int32),
                            wt1=np.asarray([x[3] for x in info]),
                            wt2=np.asarray([x[4] for x in info]),
                            decday=np.asarray([x[5] for x in info])))

    def window(self, date: Date, dtime: float) -> StepForcing:
        y, m, d = date.date()
        data = self._load_month(y, m)
        idx, wt1, wt2 = self._locate(date, dtime, data, y, m)

        return StepForcing(
            wt1=wt1, wt2=wt2,
            tbot=data["tbot"][idx:idx + 2],
            pbot=data["pbot"][idx:idx + 2],
            qbot=data["qbot"][idx:idx + 2],
            flds=data["flds"][idx:idx + 2],
            wind=data["wind"][idx:idx + 2],
            fsds=data["fsds"][idx], prec=data["prec"][idx],
            decday=date.decimal_doy() + 1.0)
