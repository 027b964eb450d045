"""The reference's reader of month-per-file forcing: a frozen copy of the
port's plain ``NetCDFForcing`` path (``elmkernels_torch/data/forcing.py``:
``_locate``, ``window``, the bridge row from the next month, QBOT or RH),
after the reference's ``atm_data_impl.hh:100-319``.

It reads through scipy, with each file mapped, and never through the
port's native reader, so that a fault in the program's decode shows as a
gap; and it reads only the columns it is given (cells of the files'
flattened grid) at the samples its steps bracket, so that it costs the
reference little of a run: a month's file is 1.8 GB, a sample of the
compared columns 115 KB.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from portbench.reference.elm.data.netcdf import mapped
from portbench.reference.elm.data.state import StepForcing
from portbench.reference.elm.utils.dates import Date


class NetCDFForcing:
    """Forcing of the cells ``cols`` from ``<basename>YYYY-MM.nc`` files:
    variables TBOT/PBOT/QBOT-or-RH/FLDS/FSDS/PRECTmms/WIND with dims in
    any order that hold DTIME (days since the file's start); cells flatten
    in C order over the other dims.  A month's samples are extended by the
    next month's first, where that file exists; a step outside them
    raises.  Samples read are kept for the months held (two at most)."""

    VAR_NAMES = {"tbot": "TBOT", "pbot": "PBOT", "qbot": "QBOT",
                 "flds": "FLDS", "wind": "WIND", "fsds": "FSDS",
                 "prec": "PRECTmms"}

    def __init__(self, basename: str, cols):
        self.basename = basename
        self.cols = np.asarray(cols, np.int64)
        self._cache: dict[tuple[int, int], dict] = {}
        self.qbot_is_rh = self._probe_humidity()

    def _probe_humidity(self) -> bool:
        """QBOT or RH, from the first file of the set."""
        files = sorted(glob.glob(self.basename + "*.nc"))
        if not files:
            return False
        names = mapped(files[0], lambda f: set(f.variables))
        if "QBOT" in names:
            return False
        if "RH" in names:
            return True
        raise ValueError(f"{files[0]}: neither QBOT nor RH present")

    def _path(self, year: int, month: int) -> str:
        return f"{self.basename}{year:04d}-{month:02d}.nc"

    def _read_cells(self, f, vname: str, row: int) -> np.ndarray:
        """[len(cols)] float64 of one variable of an open file at sample
        ``row``, its scale and offset applied."""
        v = f.variables[vname]
        dims, shape = v.dimensions, v.shape
        taxes = [i for i, d in enumerate(dims)
                 if d.lower() in ("dtime", "time")]
        if len(taxes) != 1:
            raise ValueError(f"{vname}: cannot identify the time axis "
                             f"among dims {dims}")
        taxis = taxes[0]
        other = [i for i in range(len(shape)) if i != taxis]
        ncell = int(np.prod([shape[i] for i in other]))
        if self.cols.size and self.cols.max() >= ncell:
            raise ValueError(f"{vname}: {ncell} cells, column "
                             f"{self.cols.max()} asked for")
        index = [None] * len(shape)
        index[taxis] = row
        for i, ix in zip(other, np.unravel_index(
                self.cols, [shape[i] for i in other])):
            index[i] = ix
        arr = np.array(v.data[tuple(index)], dtype=np.float64)
        scale = float(getattr(v, "scale_factor", 1.0))
        off = float(getattr(v, "add_offset", 0.0))
        if scale != 1.0 or off != 0.0:
            arr = arr * scale + off
        return arr

    def _load_month(self, year: int, month: int) -> dict:
        """A month's sample times, extended by the next month's first
        where that file exists (the reference's windows are continuous
        in time); its rows are read as the steps ask for them."""
        key = (year, month)
        if key in self._cache:
            return self._cache[key]
        dtime = mapped(self._path(year, month), lambda f: np.array(
            f.variables["DTIME"].data, dtype=np.float64))
        ny, nm = (year, month + 1) if month < 12 else (year + 1, 1)
        data = {"dtime": dtime, "rows": {},
                "has_bridge": os.path.exists(self._path(ny, nm))}
        if data["has_bridge"]:
            dt = dtime[1] - dtime[0] if len(dtime) > 1 else 1.0
            data["dtime"] = np.concatenate([dtime, [dtime[-1] + dt]])
        self._cache[key] = data
        if len(self._cache) > 2:
            self._cache.pop(next(iter(self._cache)))
        return data

    def _row(self, data: dict, year: int, month: int, row: int) -> dict:
        """{key: [len(cols)]} of sample ``row`` of a month: the month's
        own, or past its end the next month's first (the bridge row)."""
        if row not in data["rows"]:
            names = dict(self.VAR_NAMES)
            if self.qbot_is_rh:
                names["qbot"] = "RH"
            path, at = self._path(year, month), row
            if row >= len(data["dtime"]) - int(data["has_bridge"]):
                ny, nm = (year, month + 1) if month < 12 else (year + 1, 1)
                path, at = self._path(ny, nm), 0
            data["rows"][row] = mapped(path, lambda f: {
                k: self._read_cells(f, v, at) for k, v in names.items()})
        return data["rows"][row]

    def _locate(self, date: Date, dtime: float, data: dict,
                y: int, m: int) -> tuple[int, float, float]:
        """In-month bracket index and weights of the step from ``date``:
        point data at the step's midpoint."""
        dt_forc = ((data["dtime"][1] - data["dtime"][0]) * 86400.0
                   if len(data["dtime"]) > 1 else 86400.0)
        file_start_doy = Date.from_ymd(y, m, 1).doy
        tmid = (date.doy - file_start_doy) * 86400.0 + date.sec \
            + 0.5 * dtime
        idx = int(np.floor(tmid / dt_forc))
        if not 0 <= idx <= len(data["dtime"]) - 2:
            raise ValueError(
                f"step at {y:04d}-{m:02d} doy={date.doy} sec={date.sec} "
                f"needs forcing interval {idx}, but {self._path(y, m)} "
                f"spans {len(data['dtime'])} samples")
        t0 = idx * dt_forc
        wt2 = float((tmid - t0) / dt_forc)
        return idx, 1.0 - wt2, wt2

    def window(self, date: Date, dtime: float) -> StepForcing:
        y, m, _ = date.date()
        data = self._load_month(y, m)
        idx, wt1, wt2 = self._locate(date, dtime, data, y, m)
        a, b = (self._row(data, y, m, i) for i in (idx, idx + 1))

        def pair(k):
            return np.stack([a[k], b[k]])
        return StepForcing(
            wt1=wt1, wt2=wt2, tbot=pair("tbot"), pbot=pair("pbot"),
            qbot=pair("qbot"), flds=pair("flds"), wind=pair("wind"),
            fsds=a["fsds"], prec=a["prec"],
            decday=date.decimal_doy() + 1.0)
