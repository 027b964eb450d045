"""NetCDF history output: periodic time-series files of selected fields.

Counterpart of ``elmkernels_tpu/utils/history.py``.  The reference ships
write primitives (``read_netcdf.hh:173-255``) but its drivers only print;
ELM proper writes history files.  A :class:`HistoryWriter` buffers each
recorded step's named diagnostics or state fields on the host and writes
one NetCDF-classic file per ``every`` records, with a no-leap time
coordinate.  Each record copies every field from the device: record few
fields, or record once a window (``run_windows``' callback), on large runs.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from elmkernels_torch.data.netcdf import write_nc
from elmkernels_torch.utils.dates import Date


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class HistoryWriter:
    """Accumulate selected fields per record; write ``<stem>_NNNN.nc``
    every ``every`` records (and on close).

    ``fields``: names resolved against the diagnostics first, then the
    model state.  [ncol] fields get dims (time, col); layered [ncol, nlev]
    fields get (time, col, lev<nlev>)."""

    def __init__(self, path: str, fields, every: int = 48,
                 ref_date: Date | None = None):
        p = pathlib.Path(path)
        self.stem = p.parent / p.name.replace(".nc", "")
        self.fields = tuple(fields)
        self.every = max(1, int(every))
        self.ref_date = ref_date
        self._buf: dict[str, list[np.ndarray]] = {f: [] for f in self.fields}
        self._times: list[float] = []
        self._seq = 0
        self.written: list[str] = []
        p.parent.mkdir(parents=True, exist_ok=True)

    def _decimal_days(self, date: Date) -> float:
        if self.ref_date is None:
            self.ref_date = date.copy()
        r = self.ref_date
        return ((date.year - r.year) * 365.0 + (date.doy - r.doy)
                + (date.sec - r.sec) / 86400.0)

    def record(self, date: Date, state, diags) -> None:
        self._times.append(self._decimal_days(date))
        for name in self.fields:
            src = diags if hasattr(diags, name) else state
            if not hasattr(src, name):
                raise KeyError(
                    f"history field {name!r} is neither a diagnostic "
                    f"({type(diags).__name__}) nor a state field")
            self._buf[name].append(_host(getattr(src, name)))
        if len(self._times) >= self.every:
            self.flush()

    def flush(self) -> str | None:
        if not self._times:
            return None
        r = self.ref_date
        dims: dict = {"time": None}
        variables: dict = {
            "time": (("time",), np.asarray(self._times, dtype=np.float64))}
        attrs = {"time": {
            "units": (f"days since {r.year:04d} day {r.doy} "
                      f"sec {r.sec} (no-leap calendar)")}}
        for name, chunks in self._buf.items():
            arr = np.stack(chunks)          # [time, ncol, ...]
            dims.setdefault("col", arr.shape[1])
            vdims = ["time", "col"]
            for extent in arr.shape[2:]:
                dn = f"lev{extent}"
                dims.setdefault(dn, extent)
                vdims.append(dn)
            variables[name] = (tuple(vdims), arr.astype(np.float64))
        path = f"{self.stem}_{self._seq:04d}.nc"
        write_nc(path, dims, variables, attrs)
        self.written.append(path)
        self._seq += 1
        self._buf = {f: [] for f in self.fields}
        self._times = []
        return path

    def close(self) -> None:
        self.flush()
