"""Input kind ``forcing``: atmospheric forcing in month files, one NetCDF
file a month named ``<basename>YYYY-MM.nc``, in the layout of ELMKernels'
reader (``atm_data_impl.hh``) and of E3SM's datm GSWP3v1 streams: DTIME in
days since the month's start; TBOT, PBOT, QBOT, FLDS, FSDS, PRECTmms and
WIND on (DTIME, lat, lon) as NC_FLOAT, the grid's cells flattened in C
order.  The program reads them through ``Model(forcing_basename=...)``
(its ``NetCDFForcing`` and native reader), the reference through its
scipy copy of that reader (``reference/elm/data/forcing_files.py``) over
the compared columns.

The configuration's ``inputs.forcing``: ``basename``, ``first_month``
(``"YYYY-MM"``), ``months``, ``dt_hours`` (the sampling interval) and
``grid`` ([nlat, nlon]; a grid of fewer columns keeps ``nlon`` where it
can, for a rehearsal on the CPU).

The fields are a copy of ``elmkernels_torch/data/synthetic.py``'s
``forcing_month_fields``, with one change: the diurnal cycle and FSDS
follow each cell's local solar time, from the surfdata's longitude, so
that day and night move across the grid as in a reanalysis.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

ROLE = "forcing"
VARS = ("TBOT", "PBOT", "QBOT", "FLDS", "FSDS", "PRECTmms", "WIND")
# time rows computed at once (float64 temporaries of this many rows)
CHUNK = 16


def _spec(cfg: dict) -> dict:
    return cfg["inputs"]["forcing"]


def _months(spec: dict) -> list[tuple[int, int]]:
    y, m = (int(v) for v in spec["first_month"].split("-"))
    out = []
    for _ in range(int(spec["months"])):
        out.append((y, m))
        y, m = (y, m + 1) if m < 12 else (y + 1, 1)
    return out


def grid_shape(spec: dict, ncol: int) -> tuple[int, int]:
    """(nlat, nlon) of the files of ``ncol`` columns."""
    nlat, nlon = (int(v) for v in spec["grid"])
    if nlat * nlon == ncol:
        return nlat, nlon
    nlon = min(nlon, ncol)
    if ncol % nlon:
        raise ValueError(f"{ncol} columns do not fill rows of {nlon}")
    return ncol // nlon, nlon


def month_fields(year: int, month: int, lon_deg: np.ndarray,
                 dt_hours: float, rows: slice) -> dict:
    """The time rows ``rows`` of one month's fields, (rows, cells) float64
    each: seasonal and diurnal cycles with per-cell phase offsets, the
    diurnal cycle and the sun at each cell's local solar time."""
    from portbench.reference.elm.utils.dates import Date
    ncell = lon_deg.size
    nt = month_rows(month, dt_hours)
    dtime = (np.arange(nt, dtype=np.float64) * (dt_hours / 24.0))[rows]
    doy = Date.from_ymd(year, month, 1).doy + dtime[:, None]
    hour = (doy * 24.0 + lon_deg[None, :] / 15.0) % 24.0
    cell = np.arange(ncell, dtype=np.float64)[None, :]
    phase = 2.0 * np.pi * cell / max(1.0, ncell)
    seasonal = -12.0 * np.cos(2.0 * np.pi * doy / 365.0 + 0.3 * phase)
    diurnal = 6.0 * np.sin(2.0 * np.pi * (hour - 9.0) / 24.0)
    sun = np.maximum(0.0, np.sin(np.pi * (hour - 6.0) / 12.0))
    wet = (np.floor(doy * 3.0 + cell) % 7.0) < 2.0
    return {
        "TBOT": 278.0 + seasonal + diurnal,
        "PBOT": 98000.0 + 500.0 * np.sin(2.0 * np.pi * doy / 29.0 + phase),
        "QBOT": np.maximum(1.0e-4, 0.004 + 0.003 * np.sin(
            2.0 * np.pi * doy / 365.0 + 0.1 * phase)),
        "FLDS": 220.0 + 60.0 * np.cos(2.0 * np.pi * (doy - 200.0) / 365.0
                                      + 0.2 * phase),
        "FSDS": 600.0 * sun * (0.6 + 0.4 * np.sin(2.0 * np.pi * doy
                                                  / 365.0)),
        "PRECTmms": np.where(wet, 2.5e-5, 0.0),
        "WIND": 3.0 + 2.0 * np.sin(2.0 * np.pi * doy / 13.0 + phase)}


def month_rows(month: int, dt_hours: float) -> int:
    from portbench.reference.elm.utils.dates import DAYS_PER_MONTH
    return int(round(DAYS_PER_MONTH[month - 1] * 24.0 / dt_hours))


def write_month(path, year: int, month: int, lon_deg: np.ndarray,
                nlat: int, nlon: int, dt_hours: float) -> None:
    """One month file: DTIME in days, the seven variables in float32 on
    (DTIME, lat, lon), computed ``CHUNK`` rows at a time."""
    from portbench.reference.elm.data.netcdf import write_nc
    nt = month_rows(month, dt_hours)
    out = {k: np.empty((nt, nlat * nlon), np.float32) for k in VARS}
    for a in range(0, nt, CHUNK):
        rows = slice(a, min(nt, a + CHUNK))
        for k, v in month_fields(year, month, lon_deg, dt_hours,
                                 rows).items():
            out[k][rows] = v
    variables = {"DTIME": (("DTIME",), np.arange(nt, dtype=np.float64)
                           * (dt_hours / 24.0))}
    for k in VARS:
        variables[k] = (("DTIME", "lat", "lon"),
                        out.pop(k).reshape(nt, nlat, nlon))
    write_nc(path, {"DTIME": None, "lat": nlat, "lon": nlon}, variables)


def _longitudes(cfg: dict, ncol: int, files: dict) -> np.ndarray:
    """Each column's longitude in degrees east: the surfdata's, or the
    site's."""
    if "surfdata" in files:
        from portbench.reference.elm.data.netcdf import mapped
        return mapped(files["surfdata"], lambda f: np.array(
            f.variables["LONGXY"].data, np.float64).reshape(-1)[:ncol])
    return np.full(ncol, float(cfg["site"]["lon_deg"]))


def write(cfg: dict, ncol: int, files: dict) -> dict:
    """The month files of ``ncol`` columns, in a directory named by the
    configuration's forcing, so that configurations that share it share
    the files."""
    from portbench import inputs
    spec = _spec(cfg)
    tag = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()) \
        .hexdigest()[:12]
    base = inputs.grid_dir(cfg, ncol) / f"forcing_{tag}" / spec["basename"]
    nlat, nlon = grid_shape(spec, ncol)
    lon = None
    for y, m in _months(spec):
        path = base.with_name(f"{base.name}{y:04d}-{m:02d}.nc")
        if not path.exists() and lon is None:
            lon = _longitudes(cfg, ncol, files)
        inputs.ensure(path, lambda p, y=y, m=m: write_month(
            p, y, m, lon, nlat, nlon, float(spec["dt_hours"])))
    return dict(forcing=str(base))


def model_kw(cfg: dict, files: dict) -> dict:
    return dict(forcing_basename=files["forcing"])


def reference(cfg: dict, files: dict, cols, grid: dict):
    from portbench.reference.elm.data.forcing_files import NetCDFForcing
    return NetCDFForcing(files["forcing"], cols)


def horizon(cfg: dict) -> str:
    """The end of the last step the files can force: the last month's
    last sample, which the next month's file would bracket."""
    spec = _spec(cfg)
    y, m = _months(spec)[-1]
    minutes = (month_rows(m, float(spec["dt_hours"])) - 1) \
        * round(60 * float(spec["dt_hours"]))
    return (f"{y:04d}-{m:02d}-{minutes // 1440 + 1:02d} "
            f"{minutes % 1440 // 60:02d}:{minutes % 60:02d}")
