"""Surfdata-driven per-column grid.

The port's own copy of ``elmkernels_tpu/data/surfdata.py``: one
surfdata-style NetCDF read into the per-column site arrays that
``data.params.default_params`` takes (lat/lon, soil color, texture
profiles, dominant PFT, topography), after the reference's heterogeneous
grid init (``initialize_elm_kokkos.cc:267-340``,
``soil_data_impl.hh:139-241``, ``utils.cc:46-69``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from portbench.reference.elm.data.netcdf import mapped
from portbench.reference.elm.data.soil_data import (mxsoil_color_of,
                                             read_soil_colors,
                                             read_soil_texture)


class SurfData(NamedTuple):
    """Per-column site arrays read from one surfdata NetCDF."""
    lat_deg: np.ndarray        # [ncol]
    lon_deg: np.ndarray        # [ncol]
    vtype: np.ndarray | None   # [ncol] i32 dominant PFT (None if absent)
    soil_color: np.ndarray     # [ncol] color class (1-based)
    mxsoil_color: int
    pct_sand: np.ndarray       # [ncol, nlevsoi]
    pct_clay: np.ndarray
    organic: np.ndarray
    topo_slope: np.ndarray | None  # [ncol] raw slope (None if absent)
    topo_std: np.ndarray | None    # [ncol] elevation std (None if absent)


def _grid_var(f, names, ncol, col0, path):
    """A per-cell variable by the first of ``names`` present, flattened
    to [ncol]; None if none is present."""
    for name in names:
        if name in f.variables:
            arr = np.asarray(f.variables[name].data, np.float64).reshape(-1)
            if arr.size < col0 + ncol:
                raise ValueError(
                    f"{path}:{name}: {arr.size} cells < col0+ncol "
                    f"{col0 + ncol}")
            return arr[col0:col0 + ncol].copy()
    return None


def read_surfdata(path, ncol: int, col0: int = 0) -> SurfData:
    """The per-column grid of cells [col0, col0+ncol) of the flattened
    (lat, lon) cell axis.  Variables: LATIXY/LONGXY, SOIL_COLOR +
    mxsoil_color, PCT_SAND/PCT_CLAY/ORGANIC [(nlevsoi), lat, lon], and
    optionally PCT_NAT_PFT [(natpft), lat, lon] (dominant = argmax) or a
    PFT index variable, SLOPE and STD_ELEV."""
    def read(f):
        out = {}
        for key, names in (("lat", ["LATIXY", "LATITUDE", "lat"]),
                           ("lon", ["LONGXY", "LONGITUDE", "lon"])):
            out[key] = _grid_var(f, names, ncol, col0, path)
            if out[key] is None:
                raise KeyError(f"{path}: none of {names} present")
        out["topo_slope"] = _grid_var(f, ["SLOPE", "TOPO_SLOPE"], ncol,
                                      col0, path)
        out["topo_std"] = _grid_var(f, ["STD_ELEV", "TOPO_STD"], ncol,
                                    col0, path)
        out["mx"] = mxsoil_color_of(f)
        vtype = None
        if "PCT_NAT_PFT" in f.variables:
            pct = np.asarray(f.variables["PCT_NAT_PFT"].data, np.float64)
            pct = pct.reshape(pct.shape[0], -1)  # (pft, cells)
            vtype = np.argmax(pct[:, col0:col0 + ncol],
                              axis=0).astype(np.int32)
        elif "PFT" in f.variables:
            vtype = np.asarray(f.variables["PFT"].data).reshape(-1)[
                col0:col0 + ncol].astype(np.int32)
        out["vtype"] = vtype
        return out
    g = mapped(path, read)
    color, _albsat, _albdry = read_soil_colors(path, ncol, col0)
    sand, clay, org = read_soil_texture(path, ncol, col0)
    return SurfData(lat_deg=g["lat"], lon_deg=g["lon"], vtype=g["vtype"],
                    soil_color=np.asarray(color), mxsoil_color=g["mx"],
                    pct_sand=sand, pct_clay=clay, organic=org,
                    topo_slope=g["topo_slope"], topo_std=g["topo_std"])
