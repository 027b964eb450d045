"""Soil surface data: color-class albedo tables and texture readers.

The port's own copy of ``elmkernels_tpu/data/soil_data.py`` (reference
``soil_data.h``/``soil_data_impl.hh``): the saturated and dry albedo
tables of the 8 and 20 soil colors, and readers of SOIL_COLOR,
PCT_SAND/PCT_CLAY/ORGANIC and ``organic_max``.
"""

from __future__ import annotations

import numpy as np

from elmkernels_torch.data.netcdf import mapped

# 20-class soil albedo tables (reference soil_data_impl.hh:5-140)
ALBSAT_20 = np.array([
    [0.25, 0.50], [0.23, 0.46], [0.21, 0.42], [0.20, 0.40], [0.19, 0.38],
    [0.18, 0.36], [0.17, 0.34], [0.16, 0.32], [0.15, 0.30], [0.14, 0.28],
    [0.13, 0.26], [0.12, 0.24], [0.11, 0.22], [0.10, 0.20], [0.09, 0.18],
    [0.08, 0.16], [0.07, 0.14], [0.06, 0.12], [0.05, 0.10], [0.04, 0.08]])
ALBDRY_20 = np.array([
    [0.36, 0.61], [0.34, 0.57], [0.32, 0.53], [0.31, 0.51], [0.30, 0.49],
    [0.29, 0.48], [0.28, 0.45], [0.27, 0.43], [0.26, 0.41], [0.25, 0.39],
    [0.24, 0.37], [0.23, 0.35], [0.22, 0.33], [0.20, 0.31], [0.18, 0.29],
    [0.16, 0.27], [0.14, 0.25], [0.12, 0.23], [0.10, 0.21], [0.08, 0.16]])
# the reference's 8-class table reads 12.0 for the first vis entry, a
# literal typo for 0.12, corrected here as in the JAX package
ALBSAT_8 = np.array([
    [0.12, 0.24], [0.11, 0.22], [0.10, 0.20], [0.09, 0.18], [0.08, 0.16],
    [0.07, 0.14], [0.06, 0.12], [0.05, 0.10]])
ALBDRY_8 = np.array([
    [0.24, 0.48], [0.22, 0.44], [0.20, 0.40], [0.18, 0.36], [0.16, 0.32],
    [0.14, 0.28], [0.12, 0.24], [0.10, 0.20]])


def get_albsat(mxsoil_color: int) -> np.ndarray:
    if mxsoil_color == 8:
        return ALBSAT_8
    if mxsoil_color == 20:
        return ALBSAT_20
    raise ValueError("mxsoil_color must be 8 or 20")


def get_albdry(mxsoil_color: int) -> np.ndarray:
    if mxsoil_color == 8:
        return ALBDRY_8
    if mxsoil_color == 20:
        return ALBDRY_20
    raise ValueError("mxsoil_color must be 8 or 20")


def mxsoil_color_of(f) -> int:
    """``mxsoil_color`` of an open surfdata file (20 when absent)."""
    if "mxsoil_color" not in f.variables:
        return 20
    return int(np.asarray(f.variables["mxsoil_color"].data).ravel()[0])


def read_soil_colors(path, ncol: int, col0: int = 0):
    """SOIL_COLOR classes of cells [col0, col0+ncol) and their albsat/
    albdry rows (reference ``read_soil_colors``)."""
    def read(f):
        color = np.asarray(f.variables["SOIL_COLOR"].data).reshape(-1)
        return mxsoil_color_of(f), color[col0:col0 + ncol].astype(int)
    mx, color = mapped(path, read)
    idx = np.clip(color - 1, 0, mx - 1)
    return color, get_albsat(mx)[idx], get_albdry(mx)[idx]


def read_soil_texture(path, ncol: int, col0: int = 0):
    """PCT_SAND/PCT_CLAY/ORGANIC profiles [ncol, nlevsoi] (reference
    ``read_soil_texture``)."""
    def grab(f, name):
        arr = np.asarray(f.variables[name].data, np.float64)
        arr = arr.reshape(arr.shape[0], -1)     # (lev, cells)
        return arr[:, col0:col0 + ncol].T.copy()  # (ncol, lev)
    return mapped(path, lambda f: tuple(
        grab(f, n) for n in ("PCT_SAND", "PCT_CLAY", "ORGANIC")))


def read_organic_max(param_path) -> float:
    return mapped(param_path, lambda f: float(
        np.asarray(f.variables["organic_max"].data).ravel()[0]))
