"""Aerosol deposition inputs (BC + 4 dust bins).

The port's own copy of ``elmkernels_tpu/data/aerosol_data.py``, after the
reference's ``AerosolFileInput`` (``aerosol_data.h:10-51``) and its
monthly ``AerosolDataManager`` (``aerosol_data_old.h``): the 12-month
climatological deposition file, interpolated to the step time.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.elm.data.netcdf import mapped
from portbench.reference.elm.utils.dates import (Date, month_indices,
                                          monthly_data_weights)

# NetCDF variable names in aerosoldep_monthly*.nc, in AERO_DEP_KEYS order
# (reference aerosol_data_old_impl.hh)
DEP_VARS = {"bcphi": "BCPHIDRY", "bcpho": "BCPHODRY", "bcdep": "BCDEPWET",
            "dst1_1": "DSTX01DD", "dst1_2": "DSTX01WD",
            "dst2_1": "DSTX02DD", "dst2_2": "DSTX02WD",
            "dst3_1": "DSTX03DD", "dst3_2": "DSTX03WD",
            "dst4_1": "DSTX04DD", "dst4_2": "DSTX04WD"}


class AerosolDataManager:
    """Monthly climatological deposition rates, month-interpolated."""

    def __init__(self, path: str, ncol: int, col0: int = 0):
        def read(f):
            data = {}
            for k, vname in DEP_VARS.items():
                arr = np.asarray(f.variables[vname].data, np.float64)
                arr = arr.reshape(arr.shape[0], -1)  # (12, cells)
                data[k] = arr[:, col0:col0 + ncol].copy()
            return data
        self.data = mapped(path, read)

    def rates(self, date: Date) -> dict:
        """Deposition rates [kg/m2/s] per species at ``date``."""
        m1, m2 = month_indices(date)
        wt1, wt2 = monthly_data_weights(date)
        return {k: wt1 * v[m1] + wt2 * v[m2] for k, v in self.data.items()}

    def bracket(self, date: Date) -> np.ndarray:
        """The month-bracket deposition pair of the series layout:
        [2, 11, ncol] in ``AERO_DEP_KEYS`` order.  The device applies
        ``wt1*a[0] + wt2*a[1]`` (the arithmetic of :meth:`rates`) with the
        phenology stream's monthly weights."""
        m1, m2 = month_indices(date)
        return np.stack([
            np.stack([self.data[k][m] for k in DEP_VARS])
            for m in (m1, m2)])


class SteadyAerosol:
    """Constant deposition rates (when no deposition file exists)."""

    def __init__(self, ncol: int, scale: float = 1.0e-12):
        self.ncol = ncol
        self.scale = scale

    def rates(self, date: Date) -> dict:
        return {k: np.full(self.ncol, self.scale * (i + 1))
                for i, k in enumerate(DEP_VARS)}

    def bracket(self, date: Date) -> np.ndarray:
        one = np.stack([self.rates(date)[k] for k in DEP_VARS])
        return np.stack([one, one])
