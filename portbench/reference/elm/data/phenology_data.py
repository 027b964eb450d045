"""Monthly satellite-phenology manager with a 3-month ring buffer.

The port's own copy of ``elmkernels_tpu/data/phenology_data.py``, after
the reference's ``PhenologyDataManager`` (``phenology_data.h:24-75``,
``phenology_data_impl.hh:8-130``): it keeps MONTHLY_LAI/SAI/HEIGHT_TOP/
HEIGHT_BOT for the three bracketing months; on a month rollover only the
newest month is read and the buffer rotates.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.elm.data.netcdf import mapped
from portbench.reference.elm.data.state import StepPhenology
from portbench.reference.elm.utils.dates import (Date, monthly_data_weights,
                                          triple_month_indices)

VARS = {"mlai": "MONTHLY_LAI", "msai": "MONTHLY_SAI",
        "mhtop": "MONTHLY_HEIGHT_TOP", "mhbot": "MONTHLY_HEIGHT_BOT"}


class PhenologyDataManager:
    """Per-PFT monthly phenology from a surfdata NetCDF, each cell's own
    ``vtype`` slice (reference ``phenology_data_impl.hh:60-100``)."""

    def __init__(self, path: str, ncol: int, vtype, col0: int = 0):
        self.path = path
        self.ncol = ncol
        self.col0 = col0
        self.vtype = np.asarray(vtype)
        self.buf = {k: np.zeros((3, ncol)) for k in VARS}
        self.months: list[int] = []  # month indices held in buf rows

    def _read_month(self, m: int) -> dict:
        """One month (m in 0..11) for each cell's PFT.  File layout:
        var(time=12, pft, [lat, lon]) or (12, pft, gridcell)."""
        cols = np.arange(self.ncol)

        def read(f):
            out = {}
            for k, vname in VARS.items():
                arr = np.asarray(f.variables[vname].data[m], np.float64)
                arr = arr.reshape(arr.shape[0], -1)      # (pft, cells)
                cells = arr[:, self.col0:self.col0 + self.ncol]
                out[k] = cells[self.vtype, cols]
            return out
        return mapped(self.path, read)

    def update(self, date: Date) -> None:
        """Fill or rotate the ring buffer so that it holds the three
        bracketing months of ``date`` (reference ``need_data``)."""
        want = list(triple_month_indices(date))
        if self.months == want:
            return
        if self.months and self.months[1:] == want[:2]:
            for k in VARS:
                self.buf[k][0:2] = self.buf[k][1:3]
            new = self._read_month(want[2])
            for k in VARS:
                self.buf[k][2] = new[k]
        else:
            for row, m in enumerate(want):
                data = self._read_month(m)
                for k in VARS:
                    self.buf[k][row] = data[k]
        self.months = want

    def window(self, date: Date) -> StepPhenology:
        self.update(date)
        wt1, wt2 = monthly_data_weights(date)
        return StepPhenology(
            wt1=wt1, wt2=wt2,
            mlai=self.buf["mlai"][0:2].copy(),
            msai=self.buf["msai"][0:2].copy(),
            mhtop=self.buf["mhtop"][0:2].copy(),
            mhbot=self.buf["mhbot"][0:2].copy())
