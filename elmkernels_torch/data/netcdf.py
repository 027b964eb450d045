"""NetCDF-classic reading and writing through scipy (the port's own copy
of what it needs from ``elmkernels_tpu/data/netcdf_io.py``)."""

from __future__ import annotations

import numpy as np


def open_nc(path):
    """Open a NetCDF-classic file for reading, fully loaded (no mmap)."""
    from scipy.io import netcdf_file
    return netcdf_file(str(path), mmap=False)


def write_nc(path, dims: dict, variables: dict) -> None:
    """Create a NetCDF-classic file.  ``dims``: name -> length (None for
    the record dim); ``variables``: name -> (dim_names tuple, ndarray)."""
    from scipy.io import netcdf_file
    with netcdf_file(str(path), "w") as f:
        for dname, dlen in dims.items():
            f.createDimension(dname, dlen)
        for vname, (vdims, arr) in variables.items():
            arr = np.asarray(arr)
            v = f.createVariable(vname, arr.dtype.char, tuple(vdims))
            v[:] = arr
