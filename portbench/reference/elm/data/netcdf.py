"""NetCDF-classic reading and writing (the port's own copy of what it
needs from ``elmkernels_tpu/data/netcdf_io.py``).

The benchmark's copy reads through scipy only (the port's native reader
is not part of it): files are opened whole or mapped (``mmap=True``),
which parses the header and touches no data.  Writing is scipy's.
"""

from __future__ import annotations

import numpy as np


def open_nc(path):
    """Open a NetCDF-classic file for reading, fully loaded (no mmap)."""
    from scipy.io import netcdf_file
    return netcdf_file(str(path), mmap=False)


def mapped(path, fn):
    """``fn(f)`` on the file mapped read-only; ``fn`` must return copies,
    so that the map can be closed when it returns."""
    from scipy.io import netcdf_file
    f = netcdf_file(str(path), mmap=True)
    try:
        return fn(f)
    finally:
        f.close()


def write_nc(path, dims: dict, variables: dict,
             attrs: dict | None = None) -> None:
    """Create a NetCDF-classic file.  ``dims``: name -> length (None for
    the record dim); ``variables``: name -> (dim_names tuple, ndarray);
    ``attrs``: variable name -> {attribute: value}."""
    from scipy.io import netcdf_file
    with netcdf_file(str(path), "w") as f:
        for dname, dlen in dims.items():
            f.createDimension(dname, dlen)
        for vname, (vdims, arr) in variables.items():
            arr = np.asarray(arr)
            v = f.createVariable(vname, arr.dtype.char, tuple(vdims))
            v[:] = arr
            for aname, aval in (attrs or {}).get(vname, {}).items():
                setattr(v, aname, aval)
