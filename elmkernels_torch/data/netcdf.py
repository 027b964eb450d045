"""NetCDF-classic reading and writing through scipy (the port's own copy
of what it needs from ``elmkernels_tpu/data/netcdf_io.py``).

Hyperslab reads map the file (``mmap=True``) and copy out only the slice,
so a per-host read of a few rows does not load the whole variable.
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


def prefetch(path) -> None:
    """Warm ``path`` while the device computes.  The JAX package does this
    on a native reader's thread; the port has no native reader yet, so
    this does nothing."""


def _read(v, start, count) -> np.ndarray:
    arr = v.data
    if start is not None:
        arr = arr[tuple(slice(s, s + n) for s, n in zip(start, count))]
    arr = np.array(arr, dtype=np.float64)
    scale = float(getattr(v, "scale_factor", 1.0))
    off = float(getattr(v, "add_offset", 0.0))
    if scale != 1.0 or off != 0.0:
        arr = arr * scale + off
    return arr


def read_var(path_or_file, name: str, start=None, count=None) -> np.ndarray:
    """Read (a hyperslab of) a variable as float64, applying its
    scale/offset attributes (reference ``read_netcdf.hh:43-130``).
    ``path_or_file`` is a path or an open scipy ``netcdf_file``."""
    if hasattr(path_or_file, "variables"):
        return _read(path_or_file.variables[name], start, count)
    return mapped(path_or_file,
                  lambda f: _read(f.variables[name], start, count))


def var_packing(path, name: str) -> tuple[str, float, float]:
    """On-disk storage of a variable: (numpy dtype string, scale, offset),
    the dtype ``"other"`` for non-float storage.  A variable stored as
    NC_FLOAT with no packing carries exactly 32 bits a value, so it can be
    shipped as float32 and promoted after use, bit for bit."""
    def get(f):
        v = f.variables[name]
        return ({"f": "f4", "d": "f8"}.get(v.typecode(), "other"),
                float(getattr(v, "scale_factor", 1.0)),
                float(getattr(v, "add_offset", 0.0)))
    return mapped(path, get)


def get_dimensions(path, name: str) -> tuple[int, ...]:
    return mapped(path, lambda f: tuple(int(d) for d in
                                        f.variables[name].shape))


def get_var_dimnames(path, name: str) -> tuple[str, ...]:
    """Dimension names of a variable (reference ``get_var_dimids``,
    ``read_netcdf.hh:132-150``)."""
    return mapped(path, lambda f: tuple(f.variables[name].dimensions))


def has_variable(path, name: str) -> bool:
    return mapped(path, lambda f: name in f.variables)


def reshape_grid_to_cells(arr: np.ndarray) -> np.ndarray:
    """(t, lat, lon) -> (t, cell), as the reference's
    ``read_and_reshape_forcing`` (``read_input.hh:150-309``)."""
    if arr.ndim >= 3:
        return arr.reshape(arr.shape[0], -1)
    return arr


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
