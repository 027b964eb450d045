"""NetCDF-classic reading and writing (the port's own copy of what it
needs from ``elmkernels_tpu/data/netcdf_io.py``).

As in the JAX package, :func:`read_var` and :func:`var_packing` given a
path read through the native reader (:mod:`elmkernels_torch.io.native`,
which picks up a file :func:`prefetch` loaded); given an open scipy
``netcdf_file`` they read through scipy.  Headers (dimension names and
shapes, variable lookup) are read through scipy with the file mapped
(``mmap=True``), which parses the header and touches no data.  Writing is
scipy's.
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
    """Load ``path`` on the native reader's background thread while the
    device computes; a later native open of the same ``str(path)`` takes
    it."""
    from elmkernels_torch.io import native
    native.prefetch(path)


def open_native(path):
    """``path`` open in the native reader (a prefetched load of the same
    ``str(path)`` if there is one); close it, or use it in a ``with``."""
    from elmkernels_torch.io import native
    return native.NativeNetCDF(path)


def _read_native(f, name: str, start, count) -> np.ndarray:
    """A hyperslab from an open native file, scale then offset applied as
    the JAX package applies them (``netcdf_io.py:39-48``)."""
    arr = f.read(name, start=start, count=count)
    scale = f.attr(name, "scale_factor")
    off = f.attr(name, "add_offset")
    if scale is not None and scale != 1.0:
        arr = arr * scale
    if off is not None and off != 0.0:
        arr = arr + off
    return arr


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
    ``path_or_file`` is a path (read by the native reader), a file
    :func:`open_native` opened, or an open scipy ``netcdf_file``."""
    if hasattr(path_or_file, "variables"):
        return _read(path_or_file.variables[name], start, count)
    if hasattr(path_or_file, "attr"):
        return _read_native(path_or_file, name, start, count)
    with open_native(path_or_file) as f:
        return _read_native(f, name, start, count)


# on-disk NetCDF type ids of the float types
_NC_DTYPE = {5: "f4", 6: "f8"}


def var_packing(path, name: str) -> tuple[str, float, float]:
    """On-disk storage of a variable: (numpy dtype string, scale, offset),
    the dtype ``"other"`` for non-float storage.  A variable stored as
    NC_FLOAT with no packing carries exactly 32 bits a value, so it can be
    shipped as float32 and promoted after use, bit for bit.  Reads
    ``path`` (or a file :func:`open_native` opened) by the native
    reader."""
    if not hasattr(path, "attr"):
        with open_native(path) as f:
            return var_packing(f, name)
    f = path
    if f.var_type(name) < 0:
        raise KeyError(name)
    scale = f.attr(name, "scale_factor")
    off = f.attr(name, "add_offset")
    return (_NC_DTYPE.get(f.var_type(name), "other"),
            1.0 if scale is None else float(scale),
            0.0 if off is None else float(off))


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


def reshape_and_write_grid_cell(path, cell_vars: dict, nlat: int,
                                nlon: int) -> None:
    """(t, cell) arrays back to (t, lat, lon) files, and (cell,) arrays to
    (lat, lon): the reference's test-input writer
    (``read_input.hh:280-309``), used to cut per-cell inputs from gridded
    data."""
    dims = {"time": None, "lat": nlat, "lon": nlon}
    variables = {}
    for name, arr in cell_vars.items():
        arr = np.asarray(arr)
        if arr.ndim == 2:  # (t, cell)
            variables[name] = (("time", "lat", "lon"),
                               arr.reshape(arr.shape[0], nlat, nlon))
        else:  # (cell,)
            variables[name] = (("lat", "lon"), arr.reshape(nlat, nlon))
    write_nc(path, dims, variables)
