"""ctypes bindings for the port's native NetCDF-3 reader
(``elmkernels_torch/csrc/elmio.cc``).

Counterpart of ``elmkernels_tpu/io/native.py``.  Hyperslab reads come from
a resident C++ parse of the whole file, and :func:`prefetch` loads a file
on a background C++ thread while the device computes; a later
:class:`NativeNetCDF` of the same path (the same ``str(path)``) takes the
loaded file instead of reading it again.

The library is the port's own: g++ builds it from the source in this
checkout at first use, with the JAX package's Makefile flags, into
``build/native`` at the root of the checkout (listed in ``.gitignore``);
its file name carries a hash of the source and the flags, so a changed
source is rebuilt.  No ``nvcc`` is needed.  A failed build raises with
g++'s output: nothing falls back to scipy.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "elmio.cc"
BUILD_DIR = _PKG.parent / "build" / "native"
# the JAX package's native/Makefile: CXXFLAGS and -shared
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-Wall", "-pthread", "-shared")

_lib = None
_lib_lock = threading.Lock()


def library_path() -> pathlib.Path:
    """Where the library built from the current source lives."""
    key = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libelmio_{key[:12]}.so"


def build() -> pathlib.Path:
    """Compile the reader with g++ if its library is missing; returns the
    library's path.  The file appears whole (built aside, then renamed),
    so concurrent builders do not see each other's partial output."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed to build {SOURCE.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.elmio_open.argtypes = [ctypes.c_char_p]
        lib.elmio_open.restype = ctypes.c_int
        lib.elmio_close.argtypes = [ctypes.c_int]
        lib.elmio_close.restype = None
        lib.elmio_last_error.argtypes = []
        lib.elmio_last_error.restype = ctypes.c_char_p
        lib.elmio_var_ndims.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]
        lib.elmio_var_ndims.restype = ctypes.c_int
        lib.elmio_get_att.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double)]
        lib.elmio_get_att.restype = ctypes.c_int
        lib.elmio_var_type.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.elmio_var_type.restype = ctypes.c_int
        lib.elmio_read_f64.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)]
        lib.elmio_read_f64.restype = ctypes.c_int
        lib.elmio_prefetch.argtypes = [ctypes.c_char_p]
        lib.elmio_prefetch.restype = None
        lib.elmio_take_prefetched.argtypes = [ctypes.c_char_p]
        lib.elmio_take_prefetched.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the reader is built and loaded (builds it if needed; a
    failed build raises)."""
    return _load() is not None


def prefetch(path: str | os.PathLike) -> None:
    """Load ``path`` on a background C++ thread; the next
    :class:`NativeNetCDF` of ``str(path)`` takes it.  A missing file fails
    there, not here."""
    _load().elmio_prefetch(str(path).encode())


class NativeNetCDF:
    """Read-only NetCDF-3 (classic / 64-bit offset) file.

    ``read(name, start, count)`` returns a float64 array of shape
    ``count``; ``shape(name)`` resolves the record dimension.  Opening
    takes a file :func:`prefetch` loaded under the same ``str(path)``, if
    there is one.  Close it (or use it as a context manager); closing
    twice, or from two threads, closes the handle once."""

    def __init__(self, path: str | os.PathLike):
        lib = _load()
        self._lib = lib
        self._close_lock = threading.Lock()
        self._h = -1
        p = str(path).encode()
        h = lib.elmio_take_prefetched(p)
        if h < 0:
            h = lib.elmio_open(p)
        if h < 0:
            raise OSError(f"{path}: {lib.elmio_last_error().decode()}")
        self._h = h

    def close(self) -> None:
        with self._close_lock:
            h, self._h = self._h, -1
        if h >= 0:
            self._lib.elmio_close(h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # a handle whose __init__ failed has no lock and nothing to close
        if getattr(self, "_h", -1) >= 0:
            self.close()

    def _handle(self) -> int:
        if self._h < 0:
            raise ValueError("read of a closed NativeNetCDF")
        return self._h

    def shape(self, name: str) -> tuple[int, ...]:
        dims = (ctypes.c_int64 * 32)()
        nd = self._lib.elmio_var_ndims(self._handle(), name.encode(), dims)
        if nd < 0:
            raise KeyError(name)
        return tuple(dims[i] for i in range(nd))

    def var_type(self, name: str) -> int:
        """On-disk NetCDF type id (NC_FLOAT=5, NC_DOUBLE=6, ...); negative
        if unknown."""
        return self._lib.elmio_var_type(self._handle(), name.encode())

    def attr(self, var: str, att: str) -> float | None:
        """The first value of a numeric attribute, or None."""
        out = ctypes.c_double()
        rc = self._lib.elmio_get_att(self._handle(), var.encode(),
                                     att.encode(), ctypes.byref(out))
        return out.value if rc == 0 else None

    def read(self, name: str, start=None, count=None) -> np.ndarray:
        """The hyperslab [start, start + count) of ``name`` as float64
        (default: the whole variable)."""
        shp = self.shape(name)
        nd = len(shp)
        start = (0,) * nd if start is None else tuple(int(s) for s in start)
        count = (tuple(s - st for s, st in zip(shp, start)) if count is None
                 else tuple(int(n) for n in count))
        if len(start) != nd or len(count) != nd or any(
                st < 0 or n < 0 or st + n > s
                for st, n, s in zip(start, count, shp)):
            raise ValueError(f"{name}: hyperslab start={start} "
                             f"count={count} outside shape {shp}")
        out = np.empty(count, dtype=np.float64)
        rc = self._lib.elmio_read_f64(
            self._handle(), name.encode(), (ctypes.c_int64 * nd)(*start),
            (ctypes.c_int64 * nd)(*count),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if rc != 0:
            raise OSError(f"elmio_read_f64({name}) failed: rc={rc}")
        return out
