"""The port's native NetCDF-3 reader (``elmkernels_torch/io/native.py`` over
``elmkernels_torch/csrc/elmio.cc``, built with g++ into ``build/native``)
against scipy, and against the JAX package's reader
(``elmkernels_tpu.io.native``) where its library is present: shapes, full
reads, hyperslabs, attributes, on-disk types, prefetch, a missing variable
and a missing file, a failed build; ``data/netcdf.py``'s ``read_var``,
``var_packing`` and ``reshape_and_write_grid_cell``; and the forcing
windows and a short run from month files, the same bit for bit whichever
reader assembled the inputs.
"""

import pathlib
import threading

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

import torch_parity as tp
from elmkernels_torch.data import netcdf, synthetic
from elmkernels_torch.driver.model import Model
from elmkernels_torch.io import native
from elmkernels_torch.utils.dates import Date
from elmkernels_tpu.data import netcdf_io as jnetcdf
from elmkernels_tpu.io import native as jnative

torch.set_num_threads(1)

VARS = ("TBOT", "PRECIP", "elev", "mask", "scount", "tpack")


@pytest.fixture(scope="module")
def ncfile(tmp_path_factory):
    """Record and fixed variables in f64, f32, i32 and i16, with scale and
    offset attributes, from a seed."""
    path = tmp_path_factory.mktemp("nc") / "forcing.nc"
    rng = np.random.default_rng(7)
    nt, ny, nx = 9, 4, 6
    data = dict(
        TBOT=rng.uniform(240.0, 310.0, (nt, ny, nx)),
        PRECIP=rng.uniform(0.0, 1e-3, (nt, ny, nx)).astype(np.float32),
        elev=rng.uniform(0.0, 3000.0, (ny, nx)).astype(np.float32),
        mask=rng.integers(0, 2, (ny, nx)).astype(np.int32),
        scount=rng.integers(-5, 300, (ny, nx)).astype(np.int16),
        tpack=rng.integers(-3000, 3000, (nt, ny, nx)).astype(np.int16))
    dims = {"TBOT": ("time", "y", "x"), "PRECIP": ("time", "y", "x"),
            "elev": ("y", "x"), "mask": ("y", "x"), "scount": ("y", "x"),
            "tpack": ("time", "y", "x")}
    with netcdf_file(path, "w") as f:
        f.createDimension("time", None)
        f.createDimension("y", ny)
        f.createDimension("x", nx)
        for name, arr in data.items():
            v = f.createVariable(name, arr.dtype.char, dims[name])
            v[:] = arr
        f.variables["TBOT"].scale_factor = 1.0
        f.variables["TBOT"].add_offset = 0.0
        f.variables["PRECIP"].scale_factor = np.float32(0.5)
        # (a Python float attribute is written as NC_FLOAT)
        f.variables["tpack"].scale_factor = np.float64(0.01)
        f.variables["tpack"].add_offset = np.float64(273.15)
    return path, data


def _jax_reader():
    if not jnative.available():
        pytest.skip("the JAX package's libelmio.so is not built")
    return jnative


def _scipy(path):
    return netcdf_file(str(path), mmap=False)


def test_reader_is_built_under_build_native():
    assert native.available()
    lib = native.library_path()
    assert lib.exists()
    assert lib.parent == (pathlib.Path(native.__file__).resolve().parents[2]
                          / "build" / "native")


def test_shapes_and_full_reads(ncfile):
    path, data = ncfile
    sf = _scipy(path)
    with native.NativeNetCDF(path) as f:
        for name in VARS:
            assert f.shape(name) == data[name].shape, name
            got = f.read(name)
            assert got.dtype == np.float64
            np.testing.assert_array_equal(
                got, np.asarray(sf.variables[name][:], np.float64), name)
            np.testing.assert_array_equal(got, data[name].astype(np.float64))


@pytest.mark.parametrize("name,start,count", [
    ("TBOT", (3, 1, 2), (4, 2, 3)),      # interior records: record stride
    ("TBOT", (8, 0, 0), (1, 4, 6)),      # the last record
    ("PRECIP", (0, 3, 5), (9, 1, 1)),    # one cell through time
    ("tpack", (2, 0, 1), (5, 4, 4)),
    ("elev", (1, 2), (2, 3)),            # a fixed variable
    ("mask", (0, 0), (4, 6)),
    ("scount", (3, 5), (1, 1)),
])
def test_hyperslabs_against_scipy_and_jax(ncfile, name, start, count):
    path, data = ncfile
    sl = tuple(slice(s, s + n) for s, n in zip(start, count))
    want = np.asarray(_scipy(path).variables[name][:][sl], np.float64)
    with native.NativeNetCDF(path) as f:
        got = f.read(name, start=start, count=count)
    assert got.shape == count
    np.testing.assert_array_equal(got, want)
    with _jax_reader().NativeNetCDF(path) as jf:
        np.testing.assert_array_equal(got, jf.read(name, start=start,
                                                   count=count))


def test_attributes_and_types_against_jax(ncfile):
    path, _ = ncfile
    want_types = {"TBOT": 6, "PRECIP": 5, "elev": 5, "mask": 4,
                  "scount": 3, "tpack": 3}
    with native.NativeNetCDF(path) as f, \
            _jax_reader().NativeNetCDF(path) as jf:
        for name in VARS:
            assert f.var_type(name) == want_types[name] == jf.var_type(name)
            for att in ("scale_factor", "add_offset", "nope"):
                assert f.attr(name, att) == jf.attr(name, att), (name, att)
        assert f.attr("TBOT", "scale_factor") == 1.0
        assert f.attr("PRECIP", "scale_factor") == 0.5
        assert f.attr("tpack", "add_offset") == 273.15
        assert f.attr("elev", "scale_factor") is None
        assert f.var_type("missing") < 0


def test_read_var_and_var_packing_match_scipy_and_jax(ncfile):
    """A path reads through the native reader, an open scipy file through
    scipy; scale then offset as the JAX package applies them."""
    path, data = ncfile
    sf = _scipy(path)
    for name in VARS:
        for start, count in ((None, None),
                             ((0,) * data[name].ndim,
                              (1,) + data[name].shape[1:])):
            got = netcdf.read_var(str(path), name, start=start, count=count)
            np.testing.assert_array_equal(
                got, netcdf.read_var(sf, name, start=start, count=count))
            np.testing.assert_array_equal(
                got, jnetcdf.read_var(str(path), name, start=start,
                                      count=count))
        assert netcdf.var_packing(str(path), name) == jnetcdf.var_packing(
            str(path), name), name
    np.testing.assert_array_equal(
        netcdf.read_var(path, "tpack"),
        data["tpack"].astype(np.float64) * 0.01 + 273.15)
    assert netcdf.var_packing(path, "PRECIP") == ("f4", 0.5, 0.0)
    assert netcdf.var_packing(path, "tpack") == ("other", 0.01, 273.15)
    with netcdf.open_native(path) as f:
        assert netcdf.var_packing(f, "TBOT") == ("f8", 1.0, 0.0)


def test_prefetch_takes_the_same_path_string(ncfile, tmp_path):
    path, data = ncfile
    lib = native._load()
    netcdf.prefetch(pathlib.Path(path))
    h = lib.elmio_take_prefetched(str(path).encode())
    assert h >= 0           # loaded under str(path)
    lib.elmio_close(h)
    assert lib.elmio_take_prefetched(str(path).encode()) < 0   # taken once
    # a prefetched open reads what a cold one does
    netcdf.prefetch(path)
    with native.NativeNetCDF(path) as warm:
        got = {n: warm.read(n) for n in VARS}
    with native.NativeNetCDF(path) as cold:
        for n in VARS:
            np.testing.assert_array_equal(got[n], cold.read(n))
    # a different spelling of the path is another key: its open is cold
    alias = f"{path.parent}/./{path.name}"
    netcdf.prefetch(alias)
    assert lib.elmio_take_prefetched(str(path).encode()) < 0
    with native.NativeNetCDF(alias) as f:   # takes the alias's load
        np.testing.assert_array_equal(f.read("TBOT"), data["TBOT"])


def test_missing_variable_and_file(ncfile, tmp_path):
    path, _ = ncfile
    with native.NativeNetCDF(path) as f:
        with pytest.raises(KeyError):
            f.shape("missing")
        with pytest.raises(KeyError):
            f.read("missing")
        with pytest.raises(ValueError, match="outside"):
            f.read("TBOT", start=(8, 0, 0), count=(2, 4, 6))
    with pytest.raises(KeyError):
        netcdf.read_var(path, "missing")
    with pytest.raises(KeyError):
        netcdf.var_packing(path, "missing")
    with pytest.raises(OSError, match="nope.nc"):
        native.NativeNetCDF(tmp_path / "nope.nc")
    # a prefetch of a missing file fails at the open, not before
    netcdf.prefetch(tmp_path / "gone.nc")
    with pytest.raises(OSError):
        netcdf.read_var(tmp_path / "gone.nc", "TBOT")
    bad = tmp_path / "bad.nc"
    bad.write_bytes(b"HDF\x89 not a classic file")
    with pytest.raises(OSError, match="not a NetCDF classic file"):
        native.NativeNetCDF(bad)


def test_closed_once_from_two_threads(ncfile):
    """Closing twice, or from two threads at once, closes the handle once;
    two threads read their own handles."""
    path, data = ncfile
    f = native.NativeNetCDF(path)
    threads = [threading.Thread(target=f.close) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    f.close()
    del f
    with pytest.raises(ValueError, match="closed"):
        g = native.NativeNetCDF(path)
        g.close()
        g.read("TBOT")
    out = [None, None]

    def read(i):
        with native.NativeNetCDF(path) as h:
            out[i] = [h.read("TBOT", start=(k, 0, 0), count=(1, 4, 6))
                      for k in range(9)]
    threads = [threading.Thread(target=read, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for rows in out:
        np.testing.assert_array_equal(np.concatenate(rows), data["TBOT"])


def test_failed_build_raises_without_fallback(ncfile, tmp_path, monkeypatch):
    path, _ = ncfile
    broken = tmp_path / "elmio.cc"
    broken.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed to build") as e:
        netcdf.read_var(path, "TBOT")
    assert "error" in str(e.value)
    with pytest.raises(RuntimeError, match="failed to build"):
        netcdf.prefetch(path)
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").glob("*.so"))


def test_reshape_and_write_grid_cell_matches_jax(tmp_path):
    nt, nlat, nlon = 2, 3, 4
    rng = np.random.default_rng(0)
    cell_vars = {"FSDS": rng.normal(size=(nt, nlat * nlon)),
                 "elev": rng.normal(size=(nlat * nlon,))}
    ours, theirs = str(tmp_path / "t.nc"), str(tmp_path / "j.nc")
    netcdf.reshape_and_write_grid_cell(ours, cell_vars, nlat, nlon)
    jnetcdf.reshape_and_write_grid_cell(theirs, cell_vars, nlat, nlon)
    assert pathlib.Path(ours).read_bytes() == pathlib.Path(theirs).read_bytes()
    back = netcdf.read_var(ours, "FSDS")
    assert back.shape == (nt, nlat, nlon)
    np.testing.assert_array_equal(netcdf.reshape_grid_to_cells(back),
                                  cell_vars["FSDS"])
    np.testing.assert_array_equal(netcdf.read_var(ours, "elev").ravel(),
                                  cell_vars["elev"])


# ---- the forcing from month files, by either reader ---------------------------

class _ScipyFile:
    """scipy's reader behind the native file's interface (test only)."""
    TYPES = {"b": 1, "c": 2, "h": 3, "i": 4, "f": 5, "d": 6}

    def __init__(self, path):
        self.f = netcdf_file(str(path), mmap=False)

    def shape(self, name):
        if name not in self.f.variables:
            raise KeyError(name)
        return tuple(int(n) for n in self.f.variables[name].shape)

    def var_type(self, name):
        v = self.f.variables.get(name)
        return -2 if v is None else self.TYPES[v.typecode()]

    def attr(self, var, att):
        v = getattr(self.f.variables[var], att, None)
        return None if v is None else float(v)

    def read(self, name, start=None, count=None):
        arr = np.asarray(self.f.variables[name][:], np.float64)
        if start is not None:
            arr = arr[tuple(slice(s, s + n) for s, n in zip(start, count))]
        return arr.copy()

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@pytest.fixture(scope="module")
def month_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("months")
    files = tp.write_files(d)
    base = str(d / "forc_")
    # July and August on a 3 x 4 grid: 10 columns from cell 1 span rows
    # partly, and a window late in July bridges into August
    synthetic.write_forcing_months(base, 1985, 7, 2, 3, 4)
    return files, base


def _model(files, base):
    return Model(ncol=10, col0=1, forcing_basename=base, pft_path=files[0],
                 snicar_path=files[1], device="cpu")


def _flat(tree):
    if isinstance(tree, np.ndarray):
        return [tree]
    if isinstance(tree, tuple):
        return [a for v in tree for a in _flat(v)]
    return [np.asarray(tree)] if tree is not None else []


@pytest.mark.parametrize("start", [(1985, 7, 1), (1985, 7, 31)])
def test_forcing_windows_and_run_same_by_either_reader(month_files, start,
                                                       monkeypatch):
    """The host windows of a 12-step ``run_windows(series=True)`` (the
    second start bridges into August) and the run itself are the same bit
    for bit whichever reader assembled the inputs."""
    files, base = month_files
    date = Date.from_ymd(*start)
    by = {}
    for reader in ("native", "scipy"):
        if reader == "scipy":
            monkeypatch.setattr(netcdf, "open_native", _ScipyFile)
        m = _model(files, base)
        payloads = [m._host_series(date, 6)]
        later = date.copy()
        later.increment_seconds(6 * 1800)
        payloads.append(m._host_series(later, 6))
        m.run_windows(date, 12, window=6, series=True)
        by[reader] = ([a for p in payloads for a in _flat(p)], m.state)
    (pa, sa), (pb, sb) = by["native"], by["scipy"]
    assert len(pa) == len(pb)
    for a, b in zip(pa, pb):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for k, a, b in zip(sa._fields, sa, sb):
        assert torch.equal(a, b), k


def test_month_load_takes_the_prefetched_next_month(month_files,
                                                    monkeypatch):
    """Loading July prefetches August; the bridge rows and August's own
    load use that one load (each month file is opened once)."""
    files, base = month_files
    opened, fetched = [], []
    real_open = netcdf.open_native
    real_prefetch = netcdf.prefetch
    monkeypatch.setattr(netcdf, "open_native",
                        lambda p: opened.append(str(p)) or real_open(p))
    monkeypatch.setattr(netcdf, "prefetch",
                        lambda p: fetched.append(str(p)) or real_prefetch(p))
    m = _model(files, base)
    m.forcing.series(Date.from_ymd(1985, 7, 31, 12 * 3600), 48, 1800.0)
    jul, aug = f"{base}1985-07.nc", f"{base}1985-08.nc"
    assert fetched == [aug]
    assert opened == [jul, aug]
