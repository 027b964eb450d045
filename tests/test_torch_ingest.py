"""The port's host ingest against the JAX package's numpy host providers,
on the same files: the forcing windows and series (synthetic and NetCDF,
within a month, across a month boundary, with RH humidity, on a column
shard), the phenology and aerosol-deposition managers, the surfdata and
soil readers, the per-column PFT trait gathers, and the port's own
writers of the global grid and its forcing against the JAX ``tools/``
writers (and of the deposition file against the JAX tests' one).  All bit
for bit (rtol 0), dtypes included."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity as tp
from elmkernels_torch.data import aerosol_data as t_aero
from elmkernels_torch.data import forcing as t_forcing
from elmkernels_torch.data import netcdf as t_nc
from elmkernels_torch.data import params as t_params
from elmkernels_torch.data import phenology_data as t_phen
from elmkernels_torch.data import soil_data as t_soil
from elmkernels_torch.data import surfdata as t_surf
from elmkernels_torch.data import synthetic
from elmkernels_torch.utils.dates import Date as TDate
from elmkernels_tpu.data import aerosol_data as j_aero
from elmkernels_tpu.data import forcing as j_forcing
from elmkernels_tpu.data import netcdf_io as j_nc
from elmkernels_tpu.data import params as j_params
from elmkernels_tpu.data import phenology_data as j_phen
from elmkernels_tpu.data import soil_data as j_soil
from elmkernels_tpu.data import surfdata as j_surf
from elmkernels_tpu.utils.dates import Date as JDate

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import make_forcing_files  # noqa: E402
import make_global_surfdata  # noqa: E402

torch.set_num_threads(1)

NLAT, NLON = 8, 16
NCELL = NLAT * NLON
DT = 1800.0


def _equal(a, b, what=""):
    """Bit-for-bit equality of two numpy arrays (or numbers), dtype
    included."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _equal_tuples(j, t, what=""):
    assert tuple(j._fields) == tuple(t._fields)
    for k in j._fields:
        if getattr(j, k) is None:
            assert getattr(t, k) is None, (what, k)
            continue
        _equal(getattr(j, k), getattr(t, k), f"{what}.{k}")


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """Port-written inputs: the NCELL-cell global surfdata, June to August
    forcing (QBOT) and a July-August RH variant, phenology and aerosol."""
    d = tmp_path_factory.mktemp("torch_ingest")
    files = dict(surfdata=d / "surfdata.nc", phenology=d / "phen.nc",
                 aerosol=d / "aero.nc", forcing=str(d / "forc_"),
                 forcing_rh=str(d / "forc_rh_"))
    synthetic.write_global_surfdata(files["surfdata"], NCELL)
    synthetic.write_phenology(files["phenology"], NCELL)
    synthetic.write_aerosol_deposition(files["aerosol"], NCELL)
    synthetic.write_forcing_months(files["forcing"], 1985, 6, 3, NLAT, NLON)
    for month in (7, 8):
        f = synthetic.forcing_month_fields(1985, month, NLAT, NLON)
        rh = 100.0 * f["QBOT"] / f["QBOT"].max()
        variables = {"DTIME": (("DTIME",), f["DTIME"])}
        for k in synthetic.FORCING_VARS:
            arr = rh if k == "QBOT" else f[k]
            variables["RH" if k == "QBOT" else k] = (
                ("DTIME", "lat", "lon"), arr.astype(np.float32))
        t_nc.write_nc(f"{files['forcing_rh']}1985-{month:02d}.nc",
                      {"DTIME": None, "lat": NLAT, "lon": NLON}, variables)
    files["pft"], _ = tp.write_files(d)
    return files


def _dates(month, day, hour):
    return (JDate.from_ymd(1985, month, day, hour * 3600),
            TDate.from_ymd(1985, month, day, hour * 3600))


# (forcing files, start month, day, hour, steps, ncol, col0)
NETCDF_CASES = {
    "in_month": ("forcing", 7, 10, 6, 48, NCELL, 0),
    "month_boundary": ("forcing", 7, 31, 21, 24, NCELL, 0),
    "col0_shard": ("forcing", 7, 31, 12, 20, 37, 45),
    "rh_humidity": ("forcing_rh", 7, 31, 18, 16, 24, 100),
}


def _netcdf_pair(grid, case):
    base, month, day, hour, nsteps, ncol, col0 = NETCDF_CASES[case]
    lat = np.linspace(-1.0, 1.0, ncol)
    lon = np.linspace(0.0, 6.0, ncol)
    jf = j_forcing.NetCDFForcing(grid[base], ncol, lat, lon, col0=col0)
    tf = t_forcing.NetCDFForcing(grid[base], ncol, lat, lon, col0=col0)
    return jf, tf, _dates(month, day, hour), nsteps


@pytest.mark.parametrize("case", list(NETCDF_CASES))
def test_netcdf_window_matches_jax(grid, case):
    jf, tf, (jd, td), nsteps = _netcdf_pair(grid, case)
    assert tf.qbot_is_rh == jf.qbot_is_rh == (case == "rh_humidity")
    assert tf.dt_forcing == jf.dt_forcing == 10800.0
    for k in range(nsteps):
        _equal_tuples(jf.window(jd, DT), tf.window(td, DT),
                      f"{case} step {k}")
        jd.increment_seconds(int(DT))
        td.increment_seconds(int(DT))


@pytest.mark.parametrize("case", list(NETCDF_CASES))
def test_netcdf_series_matches_jax(grid, case):
    """The series payload, shipped at the files' float32, and its bracket
    rows equal the port's own windows once promoted."""
    jf, tf, (jd, td), nsteps = _netcdf_pair(grid, case)
    jser, jsteps = jf.series(jd, nsteps, DT)
    tser, tsteps = tf.series(td, nsteps, DT)
    _equal_tuples(jser, tser, case)
    _equal_tuples(jsteps, tsteps, case)
    assert tser.tbot.dtype == np.float32
    for k in range(nsteps):
        w = tf.window(td, DT)
        i = int(tsteps.idx1[k])
        _equal(tser.qbot[i:i + 2].astype(np.float64), w.qbot)
        _equal(tser.fsds[i].astype(np.float64), w.fsds)
        assert tsteps.wt1[k] == w.wt1 and tsteps.decday[k] == w.decday
        td.increment_seconds(int(DT))


def test_synthetic_series_and_window_match_jax():
    ncol = 5
    lat, lon = np.linspace(-1.0, 1.2, ncol), np.linspace(0.0, 6.0, ncol)
    jf = j_forcing.SyntheticForcing(ncol, lat, lon)
    tf = t_forcing.SyntheticForcing(ncol, lat, lon)
    jd, td = _dates(7, 31, 20)
    _equal_tuples(*(f.series(d, 48, DT)[0] for f, d in ((jf, jd),
                                                         (tf, td))))
    _equal_tuples(jf.series(jd, 48, DT)[1], tf.series(td, 48, DT)[1])
    for _ in range(6):
        _equal_tuples(jf.window(jd, DT), tf.window(td, DT))
        jd.increment_seconds(int(DT))
        td.increment_seconds(int(DT))


def test_phenology_window_matches_jax(grid):
    """Each cell's own PFT slice, over a mid-month rollover that rotates
    the ring buffer, on a mixed-PFT shard."""
    ncol, col0 = 40, 30
    vtype = synthetic.global_grid_fields(NCELL)["PCT_NAT_PFT"].argmax(0)
    vtype = vtype[col0:col0 + ncol].astype(np.int32)
    assert len(set(vtype.tolist())) > 2
    jm = j_phen.PhenologyDataManager(str(grid["phenology"]), ncol, vtype,
                                     col0=col0)
    tm = t_phen.PhenologyDataManager(str(grid["phenology"]), ncol, vtype,
                                     col0=col0)
    jd, td = _dates(7, 16, 10)
    for _ in range(8):
        _equal_tuples(jm.window(jd), tm.window(td))
        jd.increment_seconds(int(DT))
        td.increment_seconds(int(DT))
    assert tm.months == jm.months


def test_aerosol_rates_and_bracket_match_jax(grid):
    ncol, col0 = 24, 60
    ja = j_aero.AerosolDataManager(str(grid["aerosol"]), ncol, col0=col0)
    ta = t_aero.AerosolDataManager(str(grid["aerosol"]), ncol, col0=col0)
    assert list(t_aero.DEP_VARS) == list(j_aero.DEP_VARS)
    for month, day in ((1, 3), (7, 16), (12, 30)):
        jd, td = _dates(month, day, 12)
        jr, tr = ja.rates(jd), ta.rates(td)
        assert list(jr) == list(tr)
        for k in jr:
            _equal(jr[k], tr[k], k)
        _equal(ja.bracket(jd), ta.bracket(td))
    jd, td = _dates(3, 1, 0)
    _equal(j_aero.SteadyAerosol(ncol).bracket(jd),
           t_aero.SteadyAerosol(ncol).bracket(td))


def test_read_surfdata_matches_jax(grid):
    for ncol, col0 in ((NCELL, 0), (37, 45)):
        j = j_surf.read_surfdata(str(grid["surfdata"]), ncol, col0)
        t = t_surf.read_surfdata(str(grid["surfdata"]), ncol, col0)
        assert j.mxsoil_color == t.mxsoil_color == 20
        for k in j._fields:
            if k != "mxsoil_color":
                _equal(getattr(j, k), getattr(t, k), k)
    assert len(set(t.vtype.tolist()) & {12, 14}) >= 1


def test_read_soil_matches_jax(grid):
    path = str(grid["surfdata"])
    for jv, tv in zip(j_soil.read_soil_colors(path, 30, 7),
                      t_soil.read_soil_colors(path, 30, 7)):
        _equal(jv, tv)
    for jv, tv in zip(j_soil.read_soil_texture(path, 30, 7),
                      t_soil.read_soil_texture(path, 30, 7)):
        _equal(jv, tv)
    assert (j_soil.read_organic_max(grid["pft"])
            == t_soil.read_organic_max(grid["pft"]))
    for mx in (8, 20):
        _equal(j_soil.get_albsat(mx), t_soil.get_albsat(mx))
        _equal(j_soil.get_albdry(mx), t_soil.get_albdry(mx))


def test_gather_pft_traits_match_jax(grid):
    """Per-column photosynthesis and albedo traits on a mixed C3/C4 vtype;
    both packages see the batch as "mixed"."""
    from elmkernels_torch.physics.photosynthesis import \
        psn_mode_of as t_mode
    from elmkernels_tpu.physics.photosynthesis import psn_mode_of as j_mode
    vtype = np.array([12, 14, 4, 14, 1, 23, 0, 9], np.int32)
    jt = j_params.load_pft_table(grid["pft"])
    tt = t_params.load_pft_table(grid["pft"])
    jp, tpsn = j_params.gather_pft_psn(jt, vtype), \
        t_params.gather_pft_psn(tt, vtype)
    ja, talb = j_params.gather_pft_alb(jt, vtype), \
        t_params.gather_pft_alb(tt, vtype)
    for j, t in ((jp, tpsn), (ja, talb)):
        for k in j._fields:
            _equal(np.asarray(getattr(j, k)),
                   getattr(t, k).numpy(), k)
    assert t_mode(tpsn) == j_mode(jp) == "mixed"


def test_read_var_hyperslab_matches_jax(grid):
    path = f"{grid['forcing']}1985-07.nc"
    for start, count in ((None, None), ([3, 1, 2], [5, 4, 9])):
        _equal(j_nc.read_var(path, "TBOT", start=start, count=count),
               t_nc.read_var(path, "TBOT", start=start, count=count))
    assert (t_nc.var_packing(path, "TBOT") == j_nc.var_packing(path, "TBOT")
            == ("f4", 1.0, 0.0))
    assert (t_nc.get_var_dimnames(path, "WIND")
            == j_nc.get_var_dimnames(path, "WIND"))
    assert (t_nc.get_dimensions(path, "WIND")
            == j_nc.get_dimensions(path, "WIND"))


def test_global_surfdata_writer_matches_tools(tmp_path):
    """The port's writer and ``tools/make_global_surfdata.py`` give the
    same file contents."""
    jpath, tpath = tmp_path / "j.nc", tmp_path / "t.nc"
    make_global_surfdata.write_surfdata(str(jpath), 1000)
    synthetic.write_global_surfdata(tpath, 1000)
    jf, tf = t_nc.open_nc(jpath), t_nc.open_nc(tpath)
    assert set(jf.variables) == set(tf.variables)
    for k in jf.variables:
        assert jf.variables[k].dimensions == tf.variables[k].dimensions
        _equal(jf.variables[k][:], tf.variables[k][:], k)


def test_forcing_writer_matches_tools(tmp_path):
    jbase, tbase = str(tmp_path / "j_"), str(tmp_path / "t_")
    make_forcing_files.write_months(jbase, 1985, 12, 2, 3, 5)
    paths = synthetic.write_forcing_months(tbase, 1985, 12, 2, 3, 5)
    assert [Path(p).name for p in paths] == ["t_1985-12.nc", "t_1986-01.nc"]
    for name in ("1985-12.nc", "1986-01.nc"):
        jf, tf = t_nc.open_nc(jbase + name), t_nc.open_nc(tbase + name)
        assert set(jf.variables) == set(tf.variables)
        for k in jf.variables:
            assert jf.variables[k].dimensions == tf.variables[k].dimensions
            _equal(jf.variables[k][:], tf.variables[k][:], k)


def test_aerosol_writer_matches_the_jax_tests_file(tmp_path):
    """The port's deposition writer and the JAX package's test file
    (``tests/test_aerosol_data.py``) give the same file contents."""
    import test_aerosol_data
    jpath, tpath = tmp_path / "j.nc", tmp_path / "t.nc"
    test_aerosol_data._write_dep_file(jpath, ncell=9)
    synthetic.write_aerosol_deposition(tpath, 9)
    jf, tf = t_nc.open_nc(jpath), t_nc.open_nc(tpath)
    assert list(jf.variables) == list(tf.variables)
    for k in jf.variables:
        assert jf.variables[k].dimensions == tf.variables[k].dimensions
        _equal(jf.variables[k][:], tf.variables[k][:], k)


def test_bridge_row_ships_at_its_source_precision(tmp_path):
    """July stored as NC_FLOAT, August as NC_DOUBLE.  A series that ends in
    July keeps August's first row as the bridge to its last interval; that
    row is NC_DOUBLE on disk, so the series ships every variable in
    float64 and equals the series shipped with ``ship_source_dtype=False``
    exactly.  The JAX package decides from July's file alone, demotes the
    bridge row to float32, and differs there."""
    base = str(tmp_path / "bridge_")
    synthetic.write_forcing_months(base, 1985, 7, 1, 3, 4)
    synthetic.write_forcing_months(base, 1985, 8, 1, 3, 4, dtype=np.float64)
    ncol = 12
    grid = dict(lat_r=np.zeros(ncol), lon_r=np.zeros(ncol))
    # 20:00-23:00 on 31 July: the last steps bracket July's 21:00 row and
    # August's 00:00 row
    start = (1985, 7, 31, 20 * 3600)
    ship = t_forcing.NetCDFForcing(base, ncol, **grid)
    ser, steps = ship.series(TDate.from_ymd(*start), 6, 1800.0)
    plain = t_forcing.NetCDFForcing(base, ncol, ship_source_dtype=False,
                                    **grid)
    ser64, steps64 = plain.series(TDate.from_ymd(*start), 6, 1800.0)
    assert int(steps.idx1.max()) + 2 == ser64.tbot.shape[0]  # the bridge
    for k in ser64._fields:
        got, want = getattr(ser, k), getattr(ser64, k)
        assert got.dtype == want.dtype == np.float64, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    for a, b in zip(steps, steps64):
        np.testing.assert_array_equal(a, b)
    jser, _ = j_forcing.NetCDFForcing(base, ncol, **grid).series(
        JDate.from_ymd(*start), 6, 1800.0)
    assert any(not np.array_equal(np.asarray(getattr(jser, k), np.float64),
                                  getattr(ser64, k))
               for k in ser64._fields)
