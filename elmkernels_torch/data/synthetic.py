"""Synthetic input files: a ``clm_params``-style PFT trait NetCDF, a
SNICAR optics NetCDF, and a heterogeneous global grid with its
month-per-file forcing, phenology and aerosol-deposition NetCDFs, written
from closed-form, physically plausible values so that a model can be
built without the reference's data files.

Imports numpy and scipy only.  Both the JAX package's ``Model`` and the
port's read these files through their own readers.

- :func:`write_clm_params` writes every trait of ``PFT_TABLE_NAMES``
  (``elmkernels_tpu/data/params.py:38-52``) over 25 PFTs plus the scalars
  ``tc_stress`` and ``organic_max``.  PFT 12 (C3 arctic grass, the
  reference driver's site) carries C3 grass values of the CLM5 parameter
  file's magnitude, so the canopy and ci loops converge as they do on
  real data; PFT 14 is a C4 grass.
- :func:`write_snicar_optics` writes the 5-band SNICAR schema that
  ``elmkernels_tpu/data/snicar_data.py:78`` reads: Mie tables
  ``[5, 1471]`` over snow radius 30..1500 um, BC/OC/dust tables and
  ``bcint_enh_mam [8, 10, 5]``.
- :func:`write_global_surfdata`, :func:`write_forcing_months`,
  :func:`write_phenology` and :func:`write_aerosol_deposition` write the
  inputs of ``Model.from_surfdata`` with ``forcing_basename``,
  ``phenology_path`` and ``aerosol_path``: a land-weighted global grid
  whose latitude-zoned PFT mix keeps every batch mixed C3/C4, analytic
  3-hourly forcing in float32 on a (lat, lon) grid, a seasonal phenology
  per PFT and a monthly deposition climatology.  The grid and forcing
  arithmetic is that of the JAX package's ``tools/make_global_surfdata.py``
  and ``tools/make_forcing_files.py``.
- :func:`write_snow_aging_tables` writes a ``snicar_drdt_bst`` NetCDF, the
  [11, 31, 8] aging tables ``tau``/``kappa``/``drdsdt0`` over (T, dT/dz,
  rho) bins, with which grains grow by microns an hour, as in ELM.
- :func:`landunit_map` gives a global grid's columns their landunit types
  (soil, crop, wetland and ice sheet, from the latitudes and a seed), and
  :func:`landunit_vtypes` leaves ice and wetland columns unvegetated.
- :func:`parameter_files` and :func:`global_surfdata` give the entry
  points (``elmkernels_torch.bench``, ``examples.run_single_column``,
  ``tools.long_run``) their files under ``build/`` in the checkout,
  written once.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

from elmkernels_torch import constants as c
from elmkernels_torch.data.netcdf import write_nc
from elmkernels_torch.utils.dates import DAYS_PER_MONTH, Date

NUMPFT = 25
NBND = 5
NMIE = 1471

# C3 grass traits (CLM5 magnitudes); every PFT starts from these
_C3_GRASS = dict(
    fnr=7.16, act25=3.6, kcha=79430.0, koha=36380.0, cpha=37830.0,
    vcmaxha=72000.0, jmaxha=50000.0, tpuha=72000.0, lmrha=46390.0,
    vcmaxhd=200000.0, jmaxhd=200000.0, tpuhd=200000.0, lmrhd=150650.0,
    lmrse=490.0, qe=0.0, theta_cj=0.98, bbbopt=10000.0, mbbopt=9.0,
    c3psn=1.0, slatop=0.04, leafcn=25.0, flnr=0.09, fnitr=0.83,
    dleaf=0.04, smpso=-74000.0, smpsc=-275000.0,
    rholvis=0.11, rholnir=0.35, rhosvis=0.31, rhosnir=0.53,
    taulvis=0.05, taulnir=0.34, tausvis=0.12, tausnir=0.25, xl=-0.3,
    roota_par=11.0, rootb_par=2.0, displar=0.67, z0mr=0.12,
    dsladlai=0.0, leaf_long=1.0, evergreen=0.0, stress_decid=1.0,
    season_decid=0.0)
# C4 grass (PFT 14) differs in pathway traits
_C4_GRASS = dict(_C3_GRASS, c3psn=0.0, qe=0.05, theta_cj=0.8,
                 bbbopt=40000.0, mbbopt=4.0, slatop=0.05)


def pft_table() -> dict:
    """The synthetic trait table: name -> [NUMPFT] float64."""
    table = {k: np.full(NUMPFT, v) for k, v in _C3_GRASS.items()}
    # trees and shrubs (1..11): taller roughness, deeper roots, leaf angle
    for pft in range(1, 12):
        table["z0mr"][pft] = 0.055
        table["roota_par"][pft] = 7.0
        table["xl"][pft] = 0.1
        table["slatop"][pft] = 0.012
        table["leafcn"][pft] = 40.0
    for k, v in _C4_GRASS.items():
        table[k][14] = v
    return table


def write_clm_params(path, tc_stress: float = -2.0,
                     organic_max: float = 130.0) -> None:
    """Write the synthetic ``clm_params`` NetCDF to ``path``."""
    table = pft_table()
    variables = {k: (("pft",), v) for k, v in table.items()}
    variables["tc_stress"] = (("allpfts",), np.array([tc_stress]))
    variables["organic_max"] = (("allpfts",), np.array([organic_max]))
    write_nc(path, {"pft": NUMPFT, "allpfts": 1}, variables)


def snicar_tables() -> dict:
    """The synthetic SNICAR optics, keyed by the reference's file
    variable names."""
    rds = 30.0 + np.arange(NMIE)               # effective radius [um]
    # ice co-albedo grows with radius, strongly in the near-IR bands
    coalb_per_um = np.array([2.0e-8, 2.0e-6, 1.0e-5, 4.0e-5, 2.5e-4])
    ss_alb = np.clip(1.0 - coalb_per_um[:, None] * rds[None, :], 0.5, None)
    asm = 0.88 + 0.01 * np.log(rds[None, :] / 30.0) \
        + 0.002 * np.arange(NBND)[:, None]
    ext = 3.0 / (2.0 * 917.0 * rds[None, :] * 1.0e-6) \
        * (1.0 + 0.01 * np.arange(NBND)[:, None])
    out = {}
    for kind, scale in (("drc", 1.0), ("dfs", 0.999)):
        out[f"ss_alb_ice_{kind}"] = np.clip(ss_alb * scale, 0.5, 1.0)
        out[f"asm_prm_ice_{kind}"] = asm
        out[f"ext_cff_mss_ice_{kind}"] = ext
    band = np.arange(NBND)
    aer = {"ocphil": (0.95, 0.7, 6000.0), "ocphob": (0.93, 0.68, 5000.0),
           "dust01": (0.95, 0.75, 2500.0), "dust02": (0.92, 0.78, 1300.0),
           "dust03": (0.88, 0.8, 650.0), "dust04": (0.84, 0.85, 250.0)}
    for name, (ssa, g, k) in aer.items():
        out[f"ss_alb_{name}"] = ssa - 0.02 * band
        out[f"asm_prm_{name}"] = g - 0.01 * band
        out[f"ext_cff_mss_{name}"] = k / (1.0 + 0.5 * band)
    nclrds = np.arange(10)[:, None]
    out["ss_alb_bc_mam"] = 0.25 + 0.01 * nclrds - 0.02 * band[None, :]
    out["asm_prm_bc_mam"] = 0.35 + 0.01 * nclrds - 0.03 * band[None, :]
    out["ext_cff_mss_bc_mam"] = (11000.0 - 300.0 * nclrds) \
        / (1.0 + 0.6 * band[None, :])
    out["bcint_enh_mam"] = (1.9 - 0.05 * np.arange(8)[:, None, None]
                            - 0.02 * np.arange(10)[None, :, None]
                            - 0.1 * band[None, None, :])
    return out


def write_snicar_optics(path) -> None:
    """Write the synthetic SNICAR optics NetCDF to ``path``."""
    def dims_of(arr):
        if arr.ndim == 1:
            return ("band",)
        if arr.ndim == 3:
            return ("icerds", "nclrds", "band")
        return ("band", "mie") if arr.shape[1] == NMIE else ("nclrds",
                                                             "band")
    write_nc(path, {"band": NBND, "mie": NMIE, "nclrds": 10, "icerds": 8},
             {name: (dims_of(arr), np.asarray(arr, np.float64))
              for name, arr in snicar_tables().items()})


# ---------------------------------------------------------------------------
# a heterogeneous global grid and its month-per-file inputs
# ---------------------------------------------------------------------------

# approximate fraction of Earth's land area by latitude band
LAND_BANDS = ((-55.0, -30.0, 0.06), (-30.0, -10.0, 0.11),
              (-10.0, 10.0, 0.15), (10.0, 30.0, 0.21),
              (30.0, 50.0, 0.21), (50.0, 70.0, 0.21),
              (70.0, 84.0, 0.05))

# latitude-zoned dominant PFTs, two alternating per zone, so that every
# batch of columns mixes C3 and C4 (PFT 14, the C4 grass)
PFT_ZONES = ((-90.0, -30.0, (c.NBRDLF_EVR_TMP_TREE, c.NC3_NONARCTIC_GRASS)),
             (-30.0, -10.0, (c.NC4_GRASS, c.NBRDLF_DCD_TRP_TREE)),
             (-10.0, 10.0, (c.NBRDLF_EVR_TRP_TREE, c.NC4_GRASS)),
             (10.0, 30.0, (c.NC4_GRASS, c.NBRDLF_EVR_SHRUB)),
             (30.0, 50.0, (c.NBRDLF_DCD_TMP_TREE, c.NSOYBEAN)),
             (50.0, 70.0, (c.NDLLF_EVR_BRL_TREE, c.NDLLF_DCD_BRL_TREE)),
             (70.0, 90.0, (c.NC3_ARCTIC_GRASS, c.NC3_ARCTIC_GRASS)))


def land_latitudes(ncell: int) -> np.ndarray:
    """Land-area-weighted cell latitudes, south to north."""
    counts = [int(round(w * ncell)) for _, _, w in LAND_BANDS]
    counts[-1] += ncell - sum(counts)
    return np.concatenate([np.linspace(lo, hi, n, endpoint=False)
                           for (lo, hi, _), n in zip(LAND_BANDS, counts)])


def global_grid_fields(ncell: int) -> dict:
    """The global surfdata's per-cell fields: land-weighted latitudes,
    longitudes, the 20 soil colors, texture and organic gradients, the
    zoned PFT mix (80 % dominant, 20 % subdominant) and topography."""
    i = np.arange(ncell)
    lat = land_latitudes(ncell)
    lon = (i * 360.0 / 1024.0) % 360.0
    npft = c.MXPFT
    vtype = np.zeros(ncell, np.int64)
    for lo, hi, pfts in PFT_ZONES:
        zone = (lat >= lo) & (lat < hi)
        vtype[zone] = np.where((i[zone] % 2) == 0, pfts[0], pfts[1])
    pct_pft = np.zeros((npft, ncell), np.float32)
    pct_pft[vtype, i] = 80.0
    pct_pft[(vtype + 1) % npft, i] = 20.0
    lev = np.arange(c.NLEVSOI, dtype=np.float64)[:, None]
    sand = 20.0 + (i % 7) * 8.0 + 2.0 * lev
    clay = 10.0 + (i % 5) * 6.0 + 1.5 * lev
    organic = np.maximum(0.0, (2.0 + (i % 11) * 8.0) * (1.0 - 0.12 * lev))
    return {
        "LATIXY": lat, "LONGXY": lon,
        "SOIL_COLOR": ((i % 20) + 1).astype(np.int32),
        "PCT_NAT_PFT": pct_pft,
        "PCT_SAND": sand.astype(np.float32),
        "PCT_CLAY": clay.astype(np.float32),
        "ORGANIC": organic.astype(np.float32),
        "SLOPE": 0.01 + 0.3 * (i % 97) / 97.0,
        "STD_ELEV": 1.0 + 80.0 * (i % 89) / 89.0,
    }


def write_global_surfdata(path, ncell: int) -> None:
    """Write the ``ncell``-cell global surfdata NetCDF that
    ``Model.from_surfdata`` reads."""
    f = global_grid_fields(ncell)
    lev = ("nlevsoi", "gridcell")
    write_nc(path, {"gridcell": ncell, "nlevsoi": c.NLEVSOI,
                    "natpft": c.MXPFT, "scalar": 1}, {
        "LATIXY": (("gridcell",), f["LATIXY"]),
        "LONGXY": (("gridcell",), f["LONGXY"]),
        "SOIL_COLOR": (("gridcell",), f["SOIL_COLOR"]),
        "mxsoil_color": (("scalar",), np.array([20], np.int32)),
        "PCT_NAT_PFT": (("natpft", "gridcell"), f["PCT_NAT_PFT"]),
        "PCT_SAND": (lev, f["PCT_SAND"]),
        "PCT_CLAY": (lev, f["PCT_CLAY"]),
        "ORGANIC": (lev, f["ORGANIC"]),
        "SLOPE": (("gridcell",), f["SLOPE"]),
        "STD_ELEV": (("gridcell",), f["STD_ELEV"])})


def forcing_month_fields(year: int, month: int, nlat: int, nlon: int,
                         dt_hours: float = 3.0) -> dict:
    """Analytic forcing of one month, (nt, nlat, nlon) each: seasonal and
    diurnal cycles with per-cell phase offsets.  Global time enters
    through the month's first day of year, so months join continuously."""
    ndays = DAYS_PER_MONTH[month - 1]
    nt = int(round(ndays * 24.0 / dt_hours))
    dtime = np.arange(nt, dtype=np.float64) * (dt_hours / 24.0)
    doy = Date.from_ymd(year, month, 1).doy + dtime[:, None, None]
    hour = (doy * 24.0) % 24.0
    cell = np.arange(nlat * nlon, dtype=np.float64).reshape(1, nlat, nlon)
    phase = 2.0 * np.pi * cell / max(1.0, nlat * nlon)
    seasonal = -12.0 * np.cos(2.0 * np.pi * doy / 365.0 + 0.3 * phase)
    diurnal = 6.0 * np.sin(2.0 * np.pi * (hour - 9.0) / 24.0)
    sun = np.maximum(0.0, np.sin(np.pi * (hour - 6.0) / 12.0))
    wet = (np.floor(doy * 3.0 + cell) % 7.0) < 2.0
    return {
        "DTIME": dtime,
        "TBOT": 278.0 + seasonal + diurnal,
        "PBOT": 98000.0 + 500.0 * np.sin(2.0 * np.pi * doy / 29.0 + phase),
        "QBOT": np.maximum(1.0e-4, 0.004 + 0.003 * np.sin(
            2.0 * np.pi * doy / 365.0 + 0.1 * phase)),
        "FLDS": 220.0 + 60.0 * np.cos(2.0 * np.pi * (doy - 200.0) / 365.0
                                      + 0.2 * phase),
        "FSDS": 600.0 * sun * (0.6 + 0.4 * np.sin(2.0 * np.pi * doy
                                                  / 365.0)),
        "PRECTmms": np.where(wet, 2.5e-5, 0.0),
        "WIND": 3.0 + 2.0 * np.sin(2.0 * np.pi * doy / 13.0 + phase)}


FORCING_VARS = ("TBOT", "PBOT", "QBOT", "FLDS", "FSDS", "PRECTmms", "WIND")


def write_forcing_months(basename: str, year: int, month: int,
                         nmonths: int, nlat: int, nlon: int,
                         dt_hours: float = 3.0,
                         dtype=np.float32) -> list[str]:
    """Write ``nmonths`` month files ``<basename>YYYY-MM.nc`` from
    (year, month) on: DTIME in days since the month's start and the seven
    forcing variables on (DTIME, lat, lon) in ``dtype`` (float32 by
    default, the usual forcing file precision).  Returns the paths."""
    paths = []
    y, m = year, month
    for _ in range(nmonths):
        f = forcing_month_fields(y, m, nlat, nlon, dt_hours)
        path = f"{basename}{y:04d}-{m:02d}.nc"
        variables = {"DTIME": (("DTIME",), f["DTIME"])}
        for k in FORCING_VARS:
            variables[k] = (("DTIME", "lat", "lon"), f[k].astype(dtype))
        write_nc(path, {"DTIME": None, "lat": nlat, "lon": nlon}, variables)
        paths.append(path)
        y, m = (y, m + 1) if m < 12 else (y + 1, 1)
    return paths


def write_aerosol_deposition(path, ncell: int) -> None:
    """A monthly deposition climatology (12, gridcell) of the eleven
    species of ``AerosolDataManager``: species i in month m and cell j
    deposits (i + 1) 1e-12 (1 + m) + 1e-14 j kg/m2/s."""
    from elmkernels_torch.data.aerosol_data import DEP_VARS
    months = np.arange(12, dtype=np.float64)[:, None]
    cell = np.arange(ncell, dtype=np.float64)[None, :]
    write_nc(path, {"time": 12, "gridcell": ncell}, {
        vname: (("time", "gridcell"),
                (i + 1) * 1e-12 * (1.0 + months) + 1e-14 * cell)
        for i, vname in enumerate(DEP_VARS.values())})


def write_phenology(path, ncell: int) -> None:
    """A monthly phenology file, MONTHLY_LAI/SAI/HEIGHT_TOP/HEIGHT_BOT over
    (12, pft, gridcell) in float32, for the cells of the global grid of
    ``ncell`` cells: leaf area peaks in July north of the equator and in
    January south of it; trees (PFTs 1-8) are tall, shrubs (9-11) short,
    grasses and crops low; bare ground (PFT 0) has none."""
    lat = land_latitudes(ncell)
    m = np.arange(12, dtype=np.float64)[:, None, None]
    peak = np.where(lat >= 0.0, 6.0, 0.0)[None, None, :]
    green = 0.5 * (1.0 + np.cos(2.0 * np.pi * (m - peak) / 12.0))
    pft = np.arange(c.MXPFT)
    tree = ((pft >= 1) & (pft <= 8))[None, :, None]
    shrub = ((pft >= 9) & (pft <= 11))[None, :, None]
    veg = (pft != c.NOVEG)[None, :, None]
    lai = np.where(tree, 2.0 + 3.0 * green, 0.5 + 2.5 * green)
    sai = np.where(tree, 0.8 + 0.4 * green, 0.2 + 0.3 * green)
    htop = np.where(tree, 17.0, np.where(shrub, 1.5, 0.5)) + 0.0 * green
    hbot = np.where(tree, 8.5, np.where(shrub, 0.1, 0.01)) + 0.0 * green
    dims = ("time", "natpft", "gridcell")
    write_nc(path, {"time": 12, "natpft": c.MXPFT, "gridcell": ncell}, {
        name: (dims, np.where(veg, v, 0.0).astype(np.float32))
        for name, v in (("MONTHLY_LAI", lai), ("MONTHLY_SAI", sai),
                        ("MONTHLY_HEIGHT_TOP", htop),
                        ("MONTHLY_HEIGHT_BOT", hbot))})


def write_global_inputs(directory, ncell: int, forcing_grid=None,
                        year: int = 1985, month: int = 7,
                        nmonths: int = 2) -> dict:
    """Write the ``ncell``-cell global surfdata, its phenology and aerosol
    deposition files into ``directory``, and with ``forcing_grid`` =
    (nlat, nlon), nlat * nlon >= ncell, ``nmonths`` forcing month files
    from (year, month) on.  Returns ``surfdata`` (the path) and the
    ``Model.from_surfdata`` keywords of the files."""
    import pathlib
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    out = dict(surfdata=str(d / f"surfdata_{ncell}.nc"),
               phenology_path=str(d / f"phenology_{ncell}.nc"),
               aerosol_path=str(d / f"aerosoldep_{ncell}.nc"))
    write_global_surfdata(out["surfdata"], ncell)
    write_phenology(out["phenology_path"], ncell)
    write_aerosol_deposition(out["aerosol_path"], ncell)
    if forcing_grid is not None:
        nlat, nlon = forcing_grid
        if nlat * nlon < ncell:
            raise ValueError(f"forcing grid {nlat}x{nlon} < {ncell} cells")
        out["forcing_basename"] = str(d / f"forcing_{nlat}x{nlon}_")
        write_forcing_months(out["forcing_basename"], year, month, nmonths,
                             nlat, nlon)
    return out


# where the entry points keep the files they write: build/ at the root of
# the checkout (listed in .gitignore)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"


def _ensure(path: pathlib.Path, write) -> str:
    """``path``, written by ``write(file)`` first if it is missing; the
    file appears whole (written aside, then renamed)."""
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        write(tmp)
        os.replace(tmp, path)
    return str(path)


def parameter_files(directory=None) -> tuple[str, str]:
    """(pft_path, snicar_path): the synthetic ``clm_params.nc`` and
    ``snicar_optics.nc`` in ``directory`` (default ``build/synthetic``,
    where ``chip_smoke.py`` writes them), written if missing."""
    d = pathlib.Path(directory) if directory else BUILD_DIR / "synthetic"
    return (_ensure(d / "clm_params.nc", write_clm_params),
            _ensure(d / "snicar_optics.nc", write_snicar_optics))


def global_surfdata(ncell: int, directory=None) -> str:
    """The ``ncell``-cell global surfdata in ``directory`` (default
    ``build/global``), written if missing: the JAX package's
    ``tools/make_global_surfdata.py:ensure_surfdata``."""
    d = pathlib.Path(directory) if directory else BUILD_DIR / "global"
    return _ensure(d / f"surfdata_{ncell}.nc",
                   lambda p: write_global_surfdata(p, ncell))


# ---------------------------------------------------------------------------
# snow-aging tables and a landunit map
# ---------------------------------------------------------------------------

def snow_aging_tables() -> dict:
    """Synthetic ``snicar_drdt_bst`` tables, [11, 31, 8] over (T from 223 K
    in 5 K bins, dT/dz in 10 K/m bins, rho from 50 kg/m3 in 50 kg/m3
    bins): ``drdsdt0`` [um/h] grows with temperature and gradient and falls
    with density (0.06-4.3 um/h), ``tau`` [um] and ``kappa`` set how fast
    the growth slows as the radius departs from fresh snow."""
    i = np.arange(11, dtype=np.float64)[:, None, None]
    j = np.arange(31, dtype=np.float64)[None, :, None]
    k = np.arange(8, dtype=np.float64)[None, None, :]
    drdsdt0 = (0.1 + 0.3 * i + 0.04 * j) / (1.0 + 0.1 * k)
    tau = 20.0 + 10.0 * k + 2.0 * j + 0.0 * i
    kappa = 1.5 + 0.2 * i + 0.05 * j + 0.0 * k
    return {name: np.broadcast_to(v, (11, 31, 8)).copy()
            for name, v in (("tau", tau), ("kappa", kappa),
                            ("drdsdt0", drdsdt0))}


def write_snow_aging_tables(path) -> None:
    """Write the synthetic ``snicar_drdt_bst`` NetCDF to ``path``."""
    dims = ("nbr_temperature", "nbr_tgrad", "nbr_rho")
    write_nc(path, dict(zip(dims, (11, 31, 8))),
             {name: (dims, v) for name, v in snow_aging_tables().items()})


# landunit shares of the landunit map: ice sheet (the highest latitudes),
# then crop and wetland drawn at random among the rest; soil takes what is
# left (~84 %).  Lakes stay out: the reference carries them as a
# placeholder class only.
ICE_SHARE, CROP_SHARE, WET_SHARE = 0.01, 0.10, 0.05
# share of the ice-sheet columns that are multiple elevation classes
ICE_MEC_SHARE = 0.5


def landunit_map(lat_deg, seed: int = 0) -> np.ndarray:
    """Landunit type of each column of a grid with latitudes ``lat_deg``:
    the ICE_SHARE highest-latitude columns are ice sheet (ISTICE_MEC on a
    seeded ICE_MEC_SHARE of them), CROP_SHARE and WET_SHARE of all columns
    are crop and wetland, drawn from ``seed`` among the others, the rest
    soil."""
    lat = np.asarray(lat_deg, np.float64)
    n = lat.shape[0]
    rng = np.random.default_rng(seed)
    lt = np.full(n, c.ISTSOIL, np.int64)
    nice = int(round(ICE_SHARE * n))
    ice = np.argsort(-lat, kind="stable")[:nice]
    lt[ice] = np.where(rng.random(nice) < ICE_MEC_SHARE, c.ISTICE_MEC,
                       c.ISTICE)
    u = rng.random(n)
    rest = lt == c.ISTSOIL
    scale = 1.0 - ICE_SHARE
    lt[rest & (u < CROP_SHARE / scale)] = c.ISTCROP
    lt[rest & (u >= CROP_SHARE / scale)
       & (u < (CROP_SHARE + WET_SHARE) / scale)] = c.ISTWET
    return lt


def landunit_vtypes(vtype, ltype) -> np.ndarray:
    """``vtype`` with ice-sheet and wetland columns unvegetated (PFT 0);
    soil and crop columns keep theirs."""
    lt = np.asarray(ltype)
    bare = np.isin(lt, (c.ISTICE, c.ISTICE_MEC, c.ISTWET))
    return np.where(bare, c.NOVEG, np.asarray(vtype)).astype(np.int64)
