"""The benchmark's input files, written from closed-form values: a
``clm_params``-style PFT trait file, SNICAR optics, and the global grid's
surfdata, phenology and aerosol-deposition files.

A copy of the writers of ``elmkernels_torch/data/synthetic.py`` (the arithmetic
of the JAX package's ``tools/make_global_surfdata.py``), kept here so that
the program and the reference read the same files and no change to the
program changes them.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.elm import constants as c
from portbench.reference.elm.data.netcdf import write_nc

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


def write_aerosol_deposition(path, ncell: int) -> None:
    """A monthly deposition climatology (12, gridcell) of the eleven
    species of ``AerosolDataManager``: species i in month m and cell j
    deposits (i + 1) 1e-12 (1 + m) + 1e-14 j kg/m2/s."""
    from portbench.reference.elm.data.aerosol_data import DEP_VARS
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
