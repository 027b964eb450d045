"""Parameter loading: PFT traits, SNICAR optics tables, soil-color albedo
tables, and default ModelParams assembly for a homogeneous domain.

Counterpart of ``elmkernels_tpu/data/params.py``, ``soil_data.py`` and
``snicar_data.py`` (the reference's ``pft_data.h``, ``snicar_data.h`` and
``soil_data.h``), reading NetCDF classic through scipy.
"""

from __future__ import annotations

import numpy as np
import torch

from elmkernels_torch import constants as c
from elmkernels_torch.data.netcdf import open_nc
from elmkernels_torch.data.state import ModelParams
from elmkernels_torch.physics import init_state as ini
from elmkernels_torch.physics import soil_texture as stx
from elmkernels_torch.physics.photosynthesis import PFTPsnParams
from elmkernels_torch.physics.snow_snicar import IDX_MIE_SNW_MX, SnicarTables
from elmkernels_torch.physics.surface_albedo import PFTAlbParams

# 20-class soil albedo tables (reference soil_data_impl.hh:5-140)
ALBSAT_20 = np.array([
    [0.25, 0.50], [0.23, 0.46], [0.21, 0.42], [0.20, 0.40], [0.19, 0.38],
    [0.18, 0.36], [0.17, 0.34], [0.16, 0.32], [0.15, 0.30], [0.14, 0.28],
    [0.13, 0.26], [0.12, 0.24], [0.11, 0.22], [0.10, 0.20], [0.09, 0.18],
    [0.08, 0.16], [0.07, 0.14], [0.06, 0.12], [0.05, 0.10], [0.04, 0.08]])
ALBDRY_20 = np.array([
    [0.36, 0.61], [0.34, 0.57], [0.32, 0.53], [0.31, 0.51], [0.30, 0.49],
    [0.29, 0.48], [0.28, 0.45], [0.27, 0.43], [0.26, 0.41], [0.25, 0.39],
    [0.24, 0.37], [0.23, 0.35], [0.22, 0.33], [0.20, 0.31], [0.18, 0.29],
    [0.16, 0.27], [0.14, 0.25], [0.12, 0.23], [0.10, 0.21], [0.08, 0.16]])
ALBSAT_8 = np.array([
    [0.12, 0.24], [0.11, 0.22], [0.10, 0.20], [0.09, 0.18], [0.08, 0.16],
    [0.07, 0.14], [0.06, 0.12], [0.05, 0.10]])
ALBDRY_8 = np.array([
    [0.24, 0.48], [0.22, 0.44], [0.20, 0.40], [0.18, 0.36], [0.16, 0.32],
    [0.14, 0.28], [0.12, 0.24], [0.10, 0.20]])

PSN_PARAM_NAMES = ["fnr", "act25", "kcha", "koha", "cpha", "vcmaxha",
                   "jmaxha", "tpuha", "lmrha", "vcmaxhd", "jmaxhd", "tpuhd",
                   "lmrhd", "lmrse", "qe", "theta_cj", "bbbopt", "mbbopt",
                   "c3psn", "slatop", "leafcn", "flnr", "fnitr", "dleaf",
                   "smpso", "smpsc"]

# the full 41-trait surface the reference reads (pft_data.h:20-96)
PFT_TABLE_NAMES = PSN_PARAM_NAMES + [
    "rholvis", "rholnir", "rhosvis", "rhosnir", "taulvis", "taulnir",
    "tausvis", "tausnir", "xl", "roota_par", "rootb_par", "displar",
    "z0mr", "dsladlai", "leaf_long", "evergreen", "stress_decid",
    "season_decid"]

# zsoi / zisoi of the reference's soil mesh (soil part)
ZSOI_SOIL = (0.007100635417193535, 0.02792500041531687, 0.06225857393654604,
             0.11886506690014327, 0.21219339590896316, 0.3660657971047043,
             0.6197584979298266, 1.0380270500015696, 1.7276353086671965,
             2.8646071131796917, 4.73915671146575, 7.829766507142356,
             12.92532061670855, 21.32646906315379, 35.17762120511739)
ZISOI_SOIL = (0.0, 0.017512817916255204, 0.04509178717593146,
              0.09056182041834465, 0.16552923140455322, 0.28912959650683373,
              0.4929121475172655, 0.8288927739656982, 1.382831179334383,
              2.2961212109234443, 3.8018819123227208, 6.284461609304053,
              10.377543561925453, 17.12589483993117, 28.252045134135592,
              42.10319727609919)


def _scalar(v, dtype, device):
    return torch.tensor(float(v), dtype=dtype, device=device)


def load_pft_table(path) -> dict:
    """Per-PFT trait matrix from a clm_params NetCDF: one ``[numpft]``
    float array per trait plus the scalar ``tc_stress``."""
    f = open_nc(path)
    table = {n: np.array(f.variables[n][:], dtype=np.float64)
             for n in PFT_TABLE_NAMES if n in f.variables}
    table["tc_stress"] = float(f.variables["tc_stress"][0])
    return table


def load_pft_psn(path, vtype: int, dtype=torch.float64,
                 device=None) -> PFTPsnParams:
    """Photosynthesis traits for one PFT (``pft_data_impl.hh:60-96``) as
    0-d tensors."""
    f = open_nc(path)
    vals = [float(f.variables[n][vtype]) for n in PSN_PARAM_NAMES]
    vals.append(float(f.variables["tc_stress"][0]))
    return PFTPsnParams(*(_scalar(v, dtype, device) for v in vals))


def load_pft_alb(path, vtype: int, dtype=torch.float64,
                 device=None) -> PFTAlbParams:
    """Albedo traits for one PFT (``pft_data_impl.hh:103-116``)."""
    f = open_nc(path)

    def v(name):
        return _scalar(f.variables[name][vtype], dtype, device)
    return PFTAlbParams(
        rhol=(v("rholvis"), v("rholnir")), rhos=(v("rhosvis"), v("rhosnir")),
        taul=(v("taulvis"), v("taulnir")), taus=(v("tausvis"), v("tausnir")),
        xl=v("xl"))


def read_organic_max(path) -> float:
    f = open_nc(path)
    return float(np.asarray(f.variables["organic_max"][:]).ravel()[0])


# SNICAR optics: table slot -> (candidate file variable names, hyperslab
# shape); the first candidate is the reference's file name
# (initialize_elm_kokkos.cc:23-60, snicar_data_impl.hh:55-131)
_AER = {"oc1": "ocphil", "oc2": "ocphob", "dst1": "dust01",
        "dst2": "dust02", "dst3": "dust03", "dst4": "dust04"}
SNICAR_VARS = {}
for _slot, _fname in _AER.items():
    for _p in ("ss_alb", "asm_prm", "ext_cff_mss"):
        SNICAR_VARS[f"{_p}_{_slot}"] = ([f"{_p}_{_fname}", f"{_p}_{_slot}"],
                                        (c.NUMRAD_SNW,))
for _kind in ("drc", "dfs"):
    for _p in ("ss_alb", "asm_prm", "ext_cff_mss"):
        SNICAR_VARS[f"{_p}_snw_{_kind}"] = (
            [f"{_p}_ice_{_kind}", f"{_p}_snw_{_kind}"],
            (c.NUMRAD_SNW, IDX_MIE_SNW_MX))
for _slot, _legacy in (("bc1", "bcint"), ("bc2", "bcext")):
    for _p in ("ss_alb", "asm_prm", "ext_cff_mss"):
        SNICAR_VARS[f"{_p}_{_slot}"] = (
            [f"{_p}_bc_mam", f"{_p}_{_legacy}", f"{_p}_{_slot}"],
            (10, c.NUMRAD_SNW))
SNICAR_VARS["bcenh"] = (["bcint_enh_mam", "bcenh"], (8, 10, c.NUMRAD_SNW))


def read_snicar_data(path, dtype=torch.float64, device=None) -> SnicarTables:
    """SNICAR optics from a snicar_optics_5bnd*.nc: fixed start-0
    hyperslabs, as the reference reads them."""
    f = open_nc(path)
    kw = {}
    for slot, (names, shape) in SNICAR_VARS.items():
        name = next((n for n in names if n in f.variables), None)
        if name is None:
            raise KeyError(f"{path}: none of {names} present")
        arr = np.asarray(f.variables[name][:], np.float64)
        if arr.ndim != len(shape) or any(
                a < want for a, want in zip(arr.shape, shape)):
            raise ValueError(f"{path}:{name}: shape {arr.shape} does not "
                             f"hold the hyperslab {shape}")
        arr = arr[tuple(slice(0, s) for s in shape)]
        kw[slot] = torch.tensor(arr, dtype=dtype, device=device)
    return SnicarTables(**kw)


def default_snow_aging_tables():
    """Placeholder snow-aging tables [11, 31, 8] (inert under the
    reference's double-clamp default, which the port runs)."""
    i = np.arange(11)[:, None, None]
    j = np.arange(31)[None, :, None]
    k = np.arange(8)[None, None, :]
    tau = 1000.0 + 30.0 * i + 10.0 * j + 50.0 * k + 0.0 * (i + j + k)
    kappa = 1.0 + 0.02 * i + 0.005 * j + 0.01 * k
    drdt0 = 1.0 + 0.05 * i + 0.01 * j + 0.02 * k
    return tuple(np.broadcast_to(t, (11, 31, 8)).copy()
                 for t in (tau, kappa, drdt0))


def default_params(ncol: int, pft_path, vtype: int = 12,
                   lat_deg: float = 71.323, lon_deg: float = 203.3886,
                   soil_color: int = 15, pct_sand: float = 40.0,
                   pct_clay: float = 20.0, organic: float = 10.0,
                   mxsoil_color: int = 20, ltype: int = c.ISTSOIL,
                   topo_slope_raw: float = 0.070044865858546,
                   topo_std: float = 3.96141847422387,
                   dtype=torch.float64, device=None) -> ModelParams:
    """Assemble ModelParams for a homogeneous domain.  Defaults mirror the
    reference driver's hardwired site (``elm_kokkos_interface.cc:92-96``:
    Utqiagvik) with pedotransfer-derived soil constants."""
    def full(v, shape=(ncol,)):
        return torch.full(shape, float(v), dtype=dtype, device=device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    # soil texture -> hydraulic/thermal constants
    zsoi2 = t(ZSOI_SOIL).expand(ncol, c.NLEVGRND)
    organic_max = read_organic_max(pft_path)
    hyd = stx.init_soil_hydraulics(
        organic_max, full(pct_sand, (ncol, c.NLEVSOI)),
        full(pct_clay, (ncol, c.NLEVSOI)), full(organic, (ncol, c.NLEVSOI)),
        zsoi2)

    land = c.LandType(ltype=int(ltype), ctype=1, vtype=int(vtype))
    topo_slope = ini.init_topo_slope(full(topo_slope_raw))
    n_melt = ini.init_melt_factor(land, full(topo_std))
    micro_sigma = ini.init_micro_sigma(topo_slope)

    table = load_pft_table(pft_path)
    zi2 = t(ZISOI_SOIL).expand(ncol, c.NLEVGRND + 1)
    rootfr = ini.init_vegrootfr(int(vtype), float(table["roota_par"][vtype]),
                                float(table["rootb_par"][vtype]), zi2)
    ones = full(1.0)
    displar_v = float(table["displar"][vtype]) * ones
    z0mr_v = float(table["z0mr"][vtype]) * ones
    tau, kappa, drdt0 = default_snow_aging_tables()
    zsmall = 1.0e-12 * ones

    albsat_t = ALBSAT_20 if mxsoil_color == 20 else ALBSAT_8
    albdry_t = ALBDRY_20 if mxsoil_color == 20 else ALBDRY_8
    idx = int(np.clip(soil_color - 1, 0, mxsoil_color - 1))

    return ModelParams(
        lat_r=full(np.float64(lat_deg) * c.ELM_PI / 180.0),
        lon_r=full(np.float64(lon_deg) * c.ELM_PI / 180.0),
        vtype=torch.full((ncol,), int(vtype), dtype=torch.long,
                         device=device),
        ltype=torch.full((ncol,), int(ltype), dtype=torch.long,
                         device=device),
        watsat=hyd.watsat, sucsat=hyd.sucsat, bsw=hyd.bsw,
        watdry=hyd.watdry, watopt=hyd.watopt, watfc=hyd.watfc,
        tkmg=hyd.tkmg, tkdry=hyd.tkdry, csol=hyd.csol, rootfr=rootfr,
        micro_sigma=micro_sigma, n_melt=n_melt,
        displar_v=displar_v, z0mr_v=z0mr_v,
        albsat=t(albsat_t[idx]).expand(ncol, 2).contiguous(),
        albdry=t(albdry_t[idx]).expand(ncol, 2).contiguous(),
        snowage_tau=t(tau), snowage_kappa=t(kappa), snowage_drdt0=t(drdt0),
        aero_bcphi=zsmall, aero_bcpho=zsmall, aero_bcdep=zsmall,
        aero_dst1_1=zsmall, aero_dst1_2=zsmall, aero_dst2_1=zsmall,
        aero_dst2_2=zsmall, aero_dst3_1=zsmall, aero_dst3_2=zsmall,
        aero_dst4_1=zsmall, aero_dst4_2=zsmall)
