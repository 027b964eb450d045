"""Parameter loading: PFT traits (one PFT or gathered per column), SNICAR
optics tables, and ModelParams assembly for a homogeneous or a
per-column (surfdata-driven) domain.

Counterpart of ``elmkernels_tpu/data/params.py`` and ``snicar_data.py``
(the reference's ``pft_data.h`` and ``snicar_data.h``), reading NetCDF
classic through scipy.  The readers are building blocks of ``Model``, not
entry points: ``device=None`` builds host tensors (PyTorch's default
device), and ``Model`` passes its resolved device.
"""

from __future__ import annotations

import numpy as np
import torch

from elmkernels_torch import constants as c
from elmkernels_torch.data import soil_data
from elmkernels_torch.data.netcdf import open_nc
from elmkernels_torch.data.state import ModelParams
from elmkernels_torch.physics import init_state as ini
from elmkernels_torch.physics import soil_texture as stx
from elmkernels_torch.physics.photosynthesis import PFTPsnParams
from elmkernels_torch.physics.snow_snicar import IDX_MIE_SNW_MX, SnicarTables
from elmkernels_torch.physics.surface_albedo import PFTAlbParams

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


def gather_pft_psn(table: dict, vtype, dtype=torch.float64,
                   device=None) -> PFTPsnParams:
    """Per-column photosynthesis traits: rows of the trait matrix by each
    column's PFT (the reference's per-cell ``get_pft_psn``,
    ``pft_data_impl.hh:60-96``), [ncol] tensors."""
    vt = np.asarray(vtype, np.int64)
    vals = [table[n][vt] for n in PSN_PARAM_NAMES]
    vals.append(np.full(vt.shape, table["tc_stress"]))
    return PFTPsnParams(*(torch.tensor(v, dtype=dtype, device=device)
                          for v in vals))


def gather_pft_alb(table: dict, vtype, dtype=torch.float64,
                   device=None) -> PFTAlbParams:
    """Per-column albedo traits: [ncol, numrad] optics and an [ncol] xl
    (reference ``pft_data_impl.hh:103-116``)."""
    vt = np.asarray(vtype, np.int64)

    def t(a):
        return torch.tensor(a, dtype=dtype, device=device)

    def band(pre):
        return t(np.stack([table[pre + "vis"][vt], table[pre + "nir"][vt]],
                          axis=-1))
    return PFTAlbParams(rhol=band("rhol"), rhos=band("rhos"),
                        taul=band("taul"), taus=band("taus"),
                        xl=t(table["xl"][vt]))


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


def _read_slab(f, names, shape, path) -> np.ndarray:
    """The start-0 hyperslab ``shape`` of the first of ``names`` in the
    open file ``f``, as float64: the reference reads fixed-count
    hyperslabs (``snicar_data_impl.hh:65-160``), ignoring extra extent."""
    name = next((n for n in names if n in f.variables), None)
    if name is None:
        raise KeyError(f"{path}: none of {names} present")
    arr = np.asarray(f.variables[name][:], np.float64)
    if arr.ndim != len(shape) or any(
            a < want for a, want in zip(arr.shape, shape)):
        raise ValueError(f"{path}:{name}: shape {arr.shape} does not "
                         f"hold the hyperslab {shape}")
    return arr[tuple(slice(0, s) for s in shape)]


def read_snicar_data(path, dtype=torch.float64, device=None) -> SnicarTables:
    """SNICAR optics from a snicar_optics_5bnd*.nc: fixed start-0
    hyperslabs, as the reference reads them."""
    f = open_nc(path)
    return SnicarTables(**{
        slot: torch.tensor(_read_slab(f, names, shape, path), dtype=dtype,
                           device=device)
        for slot, (names, shape) in SNICAR_VARS.items()})


# extents of the snow-aging tables over (T, dT/dz, rho) bins
# (reference snow_snicar.h:27-36: idx_T_max + 1, idx_Tgrd_max + 1,
# idx_rhos_max + 1)
SNOW_AGING_SHAPE = (11, 31, 8)
SNOW_AGING_VARS = ("tau", "kappa", "drdsdt0")


def read_snowrds_data(path) -> tuple:
    """The snow-aging tables (tau, kappa, drdsdt0), [11, 31, 8] float64
    numpy arrays, from a snicar_drdt_bst*.nc (reference
    ``read_snowrds_data``, ``snicar_data_impl.hh:134-160``)."""
    f = open_nc(path)
    return tuple(_read_slab(f, [name], SNOW_AGING_SHAPE, path)
                 for name in SNOW_AGING_VARS)


def default_snow_aging_tables():
    """Placeholder snow-aging tables [11, 31, 8]: inert under the
    reference's double clamp (``elm_correct_snow_aging=False``), which
    pins every radius to SNW_RDS_MIN whatever the tables hold."""
    i = np.arange(11)[:, None, None]
    j = np.arange(31)[None, :, None]
    k = np.arange(8)[None, None, :]
    tau = 1000.0 + 30.0 * i + 10.0 * j + 50.0 * k + 0.0 * (i + j + k)
    kappa = 1.0 + 0.02 * i + 0.005 * j + 0.01 * k
    drdt0 = 1.0 + 0.05 * i + 0.01 * j + 0.02 * k
    return tuple(np.broadcast_to(t, (11, 31, 8)).copy()
                 for t in (tau, kappa, drdt0))


def _per_column(val, ncol: int, name: str, dtype, device):
    """A scalar or [ncol] site value as an [ncol] tensor."""
    a = np.asarray(val, np.float64)
    if a.ndim == 0:
        return torch.full((ncol,), float(a), dtype=dtype, device=device)
    if a.shape != (ncol,):
        raise ValueError(f"{name} shape {a.shape} != ({ncol},)")
    return torch.tensor(a, dtype=dtype, device=device)


def _per_column_profile(val, ncol: int, nlev: int, name: str, dtype,
                        device):
    """A scalar, [ncol] or [ncol, nlev] soil value as [ncol, nlev]."""
    a = np.asarray(val, np.float64)
    if a.ndim == 0:
        return torch.full((ncol, nlev), float(a), dtype=dtype,
                          device=device)
    if a.ndim == 1:
        if a.shape != (ncol,):
            raise ValueError(f"{name} shape {a.shape} != ({ncol},)")
        a = np.broadcast_to(a[:, None], (ncol, nlev))
    elif a.shape != (ncol, nlev):
        raise ValueError(f"{name} shape {a.shape} != ({ncol}, {nlev})")
    return torch.tensor(a, dtype=dtype, device=device)


def default_params(ncol: int, pft_path, vtype=12, lat_deg=71.323,
                   lon_deg=203.3886, soil_color=15, pct_sand=40.0,
                   pct_clay=20.0, organic=10.0, mxsoil_color: int = 20,
                   snowage_tables=None, ltype=c.ISTSOIL,
                   topo_slope_raw=0.070044865858546,
                   topo_std=3.96141847422387,
                   dtype=torch.float64, device=None) -> ModelParams:
    """Assemble ModelParams.  Defaults mirror the reference driver's
    hardwired site (``elm_kokkos_interface.cc:92-96``: Utqiagvik) with
    pedotransfer-derived soil constants.  ``vtype``, ``lat_deg``/
    ``lon_deg``, ``soil_color``, the texture (``pct_sand``/``pct_clay``/
    ``organic``, also [ncol, nlevsoi]), ``topo_*`` and the landunit type
    ``ltype`` each take a scalar or an [ncol] array, for a
    surfdata-driven heterogeneous grid (reference
    ``initialize_elm_kokkos.cc:267-340``, ``soil_data_impl.hh:139-241``).
    ``snowage_tables`` is a (tau, kappa, drdsdt0) triple from
    :func:`read_snowrds_data`; None keeps the placeholder tables."""
    vt = np.asarray(vtype, np.int64)
    heterog = vt.ndim > 0
    if heterog and vt.shape != (ncol,):
        raise ValueError(f"vtype shape {vt.shape} != ({ncol},)")

    def col(v, name):
        return _per_column(v, ncol, name, dtype, device)

    def prof(v, name):
        return _per_column_profile(v, ncol, c.NLEVSOI, name, dtype, device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                            device=device)

    # soil texture -> hydraulic/thermal constants
    zsoi2 = t(ZSOI_SOIL).expand(ncol, c.NLEVGRND)
    hyd = stx.init_soil_hydraulics(
        soil_data.read_organic_max(pft_path), prof(pct_sand, "pct_sand"),
        prof(pct_clay, "pct_clay"), prof(organic, "organic"), zsoi2)

    lt = np.asarray(ltype, np.int64)
    if lt.ndim and lt.shape != (ncol,):
        raise ValueError(f"ltype shape {lt.shape} != ({ncol},)")
    ltype_t = torch.as_tensor(np.broadcast_to(lt, (ncol,)).copy(),
                              device=device)
    # a per-column ltype makes init_melt_factor select per column
    land = c.LandType(ltype=int(lt) if lt.ndim == 0 else ltype_t, ctype=1,
                      vtype=int(vt.flat[0]))
    topo_slope = ini.init_topo_slope(col(topo_slope_raw, "topo_slope_raw"))
    n_melt = ini.init_melt_factor(land, col(topo_std, "topo_std"))
    micro_sigma = ini.init_micro_sigma(topo_slope)

    # root fraction and roughness from the PFT table, per column or one
    table = load_pft_table(pft_path)
    zi2 = t(ZISOI_SOIL).expand(ncol, c.NLEVGRND + 1)
    ones = torch.ones((ncol,), dtype=dtype, device=device)
    if heterog:
        roota, rootb = t(table["roota_par"][vt]), t(table["rootb_par"][vt])
        displar_v = t(table["displar"][vt]) * ones
        z0mr_v = t(table["z0mr"][vt]) * ones
        vt_roots = torch.as_tensor(vt, device=device)
    else:
        roota = float(table["roota_par"][int(vt)])
        rootb = float(table["rootb_par"][int(vt)])
        displar_v = float(table["displar"][int(vt)]) * ones
        z0mr_v = float(table["z0mr"][int(vt)]) * ones
        vt_roots = int(vt)
    rootfr = ini.init_vegrootfr(vt_roots, roota, rootb, zi2)
    if snowage_tables is None:
        snowage_tables = default_snow_aging_tables()
    tau, kappa, drdt0 = snowage_tables
    zsmall = 1.0e-12 * ones

    # soil-color albedo: one or [ncol] color classes against the 8- or
    # 20-class table (reference read_soil_colors, soil_data_impl.hh:139)
    color = np.broadcast_to(np.asarray(soil_color, np.int64), (ncol,))
    idx = np.clip(color - 1, 0, mxsoil_color - 1)

    return ModelParams(
        lat_r=col(np.asarray(lat_deg, np.float64) * c.ELM_PI / 180.0,
                  "lat_deg"),
        lon_r=col(np.asarray(lon_deg, np.float64) * c.ELM_PI / 180.0,
                  "lon_deg"),
        vtype=torch.as_tensor(np.broadcast_to(vt, (ncol,)).copy(),
                              device=device),
        ltype=ltype_t,
        watsat=hyd.watsat, sucsat=hyd.sucsat, bsw=hyd.bsw,
        watdry=hyd.watdry, watopt=hyd.watopt, watfc=hyd.watfc,
        tkmg=hyd.tkmg, tkdry=hyd.tkdry, csol=hyd.csol, rootfr=rootfr,
        micro_sigma=micro_sigma, n_melt=n_melt,
        displar_v=displar_v, z0mr_v=z0mr_v,
        albsat=t(soil_data.get_albsat(mxsoil_color)[idx]),
        albdry=t(soil_data.get_albdry(mxsoil_color)[idx]),
        snowage_tau=t(tau), snowage_kappa=t(kappa), snowage_drdt0=t(drdt0),
        aero_bcphi=zsmall, aero_bcpho=zsmall, aero_bcdep=zsmall,
        aero_dst1_1=zsmall, aero_dst1_2=zsmall, aero_dst2_1=zsmall,
        aero_dst2_2=zsmall, aero_dst3_1=zsmall, aero_dst3_2=zsmall,
        aero_dst4_1=zsmall, aero_dst4_2=zsmall)
