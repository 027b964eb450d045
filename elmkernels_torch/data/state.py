"""Model state and per-step inputs as NamedTuples of tensors.

Counterpart of ``elmkernels_tpu/data/state.py``: :class:`ModelState`
persists step to step (the reference's ``PrimaryVars`` restart set plus
carried fluxes), :class:`ModelParams` holds static per-column parameters.
All arrays carry the column axis first.  ``snl`` and ``vtype``/``ltype``
are int64 here (int32 in the JAX package) so they index directly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from elmkernels_torch import constants as c

AERO_SPECIES = ("bcphi", "bcpho", "dst1", "dst2", "dst3", "dst4")

# deposition-rate keys (reference AerosolFileInput, aerosol_data.h:10-27)
AERO_DEP_KEYS = ("bcphi", "bcpho", "bcdep", "dst1_1", "dst1_2", "dst2_1",
                 "dst2_2", "dst3_1", "dst3_2", "dst4_1", "dst4_2")


class ModelState(NamedTuple):
    """Prognostic + carried state, [ncol, ...] tensors."""
    # snow pack
    snl: torch.Tensor            # int64 [ncol] active snow layers
    snow_depth: torch.Tensor
    frac_sno: torch.Tensor
    frac_sno_eff: torch.Tensor
    int_snow: torch.Tensor
    h2osno: torch.Tensor
    snw_rds: torch.Tensor        # [ncol, NLEVSNO]
    # water state
    h2ocan: torch.Tensor
    h2osfc: torch.Tensor
    frac_h2osfc: torch.Tensor
    h2osoi_liq: torch.Tensor     # [ncol, NLEVTOT]
    h2osoi_ice: torch.Tensor
    h2osoi_vol: torch.Tensor     # [ncol, NLEVGRND]
    # temperatures
    t_soisno: torch.Tensor       # [ncol, NLEVTOT]
    t_grnd: torch.Tensor
    t_h2osfc: torch.Tensor
    t_veg: torch.Tensor
    t10: torch.Tensor
    # mesh (snow part evolves)
    dz: torch.Tensor             # [ncol, NLEVTOT]
    z: torch.Tensor
    zi: torch.Tensor             # [ncol, NLEVTOT+1]
    # aerosols in snow, [ncol, NLEVSNO] each
    mss_bcphi: torch.Tensor
    mss_bcpho: torch.Tensor
    mss_dst1: torch.Tensor
    mss_dst2: torch.Tensor
    mss_dst3: torch.Tensor
    mss_dst4: torch.Tensor
    cnc_bcphi: torch.Tensor
    cnc_bcpho: torch.Tensor
    cnc_dst1: torch.Tensor
    cnc_dst2: torch.Tensor
    cnc_dst3: torch.Tensor
    cnc_dst4: torch.Tensor
    # fluxes carried across steps (next step's snow_water/snow_init)
    qflx_snow_melt: torch.Tensor
    qflx_sub_snow: torch.Tensor
    qflx_evap_grnd: torch.Tensor
    qflx_dew_snow: torch.Tensor
    qflx_dew_grnd: torch.Tensor
    # solver warm-start carries (zeros = cold; read under warm_start)
    ci_sun: torch.Tensor
    ci_sha: torch.Tensor
    obu_can: torch.Tensor

    @property
    def mss(self) -> dict:
        return {k: getattr(self, "mss_" + k) for k in AERO_SPECIES}


class ModelParams(NamedTuple):
    """Static per-column parameters + lookup tables."""
    lat_r: torch.Tensor          # [ncol] latitude (radians)
    lon_r: torch.Tensor
    vtype: torch.Tensor          # int64 [ncol]
    ltype: torch.Tensor          # int64 [ncol]
    # soil hydraulic/thermal constants [ncol, NLEVGRND]
    watsat: torch.Tensor
    sucsat: torch.Tensor
    bsw: torch.Tensor
    watdry: torch.Tensor
    watopt: torch.Tensor
    watfc: torch.Tensor
    tkmg: torch.Tensor
    tkdry: torch.Tensor
    csol: torch.Tensor
    rootfr: torch.Tensor
    # topography-derived [ncol]
    micro_sigma: torch.Tensor
    n_melt: torch.Tensor
    # PFT roughness traits [ncol]
    displar_v: torch.Tensor
    z0mr_v: torch.Tensor
    # soil albedo by color class [ncol, numrad]
    albsat: torch.Tensor
    albdry: torch.Tensor
    # snow aging tables [11, 31, 8]
    snowage_tau: torch.Tensor
    snowage_kappa: torch.Tensor
    snowage_drdt0: torch.Tensor
    # aerosol deposition rates [ncol] each
    aero_bcphi: torch.Tensor
    aero_bcpho: torch.Tensor
    aero_bcdep: torch.Tensor
    aero_dst1_1: torch.Tensor
    aero_dst1_2: torch.Tensor
    aero_dst2_1: torch.Tensor
    aero_dst2_2: torch.Tensor
    aero_dst3_1: torch.Tensor
    aero_dst3_2: torch.Tensor
    aero_dst4_1: torch.Tensor
    aero_dst4_2: torch.Tensor

    @property
    def aero_in(self) -> dict:
        return {k: getattr(self, "aero_" + k) for k in AERO_DEP_KEYS}


class StepForcing(NamedTuple):
    """One step of atmospheric forcing: raw bracketing samples + weights
    (interpolated inside the step).  Host providers fill it with numpy;
    ``Model`` moves it to the device."""
    wt1: object                 # scalar weights
    wt2: object
    tbot: object                # [2, ncol]
    pbot: object
    qbot: object
    flds: object
    wind: object
    fsds: object                # [ncol] (piecewise constant)
    prec: object                # [ncol]
    decday: object              # scalar decimal day-of-year (1-based)
    # monthly-interpolated aerosol deposition rates, [11, ncol] stacked in
    # AERO_DEP_KEYS order; None keeps the static ModelParams.aero_* rates
    aero: object = None


class StepPhenology(NamedTuple):
    """Bracketing monthly phenology slices + weights."""
    wt1: object
    wt2: object
    mlai: object                # [2, ncol]
    msai: object
    mhtop: object
    mhbot: object


# the reference driver's hardwired initial column (elm_kokkos_interface.cc)
_DZ_HW = (0.0, 0.0, 0.0, 0.0, 0.0, 0.017512817916255204,
          0.02757896925967625, 0.0454700332424132, 0.07496741098620856,
          0.12360036510228053, 0.20378255101043175, 0.33598062644843263,
          0.5539384053686849, 0.9132900315890611, 1.5057607013992766,
          2.482579696981332, 4.0930819526214, 6.7483512780057175,
          11.12615029420442, 13.851152141963599)
_ZSOI_HW = (0.0, 0.0, 0.0, 0.0, 0.0, 0.007100635417193535,
            0.02792500041531687, 0.06225857393654604, 0.11886506690014327,
            0.21219339590896316, 0.3660657971047043, 0.6197584979298266,
            1.0380270500015696, 1.7276353086671965, 2.8646071131796917,
            4.73915671146575, 7.829766507142356, 12.92532061670855,
            21.32646906315379, 35.17762120511739)
_ZISOI_HW = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
             0.017512817916255204, 0.04509178717593146, 0.09056182041834465,
             0.16552923140455322, 0.28912959650683373, 0.4929121475172655,
             0.8288927739656982, 1.382831179334383, 2.2961212109234443,
             3.8018819123227208, 6.284461609304053, 10.377543561925453,
             17.12589483993117, 28.252045134135592, 42.10319727609919)
_ICE_HW = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
           51.095355179469955, 131.99213225849098, 17.829256395227745,
           95.72899575304584, 155.31526899797177, 0.01, 0.01, 0.01, 0.01,
           0.01)
_LIQ_HW = (0.0, 0.0, 0.0, 0.0, 0.0, 7.045411435071487, 14.353496179256807,
           36.308518784697064, 62.46145027256513, 97.14000248023912,
           97.47148319510016, 78.52160092062527, 65.63904088905001,
           41.25305599181871, 70.8566046019581, 0.01, 0.01, 0.01, 0.01, 0.01)
_VOL_HW = (0.4016484663460637, 0.5196481455614503, 0.7967166638201649,
           0.8331813710901114, 0.7859200286330449, 0.7517405589446893,
           0.6621235242027332, 0.1535948180493002, 0.15947477948341815,
           0.15954052527228618, 8.420726808634413e-06,
           5.107428986500891e-06, 3.0978122726178113e-06,
           1.8789181213767733e-06, 1.5092697845407248e-06)
_TSOI_HW = (0.0, 0.0, 0.0, 0.0, 0.0, 278.3081064745931, 276.1568781897738,
            275.55803480737063, 275.2677090940866, 274.7286996980052, 273.15,
            272.4187794248787, 270.65049816473027, 267.8224112387398,
            265.7450135695632, 264.49481140089864, 264.14163363048056,
            264.3351872934207, 264.1163763444719, 263.88852987294865)


def cold_start(ncol: int, dtype=torch.float64, device=None) -> ModelState:
    """The reference driver's hardwired initial condition, replicated per
    column (``elm_kokkos_interface.cc:58-266``).  A building block, not an
    entry point: ``device=None`` builds host tensors (PyTorch's default
    device); ``Model`` passes its resolved device."""
    def rep(a):
        return torch.tensor(np.asarray(a), dtype=dtype,
                            device=device).repeat(ncol, 1)

    def full(v, shape=(ncol,)):
        return torch.full(shape, v, dtype=dtype, device=device)

    def z1():
        return full(0.0)

    def z5():
        return full(0.0, (ncol, c.NLEVSNO))

    return ModelState(
        snl=torch.zeros((ncol,), dtype=torch.long, device=device),
        snow_depth=z1(), frac_sno=z1(), frac_sno_eff=z1(), int_snow=z1(),
        h2osno=z1(), snw_rds=z5(), h2ocan=z1(), h2osfc=z1(),
        frac_h2osfc=z1(),
        h2osoi_liq=rep(_LIQ_HW), h2osoi_ice=rep(_ICE_HW),
        h2osoi_vol=rep(_VOL_HW), t_soisno=rep(_TSOI_HW),
        t_grnd=full(_TSOI_HW[c.NLEVSNO]), t_h2osfc=full(274.0),
        t_veg=full(283.0), t10=full(276.0),
        dz=rep(_DZ_HW), z=rep(_ZSOI_HW), zi=rep(_ZISOI_HW),
        mss_bcphi=z5(), mss_bcpho=z5(), mss_dst1=z5(), mss_dst2=z5(),
        mss_dst3=z5(), mss_dst4=z5(), cnc_bcphi=z5(), cnc_bcpho=z5(),
        cnc_dst1=z5(), cnc_dst2=z5(), cnc_dst3=z5(), cnc_dst4=z5(),
        qflx_snow_melt=z1(), qflx_sub_snow=z1(), qflx_evap_grnd=z1(),
        qflx_dew_snow=z1(), qflx_dew_grnd=z1(),
        ci_sun=z1(), ci_sha=z1(), obu_can=z1())
