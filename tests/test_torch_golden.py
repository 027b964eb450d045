"""The port against the reference's own outputs (golden files), and its
golden-file parser and snow-layer init against the JAX package's.

- ``utils/golden.py``: ``GoldenFile`` parses every ``tests/data/*_REF.txt``
  to the JAX package's blocks, and ``compare`` has its nan/inf rules.
- The Misc, SoilTemperature and SnowHydrology fixtures need nothing from
  outside the repo: their inputs are embedded (``in_*`` variables).  They
  run through the port's functions in the chains of the JAX package's
  golden tests (``test_misc_modules.py``, ``test_soil_temperature.py``,
  ``test_snow_hydrology.py``) at those tests' tolerances.
- ``init_snow_layers``/``init_snow_state`` against the JAX package's at
  rtol 1e-10 on seeded depths that include 0, each threshold of the
  depth ladder and ``lakpoi`` both ways.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elmkernels_torch import constants as c
from elmkernels_torch.physics import atm_physics as ap
from elmkernels_torch.physics import conservation as ce
from elmkernels_torch.physics import init_state as ini
from elmkernels_torch.physics import snow_hydrology as sh
from elmkernels_torch.physics import soil_temperature as st
from elmkernels_torch.physics import soil_texture as stx
from elmkernels_torch.physics import soil_thermal as sth
from elmkernels_torch.physics import solar
from elmkernels_torch.physics import surface_fluxes as sf
from elmkernels_torch.utils.golden import GoldenFile, compare
from elmkernels_tpu import constants as jc
from elmkernels_tpu.physics import init_state as jini
from elmkernels_tpu.utils import golden as jgolden

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).resolve().parent / "data"
LAND = c.LandType(ltype=1, ctype=1, vtype=12)
DTIME = 1800.0
SPECIES = ["bcphi", "bcpho", "dst1", "dst2", "dst3", "dst4"]


# ---- the parser and compare ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(p.name for p in DATA.glob("*_REF.txt")))
def test_golden_file_parses_as_jax(name):
    t, j = GoldenFile(str(DATA / name)), jgolden.GoldenFile(str(DATA / name))
    assert t.steps == j.steps and t.steps
    for step in t.steps:
        a, b = t.state(step), j.state(step)
        assert list(a) == list(b)
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


COMPARE_CASES = {
    "equal": ([1.0, 2.0], [1.0, 2.0]),
    "within rtol": ([1.0 + 1e-12, 2.0], [1.0, 2.0]),
    "outside": ([1.0 + 1e-6, 2.0], [1.0, 2.0]),
    "nan both": ([np.nan, 1.0], [np.nan, 1.0]),
    "nan one side": ([np.nan, 1.0], [0.0, 1.0]),
    "nan the other": ([0.0, 1.0], [np.nan, 1.0]),
    "inf same sign": ([np.inf, -np.inf], [np.inf, -np.inf]),
    "inf signs differ": ([np.inf], [-np.inf]),
    "spval": ([1e36, 0.0], [1e36, 0.0]),
    "atol near zero": ([1e-13], [0.0]),
    "scalar": (3.0, np.array(3.0)),
    "reshaped": ([[1.0, 2.0]], [1.0, 2.0]),
}


@pytest.mark.parametrize("case", list(COMPARE_CASES))
def test_compare_matches_jax(case):
    got, want = COMPARE_CASES[case]
    want = np.asarray(want, dtype=np.float64)
    results = []
    for fn in (compare, jgolden.compare):
        errors = []
        fn(case, got, want, errors=errors)
        try:
            fn(case, got, want)
            raised = None
        except AssertionError as e:
            raised = str(e)
        results.append((errors, raised))
    assert results[0] == results[1]


# ---- the reference's golden files through the port ---------------------------

def _gather(gref, name, cases):
    arr = np.stack([np.atleast_1d(gref.state(t)[name]) for t in cases])
    if arr.shape[-1] == 1 and np.ndim(gref.state(cases[0])[name]) == 0:
        arr = arr.squeeze(-1)
    return torch.as_tensor(arr, dtype=torch.float64)


def _ints(gref, name, cases):
    return torch.as_tensor([int(gref.state(t)[name]) for t in cases])


def _check(gref, cases, got, rtol, atol, mask=None):
    errors = []
    for name, val in got.items():
        want = np.stack([np.atleast_1d(gref.state(t)[name])
                         for t in cases])
        v = np.array(val.cpu().numpy() if torch.is_tensor(val) else val,
                     dtype=np.float64)
        if v.ndim == 1:
            v = v[:, None]
        if mask is not None:
            v, want = mask(name, v, want)
        compare(name, v, want, rtol=rtol, atol=atol, errors=errors)
    assert not errors, "\n".join(errors[:25])


def _misc_chain(a):
    """``tests/test_misc_modules.py::_chain`` through the port."""
    out = {}
    snl = a["snl"]
    full = torch.full_like
    init = sf.initial_flux_calc(
        LAND, snl, a["frac_sno_eff"], a["frac_h2osfc"], a["t_h2osfc_bef"],
        a["tssbef_snotop"], a["tssbef_soitop"], a["t_grnd"], a["cgrnds"],
        a["cgrndl"], a["eflx_sh_grnd"], a["qflx_evap_soi"],
        a["qflx_ev_snow"], a["qflx_ev_soil"], a["qflx_ev_h2osfc"])
    upd = sf.update_surface_fluxes(
        LAND, a["do_capsnow"], snl, DTIME, a["t_grnd"], a["htvp"],
        a["frac_sno_eff"], a["frac_h2osfc"], a["t_h2osfc_bef"],
        a["sabg_soil"], a["sabg_snow"], a["dlrad"], a["frac_veg_nosno"],
        a["emg"], a["forc_lwrad"], a["tssbef_snotop"], a["tssbef_soitop"],
        a["h2osoi_ice_snotop"], a["h2osoi_liq_snotop"], a["eflx_sh_veg"],
        a["qflx_evap_veg"], init.qflx_evap_soi, init.eflx_sh_grnd,
        init.qflx_ev_snow, init.qflx_ev_soil, init.qflx_ev_h2osfc,
        a["qflx_snwcp_liq"], a["qflx_snwcp_ice"])
    lw = sf.lwrad_outgoing(
        LAND, snl, a["frac_veg_nosno"], a["forc_lwrad"], a["frac_sno_eff"],
        a["tssbef_snotop"], a["tssbef_soitop"], a["frac_h2osfc"],
        a["t_h2osfc_bef"], a["t_grnd"], a["ulrad"], a["emg"])
    out.update(
        eflx_sh_grnd=upd.eflx_sh_grnd, qflx_evap_soi=upd.qflx_evap_soi,
        qflx_ev_snow=upd.qflx_ev_snow, qflx_ev_soil=upd.qflx_ev_soil,
        qflx_ev_h2osfc=upd.qflx_ev_h2osfc,
        eflx_soil_grnd=upd.eflx_soil_grnd, eflx_sh_tot=upd.eflx_sh_tot,
        qflx_evap_tot=upd.qflx_evap_tot, eflx_lh_tot=upd.eflx_lh_tot,
        qflx_evap_grnd=upd.qflx_evap_grnd, qflx_sub_snow=upd.qflx_sub_snow,
        qflx_dew_snow=upd.qflx_dew_snow, qflx_dew_grnd=upd.qflx_dew_grnd,
        qflx_snwcp_liq=upd.qflx_snwcp_liq,
        qflx_snwcp_ice=upd.qflx_snwcp_ice,
        eflx_lwrad_out=lw.eflx_lwrad_out, eflx_lwrad_net=lw.eflx_lwrad_net)

    out["column_water_mass"] = ce.column_water_mass(
        a["h2ocan"], a["h2osno_c"], a["h2osfc_c"], a["ice"], a["liq"])
    out["snow_water_balance_error"] = ce.snow_water_balance_error(
        snl, upd.qflx_dew_snow, upd.qflx_dew_grnd, upd.qflx_sub_snow,
        upd.qflx_evap_grnd, 1.0e-6 * a["cse"], upd.qflx_snwcp_ice,
        upd.qflx_snwcp_liq, full(a["t_grnd"], 2.0e-6),
        a["frac_sno_eff"], full(a["t_grnd"], 3.0e-5),
        full(a["t_grnd"], 2.0e-5), full(a["t_grnd"], 1.0e-6),
        a["h2osno_c"], a["h2osno_c"] - 0.01, DTIME, a["do_capsnow"])
    out["surface_energy_balance_error"] = ce.surface_energy_balance_error(
        50.0 + a["cse"], full(a["t_grnd"], 30.0), a["forc_lwrad"],
        lw.eflx_lwrad_out, upd.eflx_sh_tot, upd.eflx_lh_tot,
        upd.eflx_soil_grnd)

    out["coszen"] = solar.coszen(a["latrad"], a["lonrad"], a["jday"])
    out["avg_cosz"] = solar.average_cosz(a["latrad"], a["lonrad"], DTIME,
                                         a["jday"])
    decl = solar.declination_angle_sin(torch.floor(a["jday"]))
    out["declination"] = decl
    out["daylength"] = solar.daylength(a["latrad"] * 0.9, decl * 0.9,
                                       elm_clamp_quirk=True)
    out["max_daylength"] = solar.max_daylength(a["latrad"] * 0.9,
                                               elm_clamp_quirk=True)

    isl = ini.init_snow_layers(a["snow_depth0"], False)
    out["init_snl"] = isl.snl
    out["init_dz"] = isl.dz
    out["init_z"] = isl.z
    out["init_zi"] = isl.zi
    out["init_topo_slope"] = ini.init_topo_slope(0.1 + 0.05 * a["cse"])
    out["init_melt_factor"] = ini.init_melt_factor(LAND, 5.0 + 3.0 * a["cse"])
    out["init_micro_sigma"] = ini.init_micro_sigma(0.1 + 0.05 * a["cse"])

    hyd = stx.init_soil_hydraulics(130.0, a["sand"], a["clay"],
                                   a["organic"], a["zsoi"][:, c.NLEVSNO:])
    out.update(watsat=hyd.watsat, bsw=hyd.bsw, sucsat=hyd.sucsat,
               watdry=hyd.watdry, watopt=hyd.watopt, watfc=hyd.watfc,
               tkmg=hyd.tkmg, tkdry=hyd.tkdry, csol=hyd.csol)
    out["rootfr"] = ini.init_vegrootfr(LAND.vtype, a["roota"], a["rootb"],
                                       a["zi_full"][:, c.NLEVSNO:])

    wt1 = a["wt1"]
    wt2 = 1.0 - wt1
    forc_t, _ = ap.process_tbot(wt1, wt2, a["tb"][:, 0], a["tb"][:, 1])
    forc_p = ap.process_pbot(wt1, wt2, a["pb"][:, 0], a["pb"][:, 1])
    forc_q = ap.process_qbot(wt1, wt2, a["qb"][:, 0], a["qb"][:, 1],
                             forc_t, forc_p)
    forc_q_rh = ap.process_qbot(wt1, wt2, a["rh"], a["rh"], forc_t, forc_p,
                                is_rh=True)
    forc_lw = ap.process_flds(wt1, wt2, a["fl"][:, 0], a["fl"][:, 1],
                              forc_p, forc_q, forc_t)
    sol = ap.process_fsds(a["fs"], a["cosz"])
    rain, snow = ap.process_prec(a["pr"], forc_t)
    u, _ = ap.process_wind(wt1, wt2, a["wd"][:, 0], a["wd"][:, 1])
    out.update(forc_t=forc_t, forc_p=forc_p, forc_q=forc_q,
               forc_q_rh=forc_q_rh, forc_lw=forc_lw, solad=sol.forc_solad,
               solai=sol.forc_solai, rain=rain, snow=snow, wind_u=u,
               rho=ap.derive_forc_rho(forc_p, forc_q, forc_t),
               po2=ap.derive_forc_po2(forc_p),
               pco2=ap.derive_forc_pco2(forc_p))
    return out


def test_misc_golden():
    """Misc_REF.txt at rtol 1e-11 / atol 1e-12 (test_misc_modules.py)."""
    gref = GoldenFile(str(DATA / "Misc_REF.txt"))
    cases = gref.steps
    scalar = ["frac_sno_eff", "frac_h2osfc", "t_h2osfc_bef",
              "tssbef_snotop", "tssbef_soitop", "t_grnd", "cgrnds",
              "cgrndl", "eflx_sh_grnd", "qflx_evap_soi", "qflx_ev_snow",
              "qflx_ev_soil", "qflx_ev_h2osfc", "h2osoi_ice_snotop",
              "h2osoi_liq_snotop", "htvp", "sabg_soil", "sabg_snow",
              "dlrad", "frac_veg_nosno", "emg", "forc_lwrad",
              "eflx_sh_veg", "qflx_evap_veg", "qflx_snwcp_liq",
              "qflx_snwcp_ice", "ulrad", "h2ocan", "h2osno_c", "h2osfc_c",
              "latrad", "lonrad", "jday", "snow_depth0", "roota", "rootb",
              "wt1", "fs", "pr", "cosz", "rh"]
    arrays = ["ice", "liq", "sand", "clay", "organic", "zsoi", "zi_full",
              "tb", "pb", "qb", "fl", "wd"]
    a = {k: _gather(gref, "in_" + k, cases) for k in scalar + arrays}
    a["snl"] = _ints(gref, "in_snl", cases)
    a["do_capsnow"] = _ints(gref, "in_do_capsnow", cases)
    a["cse"] = torch.arange(len(cases), dtype=torch.float64)
    _check(gref, cases, _misc_chain(a), rtol=1e-11, atol=1e-12)


def _soil_chain(a):
    """``tests/test_soil_temperature.py::_chain`` through the port."""
    snl = a["snl"]
    props = sth.thermal_properties(
        LAND, snl, a["frac_sno"], a["frac_h2osfc"], a["h2osno"], a["h2osfc"],
        a["h2osoi_liq"], a["h2osoi_ice"], a["t_soisno"], a["dz"], a["zsoi"],
        a["zisoi"], a["watsat"], a["tkmg"], a["tkdry"], a["csol"])

    snotop = (c.NLEVSNO - snl)[:, None]
    sabg_top = torch.take_along_dim(a["sabg_lyr"], snotop, dim=1)[:, 0]
    t_top_sno = torch.take_along_dim(a["t_soisno"], snotop, dim=1)[:, 0]
    sabg_chk = st.check_absorbed_solar(a["frac_sno_eff"], a["sabg_snow"],
                                       a["sabg_soil"])
    hs_soil = st.calc_surface_heat_flux(
        a["frac_veg_nosno"], a["dlrad"], a["emg"], a["forc_lwrad"],
        a["htvp"], a["sabg_soil"], a["t_soisno"][:, c.NLEVSNO],
        a["eflx_sh_soil"], a["qflx_ev_soil"])
    hs_h2osfc = st.calc_surface_heat_flux(
        a["frac_veg_nosno"], a["dlrad"], a["emg"], a["forc_lwrad"],
        a["htvp"], a["sabg_soil"], a["t_h2osfc"], a["eflx_sh_h2osfc"],
        a["qflx_ev_h2osfc"])
    hs_top_snow = st.calc_surface_heat_flux(
        a["frac_veg_nosno"], a["dlrad"], a["emg"], a["forc_lwrad"],
        a["htvp"], sabg_top, t_top_sno, a["eflx_sh_snow"],
        a["qflx_ev_snow"])
    dhsdT = st.calc_dhsdT(a["cgrnd"], a["emg"], a["t_grnd"])

    fn = st.calc_diffusive_heat_flux(snl, props.tk, a["t_soisno"], a["zsoi"])
    fact = st.calc_heat_flux_matrix_factor(snl, DTIME, props.cv, a["dz"],
                                           a["zsoi"], a["zisoi"])

    lhs, rhs = st._assemble_system(
        snl, DTIME, dhsdT, a["frac_sno_eff"], a["frac_h2osfc"],
        props.dz_h2osfc, props.c_h2osfc, props.tk_h2osfc, a["zsoi"], fact,
        props.tk, hs_top_snow, hs_soil, hs_h2osfc, a["t_soisno"],
        a["t_h2osfc"], fn, a["sabg_lyr"])
    tvec = st.pdma_solve(lhs, rhs)
    upd = st.update_temperature(snl, a["frac_h2osfc"], tvec, a["t_soisno"])

    sl1 = c.NLEVSNO - 1
    pc1 = st.phase_change_h2osfc(
        snl, DTIME, a["frac_sno"], a["frac_h2osfc"], dhsdT, props.c_h2osfc,
        fact[:, sl1], upd.t_h2osfc, a["h2osfc"], a["h2osno"],
        a["int_snow"], a["snow_depth"],
        upd.t_soisno[:, sl1] * 0.0 + a["h2osoi_ice"][:, sl1],
        upd.t_soisno[:, sl1])
    ice = a["h2osoi_ice"].clone()
    ice[:, sl1] = pc1.h2osoi_ice_sl1
    t_after = upd.t_soisno.clone()
    t_after[:, sl1] = pc1.t_soisno_sl1

    pc2 = st.phase_change_soisno(
        LAND, snl, DTIME, dhsdT, a["frac_h2osfc"], a["frac_sno_eff"], fact,
        a["watsat"], a["sucsat"], a["bsw"], a["dz"], pc1.h2osno,
        pc1.snow_depth, ice, a["h2osoi_liq"], t_after)

    t_grnd = st.update_t_grnd(snl, a["frac_h2osfc"], a["frac_sno_eff"],
                              pc1.t_h2osfc, pc2.t_soisno)
    return {
        "thk": props.thk, "tk": props.tk, "cv": props.cv,
        "tk_h2osfc": props.tk_h2osfc, "c_h2osfc": props.c_h2osfc,
        "dz_h2osfc": props.dz_h2osfc,
        "sabg_chk": sabg_chk, "hs_soil": hs_soil, "hs_h2osfc": hs_h2osfc,
        "hs_top_snow": hs_top_snow, "dhsdT": dhsdT, "fn": fn, "fact": fact,
        "lhs_matrix": lhs, "rhs_presolve": rhs, "tvector": tvec,
        "t_soisno_postsolve": upd.t_soisno,
        "t_h2osfc_postsolve": upd.t_h2osfc,
        "t_soisno": pc2.t_soisno, "t_h2osfc": pc1.t_h2osfc,
        "t_grnd": t_grnd, "h2osfc": pc1.h2osfc, "h2osno": pc2.h2osno,
        "int_snow": pc1.int_snow, "snow_depth": pc2.snow_depth,
        "xmf_h2osfc": pc1.xmf_h2osfc,
        "qflx_h2osfc_to_ice": pc1.qflx_h2osfc_to_ice,
        "eflx_h2osfc_to_snow": pc1.eflx_h2osfc_to_snow,
        "xmf": pc2.xmf, "qflx_snofrz": pc2.qflx_snofrz,
        "qflx_snow_melt": pc2.qflx_snow_melt,
        "qflx_snomelt": pc2.qflx_snomelt, "eflx_snomelt": pc2.eflx_snomelt,
        "imelt": pc2.imelt, "qflx_snofrz_lyr": pc2.qflx_snofrz_lyr,
        "h2osoi_ice": pc2.h2osoi_ice, "h2osoi_liq": pc2.h2osoi_liq,
    }


def test_soil_temperature_golden():
    """SoilTemperature_REF.txt at rtol 1e-12 / atol 1e-9
    (test_soil_temperature.py), rows above the top active layer masked
    as there (identity rows here, zeros and solver scratch there)."""
    gref = GoldenFile(str(DATA / "SoilTemperature_REF.txt"))
    cases = gref.steps
    n = len(cases)
    scalar = ["dlrad", "emg", "forc_lwrad", "htvp", "cgrnd",
              "eflx_sh_soil", "eflx_sh_snow", "eflx_sh_h2osfc",
              "qflx_ev_soil", "qflx_ev_snow", "qflx_ev_h2osfc",
              "frac_sno_eff", "frac_sno", "frac_h2osfc", "sabg_snow",
              "sabg_soil", "h2osfc", "h2osno", "snow_depth", "int_snow",
              "t_h2osfc", "t_grnd"]
    arrays = ["sabg_lyr", "watsat", "sucsat", "bsw", "tkmg", "tkdry",
              "csol", "dz", "zsoi", "zisoi", "h2osoi_liq", "h2osoi_ice",
              "t_soisno"]
    a = {k: _gather(gref, "in_" + k, cases) for k in scalar + arrays}
    a["snl"] = _ints(gref, "in_snl", cases)
    a["frac_veg_nosno"] = torch.as_tensor(
        [float(gref.state(t)["in_frac_veg_nosno"]) for t in cases],
        dtype=torch.float64)
    top = (c.NLEVSNO - a["snl"]).numpy()

    def mask(name, v, want):
        if name == "lhs_matrix":
            want = want.reshape(n, st.NSYS, c.NBAND)
            for i in range(n):
                v[i, :top[i], :] = 0.0
        elif name in ("rhs_presolve", "tvector"):
            for i in range(n):
                v[i, :top[i]] = 0.0
                want[i, :top[i]] = 0.0
        return v, want
    _check(gref, cases, _soil_chain(a), rtol=1e-12, atol=1e-9, mask=mask)


def _synth_tables():
    i = torch.arange(11, dtype=torch.float64)[:, None, None]
    j = torch.arange(31, dtype=torch.float64)[None, :, None]
    k = torch.arange(8, dtype=torch.float64)[None, None, :]
    tau = 100.0 + 3.0 * i + 1.5 * j + 7.0 * k
    kappa = 1.0 + 0.05 * i + 0.01 * j + 0.02 * k
    drdt0 = 1.0 + 0.1 * i + 0.02 * j + 0.05 * k
    return tau + 0.0 * j, kappa + 0.0 * j, drdt0 + 0.0 * j


def _snow_chain(a, tau, kappa, drdt0):
    """``tests/test_snow_hydrology.py::_chain`` through the port."""
    snl = a["snl"]
    mss = {k: a["mss_" + k] for k in SPECIES}
    sw = sh.snow_water(
        LAND, a["do_capsnow"], snl, DTIME, a["frac_sno_eff"], a["h2osno"],
        a["qflx_sub_snow"], a["qflx_evap_grnd"], a["qflx_dew_snow"],
        a["qflx_dew_grnd"], a["qflx_rain_grnd"], a["qflx_snomelt"],
        a["qflx_snow_melt"], a["int_snow"], a["frac_sno"], a["h2osoi_liq"],
        a["h2osoi_ice"], mss, a["dz"])
    keys = ["bcphi", "bcpho", "bcdep", "dst1_1", "dst1_2", "dst2_1",
            "dst2_2", "dst3_1", "dst3_2", "dst4_1", "dst4_2"]
    aero_in = {k: a["aero"][:, i] for i, k in enumerate(keys)}
    mss = sh.compute_aerosol_deposition(DTIME, snl, aero_in, sw.mss)
    bcphi, bcpho = sh.aerosol_phase_change(
        snl, DTIME, a["qflx_sub_snow"], sw.h2osoi_liq, sw.h2osoi_ice,
        mss["bcphi"], mss["bcpho"])
    mss = dict(mss, bcphi=bcphi, bcpho=bcpho)
    qflx_rootsoi = sh.transpiration(a["veg_active"] != 0,
                                    a["qflx_tran_veg"], a["rootr"])
    dz = sh.snow_compaction(LAND, snl, DTIME, sw.int_snow, a["n_melt"],
                            sw.frac_sno, a["imelt"], a["swe_old"],
                            sw.h2osoi_liq, sw.h2osoi_ice, a["t_soisno"],
                            a["frac_iceold"], sw.dz)
    state = sh.SnowState(snl, a["t_soisno"], sw.h2osoi_ice, sw.h2osoi_liq,
                         a["snw_rds"], mss, dz, a["z"], a["zi"])
    cb = sh.combine_layers(LAND, DTIME, state, a["h2osno"], a["snow_depth"],
                           a["frac_sno_eff"], sw.frac_sno, sw.int_snow)
    state = sh.divide_layers(cb.frac_sno, cb.state)
    state = sh.prune_snow_layers(state)
    mss2, cnc = sh.update_aerosol_mass_and_concen(
        DTIME, state.snl, a["do_capsnow"], a["qflx_snwcp_ice"], state.ice,
        state.liq, state.mss)
    snw_rds = sh.snow_aging(
        a["do_capsnow"], state.snl, cb.frac_sno, DTIME, a["qflx_snwcp_ice"],
        a["qflx_snow_grnd"], cb.h2osno, state.dz, state.liq, state.ice,
        state.t, a["qflx_snofrz_lyr"], tau, kappa, drdt0, state.rds)
    out = {
        "snl": state.snl, "h2osno": cb.h2osno, "snow_depth": cb.snow_depth,
        "frac_sno": cb.frac_sno, "frac_sno_eff": cb.frac_sno_eff,
        "int_snow": cb.int_snow, "qflx_snow_melt": sw.qflx_snow_melt,
        "qflx_top_soil": sw.qflx_top_soil,
        "mflx_neg_snow": sw.mflx_neg_snow,
        "qflx_sl_top_soil": cb.qflx_sl_top_soil,
        "qflx_snow2topsoi": cb.qflx_snow2topsoi,
        "mflx_snowlyr_col": cb.mflx_snowlyr_col,
        "h2osoi_liq": state.liq, "h2osoi_ice": state.ice,
        "t_soisno": state.t, "dz": state.dz, "z": state.z, "zi": state.zi,
        "snw_rds": snw_rds, "qflx_rootsoi": qflx_rootsoi,
    }
    for k in SPECIES:
        out["mss_" + k] = mss2[k]
        out["cnc_" + k] = cnc[k]
    return out


def test_snow_hydrology_golden():
    """SnowHydrology_REF.txt at rtol 1e-11 / atol 1e-13
    (test_snow_hydrology.py)."""
    gref = GoldenFile(str(DATA / "SnowHydrology_REF.txt"))
    cases = gref.steps
    scalar = ["frac_sno_eff", "frac_sno", "h2osno", "snow_depth",
              "int_snow", "n_melt", "qflx_sub_snow", "qflx_evap_grnd",
              "qflx_dew_snow", "qflx_dew_grnd", "qflx_rain_grnd",
              "qflx_snomelt", "qflx_snow_melt", "qflx_snwcp_ice",
              "qflx_snow_grnd", "qflx_tran_veg"]
    arrays = ["h2osoi_liq", "h2osoi_ice", "t_soisno", "dz", "z", "zi",
              "snw_rds", "swe_old", "frac_iceold", "qflx_snofrz_lyr",
              "rootr", "aero"] + ["mss_" + k for k in SPECIES]
    a = {k: _gather(gref, "in_" + k, cases) for k in scalar + arrays}
    for k in ("snl", "do_capsnow", "veg_active"):
        a[k] = _ints(gref, "in_" + k, cases)
    a["imelt"] = torch.as_tensor(np.stack(
        [gref.state(t)["in_imelt"] for t in cases]).astype(np.int64))
    _check(gref, cases, _snow_chain(a, *_synth_tables()), rtol=1e-11,
           atol=1e-13)


# ---- init_snow_layers / init_snow_state against the JAX package -------------

# 0, every threshold of the ladder, just above each (but 0, whose
# neighbour is a subnormal, which XLA's CPU flushes to zero and PyTorch
# keeps), and seeded depths
LADDER = [0.0, 0.01, 0.03, 0.04, 0.07, 0.12, 0.18, 0.29, 0.41, 0.64]
DEPTHS = np.concatenate([
    LADDER, np.nextafter(LADDER[1:], 1.0), [0.005, 1.5, 3.0],
    np.random.default_rng(6).uniform(0.0, 1.2, 200)])


@pytest.mark.parametrize("lakpoi", [False, True])
def test_init_snow_layers_matches_jax(lakpoi):
    t = ini.init_snow_layers(torch.as_tensor(DEPTHS), lakpoi)
    j = jini.init_snow_layers(jnp.asarray(DEPTHS), lakpoi)
    assert set(np.asarray(t.snl).tolist()) >= ({0} if lakpoi
                                                else {0, 1, 2, 3, 4, 5})
    for k in t._fields:
        np.testing.assert_allclose(np.asarray(getattr(t, k)),
                                   np.asarray(getattr(j, k)), rtol=1e-10,
                                   atol=0, err_msg=k)


@pytest.mark.parametrize("urbpoi", [False, True])
def test_init_snow_state_matches_jax(urbpoi):
    rng = np.random.default_rng(7)
    depth = DEPTHS.copy()
    h2osno = np.where(rng.random(depth.size) < 0.1, 0.0,
                      depth * rng.uniform(50.0, 450.0, depth.size))
    h2osno[:3] = [0.0, 2.0, 0.5]      # no depth with and without mass
    depth[:3] = 0.0
    snl = np.array(jini.init_snow_layers(jnp.asarray(depth), False).snl)
    land_t = c.LandType(ltype=1, ctype=1, vtype=12, urbpoi=urbpoi)
    land_j = jc.LandType(ltype=1, ctype=1, vtype=12, urbpoi=urbpoi)
    t = ini.init_snow_state(land_t, torch.as_tensor(snl, dtype=torch.int64),
                            torch.as_tensor(depth), torch.as_tensor(h2osno))
    j = jini.init_snow_state(land_j, jnp.asarray(snl), jnp.asarray(depth),
                             jnp.asarray(h2osno))
    for a, b in zip(t, j):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10,
                                   atol=0)
