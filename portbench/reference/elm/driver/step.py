"""The full land-surface water+energy timestep.

Counterpart of ``elmkernels_tpu/driver/step.py``: :func:`advance` composes
the surface phase (forcing/phenology interpolation, init_timestep,
albedo+SNICAR, canopy hydrology, surface radiation, canopy temperature),
the flux phase (bare-ground and canopy Monin-Obukhov iterations with the
photosynthesis root solve) and the column phase (soil/snow temperature
solve, phase change, snow hydrology, surface fluxes, conservation
diagnostics).  Tensors live on the device of the state; on the card the
canopy stability loop (K2, the ci solve inlined), the pentadiagonal solve
(K4) and the snow-hydrology block (K5) are CUDA kernels.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from portbench.reference.elm import constants as c
from portbench.reference.elm.data.state import (AERO_DEP_KEYS, ModelParams,
                                         ModelState, StepForcing,
                                         StepPhenology)
from portbench.reference.elm.physics import (atm_physics as ap, bareground_fluxes as
                                      bg, canopy_fluxes as cfx,
                                      canopy_hydrology as chy,
                                      canopy_temperature as ct,
                                      conservation as ce, init_state as ini,
                                      phenology as ph, photosynthesis as psn,
                                      snow_hydrology as sh, snow_snicar as sn,
                                      soil_temperature as stp,
                                      soil_thermal as sth, solar,
                                      surface_albedo as sa,
                                      surface_fluxes as sf,
                                      surface_radiation as sr)
from portbench.reference.elm.physics.math_utils import take_layer
from portbench.reference.elm.physics.snow_snicar import SnicarTables


class StepDiagnostics(NamedTuple):
    """Per-step fluxes and conservation errors."""
    eflx_sh_tot: torch.Tensor
    eflx_lh_tot: torch.Tensor
    eflx_soil_grnd: torch.Tensor
    eflx_lwrad_out: torch.Tensor
    eflx_lwrad_net: torch.Tensor
    qflx_evap_tot: torch.Tensor
    qflx_tran_veg: torch.Tensor
    qflx_top_soil: torch.Tensor
    qflx_rootsoi: torch.Tensor
    qflx_sl_top_soil: torch.Tensor
    qflx_snow2topsoi: torch.Tensor
    qflx_snwcp_liq: torch.Tensor
    qflx_snwcp_ice: torch.Tensor
    mflx_snowlyr: torch.Tensor
    mflx_neg_snow: torch.Tensor
    fsa: torch.Tensor
    fsr: torch.Tensor
    t_ref2m: torch.Tensor
    errh2o: torch.Tensor
    errh2o_led: torch.Tensor   # closed ledger; ~0 when healthy
    errh2osno: torch.Tensor
    errh2osno_steady: torch.Tensor
    errsol: torch.Tensor
    errlon: torch.Tensor
    errseb: torch.Tensor
    errsoi: torch.Tensor
    netrad: torch.Tensor
    niters_canopy: torch.Tensor  # canopy stability iterations used
    niters_ci: torch.Tensor      # inner ci secant iterations (sun + shade)


class _SurfaceOut(NamedTuple):
    """Boundary between the surface phase and the flux/column phases."""
    forc_t: torch.Tensor
    forc_th: torch.Tensor
    forc_pbot: torch.Tensor
    forc_q: torch.Tensor
    forc_lwrad: torch.Tensor
    forc_rain: torch.Tensor
    forc_snow: torch.Tensor
    forc_u: torch.Tensor
    forc_v: torch.Tensor
    forc_rho: torch.Tensor
    forc_po2: torch.Tensor
    forc_pco2: torch.Tensor
    forc_solad: torch.Tensor
    forc_solai: torch.Tensor
    dayl: torch.Tensor
    max_dayl: torch.Tensor
    elai: torch.Tensor
    esai: torch.Tensor
    htop: torch.Tensor
    frac_veg_nosno: torch.Tensor
    do_capsnow: torch.Tensor
    frac_iceold: torch.Tensor
    swe_old: torch.Tensor
    fwet: torch.Tensor
    fdry: torch.Tensor
    snl: torch.Tensor
    dz: torch.Tensor
    z: torch.Tensor
    zi: torch.Tensor
    snw_rds: torch.Tensor
    h2osoi_liq: torch.Tensor
    h2osoi_ice: torch.Tensor
    t_soisno: torch.Tensor
    snow_depth: torch.Tensor
    h2osno: torch.Tensor
    int_snow: torch.Tensor
    frac_sno: torch.Tensor
    frac_sno_eff: torch.Tensor
    frac_h2osfc: torch.Tensor
    h2osfc: torch.Tensor
    h2ocan: torch.Tensor
    t_grnd: torch.Tensor
    tssbef: torch.Tensor
    t_h2osfc_bef: torch.Tensor
    soilbeta: torch.Tensor
    begwb: torch.Tensor
    h2osno_old: torch.Tensor
    hum: tuple
    gp: tuple
    fhgt: tuple
    can: tuple
    ts: tuple
    sun: tuple
    tot: tuple
    sabg_lyr: torch.Tensor
    fsr_out: torch.Tensor
    gf: tuple


class _FluxOut(NamedTuple):
    """Boundary between the flux phase and the column phase."""
    rootr: torch.Tensor
    cf_stab: tuple
    cf_cf: tuple
    t_veg: torch.Tensor
    h2ocan: torch.Tensor


def cast_floats(tree, dtype):
    """Cast every floating tensor of a (nested) NamedTuple/tuple/dict to
    ``dtype``; other leaves pass through.  The JAX package's ``_to``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast_floats(v, dtype) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    return tree


def advance(land: c.LandType, psnveg: psn.PFTPsnParams,
            albveg: sa.PFTAlbParams, snicar: SnicarTables,
            params: ModelParams, state: ModelState, forcing: StepForcing,
            phen: StepPhenology, dtime: float,
            elm_correct_snow_aging: bool = False,
            psn_mode: str | None = None,
            qbot_is_rh: bool = False,
            mixed_radiation: bool = False,
            elm_correct_seb: bool = False,
            warm_start: bool = False,
            het_ltype: bool = False,
            mixed_canopy: bool = False
            ) -> tuple[ModelState, StepDiagnostics]:
    """One dtime step.  ``forcing``/``phen`` hold tensors on the state's
    device.  ``mixed_radiation`` runs SNICAR and two-stream in f32,
    ``mixed_canopy`` the canopy stability loop, ``warm_start`` seeds the
    canopy/ci solvers from the previous step's obu/ci (the JAX package's
    flags of the same names).

    ``het_ltype=True`` takes each column's landunit type from
    ``params.ltype`` in place of the domain's int ``land.ltype``: every
    landunit branch then selects per column on the device.
    ``elm_correct_snow_aging=True`` ages the snow grains from the
    ``params.snowage_*`` tables with ELM's [SNW_RDS_MIN, SNW_RDS_MAX]
    clamp (:func:`snow_hydrology.snow_aging`) in place of the reference's
    pinned radius."""
    if het_ltype:
        land = dataclasses.replace(land, ltype=params.ltype)
    sfo = surface_phase(land, albveg, snicar, params, state, forcing, phen,
                        dtime, qbot_is_rh=qbot_is_rh,
                        mixed_radiation=mixed_radiation)
    fl = flux_phase(land, psnveg, params, state, sfo, dtime,
                    psn_mode=psn_mode, warm_start=warm_start,
                    mixed_canopy=mixed_canopy)
    return column_phase(land, params, state, forcing, sfo, fl, dtime,
                        elm_correct_snow_aging=elm_correct_snow_aging,
                        elm_correct_seb=elm_correct_seb)


def surface_phase(land: c.LandType, albveg: sa.PFTAlbParams,
                  snicar: SnicarTables, params: ModelParams,
                  state: ModelState, forcing: StepForcing,
                  phen: StepPhenology, dtime: float,
                  qbot_is_rh: bool = False,
                  mixed_radiation: bool = False) -> _SurfaceOut:
    """Forcing/phenology interp + init_timestep + albedo/SNICAR + canopy
    hydrology + surface radiation + canopy temperature."""
    s = state
    p = params
    dewmx = 0.1       # elm_kokkos_interface.cc:99
    oldfflag = 1      # elm_kokkos_interface.cc:101
    veg_active = torch.ones_like(s.snl, dtype=torch.bool)

    # ---- init_timestep: phenology ----
    phout = ph.compute_phenology(
        phen.mlai[0], phen.mlai[1], phen.msai[0], phen.msai[1],
        phen.mhtop[0], phen.mhtop[1], phen.mhbot[0], phen.mhbot[1],
        s.snow_depth, s.frac_sno, p.vtype, phen.wt1, phen.wt2)
    elai, esai = phout.elai, phout.esai
    htop = phout.htop
    tlai, tsai = phout.tlai, phout.tsai

    # ---- atm forcing interpolation ----
    forc_t, forc_th = ap.process_tbot(forcing.wt1, forcing.wt2,
                                      forcing.tbot[0], forcing.tbot[1])
    forc_pbot = ap.process_pbot(forcing.wt1, forcing.wt2, forcing.pbot[0],
                                forcing.pbot[1])
    forc_q = ap.process_qbot(forcing.wt1, forcing.wt2, forcing.qbot[0],
                             forcing.qbot[1], forc_t, forc_pbot,
                             is_rh=qbot_is_rh)
    forc_lwrad = ap.process_flds(forcing.wt1, forcing.wt2, forcing.flds[0],
                                 forcing.flds[1], forc_pbot, forc_q, forc_t)
    # solar geometry on the device
    coszen = solar.average_cosz(p.lat_r, p.lon_r, dtime, forcing.decday)
    decl = solar.declination_angle_sin(torch.floor(forcing.decday))
    dayl = solar.daylength(p.lat_r, decl)
    max_dayl = solar.max_daylength(p.lat_r)

    sol = ap.process_fsds(forcing.fsds, coszen)
    forc_solad, forc_solai = sol.forc_solad, sol.forc_solai
    forc_rain, forc_snow = ap.process_prec(forcing.prec, forc_t)
    forc_u, _ = ap.process_wind(forcing.wt1, forcing.wt2,
                                forcing.wind[0], forcing.wind[1])
    forc_v = torch.zeros_like(forc_u)
    forc_hgt, forc_hgt_u, forc_hgt_t, forc_hgt_q = ap.process_zbot(
        s.snl.shape[0], forc_t.dtype, forc_t.device)
    forc_rho = ap.derive_forc_rho(forc_pbot, forc_q, forc_t)
    forc_po2 = ap.derive_forc_po2(forc_pbot)
    forc_pco2 = ap.derive_forc_pco2(forc_pbot)

    h2osno_old = s.h2osno
    begwb = ce.column_water_mass_tracked(s.h2ocan, s.h2osno, s.h2osfc,
                                         s.h2osoi_ice, s.h2osoi_liq)
    it = ini.init_timestep(land, veg_active, phout.frac_veg_nosno_alb,
                           s.snl, s.h2osno, s.h2osoi_ice, s.h2osoi_liq,
                           torch.zeros_like(s.snw_rds))
    do_capsnow = it.do_capsnow
    frac_veg_nosno = it.frac_veg_nosno
    frac_iceold = torch.cat(
        [it.frac_iceold, torch.zeros_like(s.h2osoi_liq[:, c.NLEVSNO:])],
        dim=1)

    # ---- fraction_wet ----
    fw = chy.fraction_wet(land, frac_veg_nosno, dewmx, elai, esai, s.h2ocan)
    fwet, fdry = fw.fwet, fw.fdry

    # ---- albedo + SNICAR ----
    sa_init = sa.init_timestep(land, elai, s.cnc_bcphi, s.cnc_bcpho,
                               s.cnc_dst1, s.cnc_dst2, s.cnc_dst3,
                               s.cnc_dst4)
    soil_alb = sa.soil_albedo(land, s.snl, s.t_grnd, coszen, s.h2osoi_vol,
                              p.albsat, p.albdry)

    # mixed precision: SNICAR and the two-stream solver in f32, results
    # handed back to the working dtype (errsol ~1e-6 W/m2 instead of
    # 1e-13; the water ledger stays exact)
    wdt = coszen.dtype
    mixed = mixed_radiation and wdt == torch.float64
    if mixed:
        f32 = torch.float32
        drc, dfs = sn.snicar_ad_rt_both(
            land, *cast_floats((coszen, s.h2osno), f32), s.snl,
            *cast_floats((s.h2osoi_liq, s.h2osoi_ice, s.snw_rds,
                          soil_alb.albsoi, sa_init.mss_cnc_aer_in_fdb,
                          snicar), f32), weight_dtype=wdt)
        drc, dfs = cast_floats((drc, dfs), wdt)
    else:
        drc, dfs = sn.snicar_ad_rt_both(
            land, coszen, s.h2osno, s.snl, s.h2osoi_liq, s.h2osoi_ice,
            s.snw_rds, soil_alb.albsoi, sa_init.mss_cnc_aer_in_fdb, snicar,
            weight_dtype=wdt)
    grd = sa.ground_albedo(land, coszen, s.frac_sno, soil_alb.albsod,
                           soil_alb.albsoi, drc.albout, dfs.albout)
    fab = sa.flux_absorption_factor(land, coszen, s.frac_sno,
                                    soil_alb.albsod, soil_alb.albsoi,
                                    drc.albout, dfs.albout, drc.flx_abs,
                                    dfs.flx_abs)
    can = sa.canopy_layer_lai(land, elai, esai, tlai, tsai)
    if mixed:
        ts = sa.two_stream_solver(
            land, can.nrad, *cast_floats((coszen, s.t_veg, fwet, elai, esai,
                                          can.tlai_z, can.tsai_z, grd.albgrd,
                                          grd.albgri, albveg,
                                          sa_init.vcmaxcintsun,
                                          sa_init.vcmaxcintsha),
                                         torch.float32))
        ts = cast_floats(ts, wdt)
    else:
        ts = sa.two_stream_solver(land, can.nrad, coszen, s.t_veg, fwet,
                                  elai, esai, can.tlai_z, can.tsai_z,
                                  grd.albgrd, grd.albgri, albveg,
                                  sa_init.vcmaxcintsun,
                                  sa_init.vcmaxcintsha)

    # ---- canopy_hydrology ----
    inter = chy.interception(land, frac_veg_nosno, forc_rain, forc_snow,
                             dewmx, elai, esai, dtime, s.h2ocan)
    h2ocan = inter.h2ocan
    gf = chy.ground_flux(land, do_capsnow, frac_veg_nosno, forc_rain,
                         forc_snow, torch.zeros_like(forc_rain),
                         inter.qflx_candrip, inter.qflx_through_snow,
                         inter.qflx_through_rain, inter.fracsnow,
                         inter.fracrain)
    si = chy.snow_init(land, dtime, do_capsnow, oldfflag, forc_t, s.t_grnd,
                       gf.qflx_snow_grnd, s.qflx_snow_melt, p.n_melt,
                       s.snow_depth, s.h2osno, s.int_snow, s.h2osoi_liq,
                       s.h2osoi_ice, s.t_soisno, frac_iceold, s.snl, s.dz,
                       s.z, s.zi, s.snw_rds, s.frac_sno_eff, s.frac_sno)
    fh = chy.fraction_h2osfc(land, p.micro_sigma, si.h2osno, s.h2osfc,
                             si.h2osoi_liq, si.frac_sno, si.frac_sno_eff)
    snl = si.snl
    h2osoi_liq, h2osoi_ice = fh.h2osoi_liq, si.h2osoi_ice
    t_soisno = si.t_soisno
    dz, z, zi = si.dz, si.z, si.zi
    snw_rds = si.snw_rds
    snow_depth, h2osno, int_snow = si.snow_depth, si.h2osno, si.int_snow
    frac_sno, frac_sno_eff = fh.frac_sno, fh.frac_sno_eff
    frac_h2osfc, h2osfc = fh.frac_h2osfc, fh.h2osfc
    swe_old = si.swe_old
    frac_iceold = si.frac_iceold

    # ---- surface_radiation ----
    tot = sr.total_absorbed_radiation(
        land, snl, ts.ftdd, ts.ftid, ts.ftii, forc_solad, forc_solai,
        ts.fabd, ts.fabi, soil_alb.albsod, soil_alb.albsoi, drc.albout,
        dfs.albout, grd.albgrd, grd.albgri)
    sabg_lyr = sr.layer_absorbed_radiation(
        land, snl, tot.sabg, tot.sabg_snow, snow_depth, fab.flx_absdv,
        fab.flx_absdn, fab.flx_absiv, fab.flx_absin, tot.trd, tot.tri)
    fsr_out = sr.reflected_radiation(land, ts.albd, ts.albi, forc_solad,
                                     forc_solai)
    sun = sr.canopy_sunshade_fractions(land, can.nrad, elai, can.tlai_z,
                                       ts.fsun_z, forc_solad, forc_solai,
                                       ts.fabd_sun_z, ts.fabd_sha_z,
                                       ts.fabi_sun_z, ts.fabi_sha_z)

    # ---- canopy_temperature ----
    old = ct.old_ground_temp(land, s.t_h2osfc, t_soisno)
    tssbef, t_h2osfc_bef = old.tssbef, old.t_h2osfc_bef
    t_grnd = ct.ground_temp(land, snl, frac_sno_eff, frac_h2osfc,
                            s.t_h2osfc, t_soisno)
    salpha = ct.calc_soilalpha(land, frac_sno, frac_h2osfc, h2osoi_liq,
                               h2osoi_ice, dz, t_soisno, p.watsat, p.sucsat,
                               p.bsw)
    soilbeta = ct.calc_soilbeta(land, frac_sno, frac_h2osfc, p.watsat,
                                p.watfc, h2osoi_liq, h2osoi_ice, dz)
    hum = ct.humidities(land, snl, forc_q, forc_pbot, s.t_h2osfc, t_grnd,
                        frac_sno, frac_sno_eff, frac_h2osfc, salpha.qred,
                        salpha.hr, t_soisno)
    gp = ct.ground_properties(
        land, snl, frac_sno, forc_th, forc_q, elai, esai, htop,
        p.displar_v, p.z0mr_v, h2osoi_liq, h2osoi_ice)
    fhgt = ct.forcing_height(land, veg_active, frac_veg_nosno, gp.z0m,
                             gp.z0mg, forc_t, gp.displa, forc_hgt_u,
                             forc_hgt_t, forc_hgt_q)

    return _SurfaceOut(
        forc_t=forc_t, forc_th=forc_th, forc_pbot=forc_pbot, forc_q=forc_q,
        forc_lwrad=forc_lwrad, forc_rain=forc_rain, forc_snow=forc_snow,
        forc_u=forc_u, forc_v=forc_v, forc_rho=forc_rho, forc_po2=forc_po2,
        forc_pco2=forc_pco2, forc_solad=forc_solad, forc_solai=forc_solai,
        dayl=dayl, max_dayl=max_dayl, elai=elai, esai=esai, htop=htop,
        frac_veg_nosno=frac_veg_nosno, do_capsnow=do_capsnow,
        frac_iceold=frac_iceold, swe_old=swe_old, fwet=fwet, fdry=fdry,
        snl=snl, dz=dz, z=z, zi=zi, snw_rds=snw_rds,
        h2osoi_liq=h2osoi_liq, h2osoi_ice=h2osoi_ice, t_soisno=t_soisno,
        snow_depth=snow_depth, h2osno=h2osno, int_snow=int_snow,
        frac_sno=frac_sno, frac_sno_eff=frac_sno_eff,
        frac_h2osfc=frac_h2osfc, h2osfc=h2osfc, h2ocan=h2ocan,
        t_grnd=t_grnd, tssbef=tssbef, t_h2osfc_bef=t_h2osfc_bef,
        soilbeta=soilbeta, begwb=begwb, h2osno_old=h2osno_old,
        hum=hum, gp=gp, fhgt=fhgt, can=can, ts=ts, sun=sun, tot=tot,
        sabg_lyr=sabg_lyr, fsr_out=fsr_out, gf=gf)


def flux_phase(land: c.LandType, psnveg: psn.PFTPsnParams,
               params: ModelParams, state: ModelState, sfo: _SurfaceOut,
               dtime: float, psn_mode: str | None = None,
               warm_start: bool = False,
               mixed_canopy: bool = False) -> _FluxOut:
    """Bare-ground + canopy Monin-Obukhov flux iterations (the
    photosynthesis-bearing loops)."""
    s = state
    p = params
    hum, gp, fhgt, can, sun, tot, ts = (sfo.hum, sfo.gp, sfo.fhgt, sfo.can,
                                        sfo.sun, sfo.tot, sfo.ts)
    thm = fhgt.thm
    soybean = (p.vtype == c.NSOYBEAN) | (p.vtype == c.NSOYBEANIRRIG)
    altmax_indx = torch.full_like(s.snl, 5)
    altmax_lastyear_indx = torch.zeros_like(s.snl)

    # ---- bareground_fluxes ----
    zero = torch.zeros_like(sfo.forc_t)
    bg_init = bg.initialize_flux(
        land, sfo.frac_veg_nosno, sfo.forc_u, sfo.forc_v, sfo.forc_q,
        sfo.forc_th, fhgt.forc_hgt_u_patch, thm, gp.thv, sfo.t_grnd, hum.qg,
        gp.z0mg, zero, zero, zero, zero, zero, zero, zero, zero, zero)
    bg_stab = bg.stability_iteration(
        land, sfo.frac_veg_nosno, fhgt.forc_hgt_t_patch,
        fhgt.forc_hgt_u_patch, fhgt.forc_hgt_q_patch, gp.z0mg,
        bg_init.zldis, bg_init.displa, bg_init.dth, bg_init.dqh, bg_init.ur,
        sfo.forc_q, sfo.forc_th, gp.thv, gp.z0hg, gp.z0qg, bg_init.obu,
        bg_init.um, zero, zero, zero, zero, zero)
    bg_cf = bg.compute_flux(
        land, sfo.frac_veg_nosno, sfo.snl, sfo.forc_rho, sfo.soilbeta,
        hum.dqgdT, gp.htvp, s.t_h2osfc, hum.qg_snow, hum.qg_soil,
        hum.qg_h2osfc, sfo.t_soisno, sfo.forc_pbot, bg_init.dth, bg_init.dqh,
        bg_stab.temp1, bg_stab.temp2, bg_stab.temp12m, bg_stab.temp22m,
        bg_stab.ustar, sfo.forc_q, thm, zero, zero, zero, zero, zero, zero,
        zero, zero, zero, zero, zero, zero, zero)

    # ---- canopy_fluxes ----
    cf_init = cfx.initialize_flux(
        land, psnveg, sfo.snl, sfo.frac_veg_nosno, sfo.frac_sno,
        fhgt.forc_hgt_u_patch, thm, gp.thv, sfo.max_dayl, sfo.dayl,
        altmax_indx, altmax_lastyear_indx, sfo.t_soisno, sfo.h2osoi_ice,
        sfo.h2osoi_liq, sfo.dz, p.rootfr, p.sucsat, p.watsat, p.bsw,
        sfo.elai, sfo.esai, gp.emv, gp.emg, hum.qg, sfo.t_grnd, sfo.forc_t,
        sfo.forc_pbot, sfo.forc_lwrad, sfo.forc_u, sfo.forc_v, sfo.forc_q,
        sfo.forc_th, gp.z0mg, gp.displa, gp.z0mv, s.t_veg)
    obu0, ci_prev = cf_init.obu, None
    if warm_start:
        # previous-step converged Monin-Obukhov length / ci roots seed
        # the stability and photosynthesis solvers (0 = cold column)
        ok = (s.obu_can != 0.0) & torch.isfinite(s.obu_can)
        obu0 = torch.where(ok, s.obu_can, cf_init.obu)
        ci_prev = torch.cat([s.ci_sun, s.ci_sha])

    # mixed_canopy: the stability-loop interior in f32, converged fluxes
    # and t_veg handed back to the working dtype
    wdt = sfo.t_grnd.dtype
    stab_args = (psnveg, sfo.frac_sno,
                 fhgt.forc_hgt_u_patch, fhgt.forc_hgt_t_patch,
                 fhgt.forc_hgt_q_patch, sfo.fwet, sfo.fdry, sun.laisun,
                 sun.laisha, sfo.forc_rho, sfo.snow_depth, sfo.soilbeta,
                 sfo.frac_h2osfc, s.t_h2osfc, tot.sabv, sfo.h2ocan, sfo.htop,
                 sfo.t_soisno, cf_init.air, cf_init.bir, cf_init.cir,
                 cf_init.ur, cf_init.zldis, cf_init.displa, sfo.elai,
                 sfo.esai, sfo.t_grnd, sfo.forc_pbot, sfo.forc_q, sfo.forc_th,
                 gp.z0mg, cf_init.z0mv, cf_init.z0hv, cf_init.z0qv, thm,
                 gp.thv, hum.qg, s.t10, can.tlai_z, ts.vcmaxcintsha,
                 ts.vcmaxcintsun, sun.parsha_z, sun.parsun_z, sun.laisha_z,
                 sun.laisun_z, sfo.forc_pco2, sfo.forc_po2,
                 cf_init.dayl_factor, cf_init.btran, cf_init.el,
                 cf_init.qsatl, cf_init.qsatldT, cf_init.taf, cf_init.qaf,
                 cf_init.um, obu0, cf_init.delq, cf_init.t_veg, ci_prev)
    mixed = mixed_canopy and wdt == torch.float64
    if mixed:
        stab_args = cast_floats(stab_args, torch.float32)
    (pv2, frac_sno2, hgt_u2, hgt_t2, hgt_q2, fwet2, fdry2, laisun2,
     laisha2, rho2, sd2, beta2, fh2o2, th2o2, sabv2, h2ocan2, htop2,
     tsoi2, air2, bir2, cir2, ur2, zldis2, displa2, elai2, esai2, tg2,
     pbot2, q2, th2, z0mg2, z0mv2, z0hv2, z0qv2, thm2, thv2, qg2, t102,
     tlaiz2, vcsha2, vcsun2, parsha2, parsun2, lshaz2, lsunz2, pco22,
     po22, daylf2, btran2, el2, qsatl2, qsatldT2, taf2, qaf2, um2, obu2,
     delq2, tveg02, ci_prev2) = stab_args
    cf_stab = cfx.stability_iteration(
        land, pv2, dtime, sfo.snl, sfo.frac_veg_nosno, frac_sno2,
        hgt_u2, hgt_t2, hgt_q2, fwet2, fdry2, laisun2, laisha2,
        rho2, sd2, beta2, fh2o2, th2o2, sabv2,
        h2ocan2, htop2, tsoi2, air2, bir2, cir2,
        ur2, zldis2, displa2, elai2, esai2, tg2,
        pbot2, q2, th2, z0mg2, z0mv2, z0hv2,
        z0qv2, thm2, thv2, qg2, can.nrad, t102, tlaiz2,
        vcsha2, vcsun2, parsha2, parsun2,
        lshaz2, lsunz2, pco22, po22,
        daylf2, btran2, el2, qsatl2,
        qsatldT2, taf2, qaf2, um2, obu2,
        delq2, tveg02, psn_mode=psn_mode, soybean=soybean,
        warm_start=warm_start, ci_prev=ci_prev2)
    if mixed:
        cf_stab = cast_floats(cf_stab, wdt)
    cf_cf = cfx.compute_flux(
        land, dtime, sfo.snl, sfo.frac_veg_nosno, sfo.frac_sno,
        sfo.t_soisno, sfo.frac_h2osfc, s.t_h2osfc, tot.sabv, hum.qg_snow,
        hum.qg_soil, hum.qg_h2osfc, hum.dqgdT, gp.htvp, cf_stab.wtg,
        cf_stab.wtl0, cf_stab.wta0, cf_stab.wtal, cf_init.air, cf_init.bir,
        cf_init.cir, cf_stab.qsatl, cf_stab.qsatldT, cf_stab.dth,
        cf_stab.dqh, cf_stab.temp1, cf_stab.temp2, cf_stab.temp12m,
        cf_stab.temp22m, cf_stab.tlbef, cf_stab.delq, cf_stab.dt_veg,
        cf_stab.t_veg, sfo.t_grnd, sfo.forc_pbot, cf_stab.qflx_tran_veg,
        cf_stab.qflx_evap_veg, cf_stab.eflx_sh_veg, sfo.forc_q, sfo.forc_rho,
        thm, gp.emv, gp.emg, sfo.forc_lwrad, cf_stab.wtgq, cf_stab.wtalq,
        cf_stab.wtlq0, cf_stab.wtaq0, sfo.h2ocan, bg_cf.eflx_sh_grnd,
        bg_cf.eflx_sh_snow, bg_cf.eflx_sh_soil, bg_cf.eflx_sh_h2osfc,
        bg_cf.qflx_evap_soi, bg_cf.qflx_ev_snow, bg_cf.qflx_ev_soil,
        bg_cf.qflx_ev_h2osfc, bg_init.dlrad, bg_init.ulrad, bg_cf.t_ref2m,
        bg_cf.q_ref2m, bg_cf.rh_ref2m)
    return _FluxOut(rootr=cf_init.rootr, cf_stab=cf_stab, cf_cf=cf_cf,
                    t_veg=cf_stab.t_veg, h2ocan=cf_cf.h2ocan)


def column_phase(land: c.LandType, params: ModelParams, state: ModelState,
                 forcing: StepForcing, sfo: _SurfaceOut, fl: _FluxOut,
                 dtime: float, elm_correct_snow_aging: bool = False,
                 elm_correct_seb: bool = False
                 ) -> tuple[ModelState, StepDiagnostics]:
    """Soil/snow temperature solve + phase change, snow hydrology, surface
    flux finalization, conservation diagnostics, state assembly.  Of
    ``forcing`` it reads only ``aero``, the monthly deposition rates."""
    s = state
    p = params
    snl, dz, z, zi = sfo.snl, sfo.dz, sfo.z, sfo.zi
    h2osoi_liq, h2osoi_ice, t_soisno = (sfo.h2osoi_liq, sfo.h2osoi_ice,
                                        sfo.t_soisno)
    snow_depth, h2osno, int_snow = sfo.snow_depth, sfo.h2osno, sfo.int_snow
    frac_sno, frac_sno_eff = sfo.frac_sno, sfo.frac_sno_eff
    frac_h2osfc, h2osfc, t_grnd = sfo.frac_h2osfc, sfo.h2osfc, sfo.t_grnd
    tssbef, t_h2osfc_bef = sfo.tssbef, sfo.t_h2osfc_bef
    forc_lwrad, forc_rain, forc_snow = (sfo.forc_lwrad, sfo.forc_rain,
                                        sfo.forc_snow)
    frac_veg_nosno, do_capsnow, gp, tot, gf = (sfo.frac_veg_nosno,
                                               sfo.do_capsnow, sfo.gp,
                                               sfo.tot, sfo.gf)
    cf_stab, cf_cf = fl.cf_stab, fl.cf_cf
    veg_active = torch.ones_like(s.snl, dtype=torch.bool)

    # ---- soil_temperature (7-stage chain) ----
    props = sth.thermal_properties(land, snl, frac_sno, frac_h2osfc,
                                   h2osno, h2osfc, h2osoi_liq, h2osoi_ice,
                                   t_soisno, dz, z, zi, p.watsat, p.tkmg,
                                   p.tkdry, p.csol)
    snotop = c.NLEVSNO - snl
    sabg_lyr_top = take_layer(sfo.sabg_lyr, snotop)
    t_top_sno = take_layer(t_soisno, snotop)
    sabg_chk = stp.check_absorbed_solar(frac_sno_eff, tot.sabg_snow,
                                        tot.sabg_soil)
    hs_soil = stp.calc_surface_heat_flux(
        frac_veg_nosno, cf_cf.dlrad, gp.emg, forc_lwrad, gp.htvp,
        tot.sabg_soil, t_soisno[:, c.NLEVSNO], cf_cf.eflx_sh_soil,
        cf_cf.qflx_ev_soil)
    hs_h2osfc = stp.calc_surface_heat_flux(
        frac_veg_nosno, cf_cf.dlrad, gp.emg, forc_lwrad, gp.htvp,
        tot.sabg_soil, s.t_h2osfc, cf_cf.eflx_sh_h2osfc,
        cf_cf.qflx_ev_h2osfc)
    hs_top_snow = stp.calc_surface_heat_flux(
        frac_veg_nosno, cf_cf.dlrad, gp.emg, forc_lwrad, gp.htvp,
        sabg_lyr_top, t_top_sno, cf_cf.eflx_sh_snow, cf_cf.qflx_ev_snow)
    dhsdT = stp.calc_dhsdT(cf_cf.cgrnd, gp.emg, t_grnd)

    fn = stp.calc_diffusive_heat_flux(snl, props.tk, t_soisno, z)
    fact = stp.calc_heat_flux_matrix_factor(snl, dtime, props.cv, dz, z, zi)
    lhs, rhs = stp._assemble_system(
        snl, dtime, dhsdT, frac_sno_eff, frac_h2osfc, props.dz_h2osfc,
        props.c_h2osfc, props.tk_h2osfc, z, fact, props.tk, hs_top_snow,
        hs_soil, hs_h2osfc, t_soisno, s.t_h2osfc, fn, sfo.sabg_lyr)
    tvec = stp.pdma_solve(lhs, rhs)
    upd = stp.update_temperature(snl, frac_h2osfc, tvec, t_soisno)

    pc1 = stp.phase_change_h2osfc(
        snl, dtime, frac_sno, frac_h2osfc, dhsdT, props.c_h2osfc,
        fact[:, c.NLEVSNO - 1], upd.t_h2osfc, h2osfc, h2osno, int_snow,
        snow_depth, h2osoi_ice[:, c.NLEVSNO - 1],
        upd.t_soisno[:, c.NLEVSNO - 1])
    ice_a = h2osoi_ice.clone()
    ice_a[:, c.NLEVSNO - 1] = pc1.h2osoi_ice_sl1
    t_a = upd.t_soisno.clone()
    t_a[:, c.NLEVSNO - 1] = pc1.t_soisno_sl1
    pc2 = stp.phase_change_soisno(
        land, snl, dtime, dhsdT, frac_h2osfc, frac_sno_eff, fact, p.watsat,
        p.sucsat, p.bsw, dz, pc1.h2osno, pc1.snow_depth, ice_a, h2osoi_liq,
        t_a)
    t_soisno = pc2.t_soisno
    h2osoi_ice, h2osoi_liq = pc2.h2osoi_ice, pc2.h2osoi_liq
    h2osno, snow_depth = pc2.h2osno, pc2.snow_depth
    h2osfc, int_snow = pc1.h2osfc, pc1.int_snow
    t_h2osfc = pc1.t_h2osfc
    t_grnd = stp.update_t_grnd(snl, frac_h2osfc, frac_sno_eff, t_h2osfc,
                               t_soisno)

    # ---- snow_hydrology ----
    snl_sw, fse_sw = snl, frac_sno_eff  # inputs snow_water acts with
    # deposition rates: monthly-interpolated (StepForcing.aero) when a
    # deposition climatology is wired, else the static params
    if forcing.aero is None:
        aero_in = p.aero_in
    else:
        aero_in = {k: forcing.aero[i] for i, k in enumerate(AERO_DEP_KEYS)}
    qflx_rootsoi = sh.transpiration(veg_active, cf_stab.qflx_tran_veg,
                                    fl.rootr)
    # percolation, compaction, combine, divide, prune, aerosol
    # concentrations and aging: K5 on the card
    sb = sh.snow_hydrology_block(
        land, dtime, do_capsnow, snl, frac_sno_eff, frac_sno, h2osno,
        snow_depth, int_snow, s.qflx_sub_snow, s.qflx_evap_grnd,
        s.qflx_dew_snow, s.qflx_dew_grnd, gf.qflx_rain_grnd,
        pc2.qflx_snomelt, pc2.qflx_snow_melt, h2osoi_liq, h2osoi_ice,
        t_soisno, dz, z, zi, s.mss, aero_in, p.n_melt, pc2.imelt,
        sfo.swe_old, sfo.frac_iceold, sfo.snw_rds, gf.qflx_snwcp_ice,
        gf.qflx_snow_grnd, pc2.qflx_snofrz_lyr, p.snowage_tau,
        p.snowage_kappa, p.snowage_drdt0,
        elm_correct_snow_aging=elm_correct_snow_aging)
    mss2, cnc, snw_rds = sb.mss, sb.cnc, sb.snw_rds
    snl, t_soisno = sb.snl, sb.t_soisno
    h2osoi_ice, h2osoi_liq = sb.h2osoi_ice, sb.h2osoi_liq
    dz, z, zi = sb.dz, sb.z, sb.zi
    h2osno, snow_depth = sb.h2osno, sb.snow_depth
    frac_sno, frac_sno_eff = sb.frac_sno, sb.frac_sno_eff
    int_snow = sb.int_snow
    qflx_snow_melt = sb.qflx_snow_melt

    # ---- surface_fluxes ----
    snotop2 = c.NLEVSNO - snl
    tssbef_snotop = take_layer(tssbef, snotop2)
    tssbef_soitop = tssbef[:, c.NLEVSNO]
    sfi = sf.initial_flux_calc(
        land, snl, frac_sno_eff, frac_h2osfc, t_h2osfc_bef, tssbef_snotop,
        tssbef_soitop, t_grnd, cf_cf.cgrnds, cf_cf.cgrndl,
        cf_cf.eflx_sh_grnd, cf_cf.qflx_evap_soi, cf_cf.qflx_ev_snow,
        cf_cf.qflx_ev_soil, cf_cf.qflx_ev_h2osfc)
    ice_snotop = take_layer(h2osoi_ice, snotop2)
    liq_soitop = h2osoi_liq[:, c.NLEVSNO]  # reference reads soil-top liq
    sfu = sf.update_surface_fluxes(
        land, do_capsnow, snl, dtime, t_grnd, gp.htvp, frac_sno_eff,
        frac_h2osfc, t_h2osfc_bef, tot.sabg_soil, tot.sabg_snow,
        cf_cf.dlrad, frac_veg_nosno.to(sfo.forc_t.dtype), gp.emg,
        forc_lwrad, tssbef_snotop, tssbef_soitop, ice_snotop, liq_soitop,
        cf_stab.eflx_sh_veg, cf_stab.qflx_evap_veg, sfi.qflx_evap_soi,
        sfi.eflx_sh_grnd, sfi.qflx_ev_snow, sfi.qflx_ev_soil,
        sfi.qflx_ev_h2osfc, gf.qflx_snwcp_liq, gf.qflx_snwcp_ice,
        elm_correct_seb=elm_correct_seb)
    lw = sf.lwrad_outgoing(
        land, snl, frac_veg_nosno, forc_lwrad, frac_sno_eff, tssbef_snotop,
        tssbef_soitop, frac_h2osfc, t_h2osfc_bef, t_grnd, cf_cf.ulrad,
        gp.emg)
    errsoi = sf.soil_energy_balance(
        land, snl, sfu.eflx_soil_grnd, pc2.xmf, pc1.xmf_h2osfc,
        frac_h2osfc, t_h2osfc, t_h2osfc_bef, dtime,
        pc1.eflx_h2osfc_to_snow, frac_sno_eff, t_soisno, tssbef, fact)

    # ---- conservation ----
    endwb = ce.column_water_mass_tracked(fl.h2ocan, h2osno, h2osfc,
                                         h2osoi_ice, h2osoi_liq)
    errh2o = ce.column_water_balance_error(
        sfo.begwb, endwb, torch.zeros_like(sfo.begwb), forc_rain, forc_snow,
        sfu.qflx_evap_tot, sfu.qflx_snwcp_ice, dtime)
    errh2osno = ce.snow_water_balance_error(
        snl, sfu.qflx_dew_snow, sfu.qflx_dew_grnd, sfu.qflx_sub_snow,
        sfu.qflx_evap_grnd, qflx_snow_melt, sfu.qflx_snwcp_ice,
        sfu.qflx_snwcp_liq, sb.qflx_sl_top_soil, frac_sno_eff,
        gf.qflx_rain_grnd, gf.qflx_snow_grnd, pc1.qflx_h2osfc_to_ice,
        h2osno, sfo.h2osno_old, dtime, do_capsnow)
    # the snow balance re-timed to the fluxes snow_water applied: the
    # PREVIOUS step's partition weighted by the pre-hydrology fse_sw, and
    # ground_flux's snow-cap diversion (see the JAX package's step.py)
    errh2osno_app = ce.snow_water_balance_error(
        snl, s.qflx_dew_snow, s.qflx_dew_grnd, s.qflx_sub_snow,
        s.qflx_evap_grnd, qflx_snow_melt, gf.qflx_snwcp_ice,
        gf.qflx_snwcp_liq, sb.qflx_sl_top_soil, fse_sw,
        gf.qflx_rain_grnd, gf.qflx_snow_grnd, pc1.qflx_h2osfc_to_ice,
        h2osno, sfo.h2osno_old, dtime, do_capsnow)
    # the negative-liquid walk's pack export is a source term
    errh2osno_app = errh2osno_app + torch.where(
        snl > 0, sb.mflx_neg_snow * dtime, 0.0)
    # layer-count transitions are accounting events: steady steps balance
    errh2osno_steady = torch.where(snl == s.snl, errh2osno_app, 0.0)
    # closed water ledger: re-charge the terms the stores were actually
    # debited with (lagged ground partition, canopy evap - tran, exports)
    capb = do_capsnow != 0
    ice_appl = torch.where(capb, fse_sw * s.qflx_sub_snow,
                           fse_sw * (s.qflx_sub_snow - s.qflx_dew_snow))
    # rain enters the re-charge only for a layerless pack (snow_water
    # stores fse*rain in the top soil row AND exports the full rain)
    rain_led = torch.where(snl_sw == 0, gf.qflx_rain_grnd, 0.0)
    liq_appl = torch.where(capb, fse_sw * s.qflx_evap_grnd,
                           fse_sw * (s.qflx_evap_grnd - s.qflx_dew_grnd
                                     - rain_led))
    canopy_appl = cf_stab.qflx_evap_veg - cf_stab.qflx_tran_veg
    out_applied = (ice_appl + liq_appl + canopy_appl + sb.qflx_top_soil
                   + sfu.qflx_snwcp_liq + sfu.qflx_snwcp_ice
                   + sb.mflx_neg_snow)
    errh2o_led = errh2o - (sfu.qflx_evap_tot + sfu.qflx_snwcp_ice
                           - out_applied) * dtime

    errsol = ce.solar_shortwave_balance_error(tot.fsa, sfo.fsr_out,
                                              sfo.forc_solad,
                                              sfo.forc_solai)
    errlon = ce.solar_longwave_balance_error(lw.eflx_lwrad_out,
                                             lw.eflx_lwrad_net, forc_lwrad)
    errseb = ce.surface_energy_balance_error(
        tot.sabv, sabg_chk, forc_lwrad, lw.eflx_lwrad_out, sfu.eflx_sh_tot,
        sfu.eflx_lh_tot, sfu.eflx_soil_grnd)
    netrad = ce.net_radiation(tot.fsa, lw.eflx_lwrad_net)

    ncol = s.snl.shape[0]
    new_state = s._replace(
        snl=snl, snow_depth=snow_depth, frac_sno=frac_sno,
        frac_sno_eff=frac_sno_eff, int_snow=int_snow, h2osno=h2osno,
        snw_rds=snw_rds, h2ocan=fl.h2ocan, h2osfc=h2osfc,
        frac_h2osfc=frac_h2osfc, h2osoi_liq=h2osoi_liq,
        h2osoi_ice=h2osoi_ice, t_soisno=t_soisno, t_grnd=t_grnd,
        t_h2osfc=t_h2osfc, t_veg=fl.t_veg, dz=dz, z=z, zi=zi,
        qflx_snow_melt=qflx_snow_melt, qflx_sub_snow=sfu.qflx_sub_snow,
        qflx_evap_grnd=sfu.qflx_evap_grnd, qflx_dew_snow=sfu.qflx_dew_snow,
        qflx_dew_grnd=sfu.qflx_dew_grnd,
        ci_sun=cf_stab.ci[:ncol], ci_sha=cf_stab.ci[ncol:],
        obu_can=cf_stab.obu,
        **{"mss_" + k: v for k, v in mss2.items()},
        **{"cnc_" + k: v for k, v in cnc.items()})

    diags = StepDiagnostics(
        eflx_sh_tot=sfu.eflx_sh_tot, eflx_lh_tot=sfu.eflx_lh_tot,
        eflx_soil_grnd=sfu.eflx_soil_grnd,
        eflx_lwrad_out=lw.eflx_lwrad_out, eflx_lwrad_net=lw.eflx_lwrad_net,
        qflx_evap_tot=sfu.qflx_evap_tot,
        qflx_tran_veg=cf_stab.qflx_tran_veg,
        qflx_top_soil=sb.qflx_top_soil, qflx_rootsoi=qflx_rootsoi,
        qflx_sl_top_soil=sb.qflx_sl_top_soil,
        qflx_snow2topsoi=sb.qflx_snow2topsoi,
        qflx_snwcp_liq=sfu.qflx_snwcp_liq,
        qflx_snwcp_ice=sfu.qflx_snwcp_ice,
        mflx_snowlyr=sb.mflx_snowlyr_col, mflx_neg_snow=sb.mflx_neg_snow,
        fsa=tot.fsa, fsr=sfo.fsr_out, t_ref2m=cf_cf.t_ref2m, errh2o=errh2o,
        errh2o_led=errh2o_led,
        errh2osno=errh2osno, errh2osno_steady=errh2osno_steady,
        errsol=errsol, errlon=errlon, errseb=errseb,
        errsoi=errsoi, netrad=netrad, niters_canopy=cf_stab.itlef,
        niters_ci=(cf_stab.psn_iters[:ncol] + cf_stab.psn_iters[ncol:]))
    return new_state, diags
