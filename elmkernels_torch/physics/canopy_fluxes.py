"""Vegetated-surface energy/water fluxes: leaf temperature Newton iteration
with embedded sun/shade photosynthesis — batched over columns.

Counterpart of ``elmkernels_tpu/physics/canopy_fluxes.py`` (reference
``src/physics/canopy_fluxes_impl.hh:15-542``).  The <=41-pass stability
loop has two implementations with one arithmetic:

- :func:`stability_iteration_plain` — a masked loop over the batch: each
  column follows the reference's per-column iteration sequence, with
  converged columns frozen.  Its ``any(active)`` test costs one host sync
  a pass, and its ci solves reach the ``ci_hybrid_solve`` kernel (K1, and
  K1-T under ``torch.func.jvp``) on the card.
- ``elmkernels_torch.ops.canopy.canopy_stability`` — K2, the CUDA kernel:
  one thread a column runs the whole loop, the ci solves inlined.

:func:`stability_iteration` routes CUDA tensors that carry no tangent to
K2, and everything else (CPU tensors; a differentiated call, for which K2
has no tangent version) to the plain loop.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from elmkernels_torch import constants as c
from elmkernels_torch.ops import tangents
from elmkernels_torch.physics import friction_velocity as fv
from elmkernels_torch.physics import photosynthesis as psn
from elmkernels_torch.physics import soil_moist_stress as sms
from elmkernels_torch.physics.math_utils import rdiv, take_layer
from elmkernels_torch.physics.qsat import qsat


class InitFluxOut(NamedTuple):
    btran: torch.Tensor
    displa: torch.Tensor
    z0mv: torch.Tensor
    z0hv: torch.Tensor
    z0qv: torch.Tensor
    rootr: torch.Tensor         # [ncol, nlevgrnd]
    eff_porosity: torch.Tensor  # [ncol, nlevgrnd]
    dayl_factor: torch.Tensor
    air: torch.Tensor
    bir: torch.Tensor
    cir: torch.Tensor
    el: torch.Tensor
    qsatl: torch.Tensor
    qsatldT: torch.Tensor
    taf: torch.Tensor
    qaf: torch.Tensor
    um: torch.Tensor
    ur: torch.Tensor
    obu: torch.Tensor
    zldis: torch.Tensor
    delq: torch.Tensor
    t_veg: torch.Tensor


def _lay(v):
    """Per-column trait -> broadcastable against [ncol, nlev] layers."""
    return v[:, None] if getattr(v, "ndim", 0) == 1 else v


def initialize_flux(land: c.LandType, p: psn.PFTPsnParams, snl,
                    frac_veg_nosno, frac_sno, forc_hgt_u_patch, thm, thv,
                    max_dayl, dayl, altmax_indx, altmax_lastyear_indx,
                    t_soisno, h2osoi_ice, h2osoi_liq, dz, rootfr, sucsat,
                    watsat, bsw, elai, esai, emv, emg, qg, t_grnd, forc_t,
                    forc_pbot, forc_lwrad, forc_u, forc_v, forc_q, forc_th,
                    z0mg, displa, z0mv, t_veg) -> InitFluxOut:
    """Pre-iteration setup (``canopy_fluxes_impl.hh:93-183``).  Bare
    columns get btran = 0, t_veg = forc_t, rootr = 0, the rest zeroed."""
    tlsai_crit = 2.0
    veg = frac_veg_nosno != 0

    dayl_factor = torch.clamp((dayl * dayl) / (max_dayl * max_dayl),
                              0.01, 1.0)

    eff_porosity = sms.calc_effective_soilporosity(watsat, h2osoi_ice, dz)
    h2osoi_liqvol = sms.calc_volumetric_h2oliq(eff_porosity, h2osoi_liq, dz)
    rms = sms.calc_root_moist_stress(
        h2osoi_liqvol, rootfr, t_soisno, _lay(p.tc_stress), sucsat, watsat,
        bsw, _lay(p.smpso), _lay(p.smpsc), eff_porosity, altmax_indx,
        altmax_lastyear_indx, torch.zeros_like(t_grnd))

    lt = torch.clamp(elai + esai, max=tlsai_crit)
    egvf = (1.0 - torch.exp(-lt)) / (1.0 - math.exp(-tlsai_crit))
    displa_v = displa * egvf
    z0mv_v = torch.exp(egvf * torch.log(z0mv) + (1.0 - egvf) * torch.log(z0mg))

    air = emv * (1.0 + (1.0 - emv) * (1.0 - emg)) * forc_lwrad
    bir = -(2.0 - emv * (1.0 - emg)) * emv * c.STEBOL
    cir = emv * emg * c.STEBOL

    qs = qsat(t_veg, forc_pbot)
    taf = (t_grnd + thm) / 2.0
    qaf = (forc_q + qg) / 2.0
    ur = torch.clamp(torch.sqrt(forc_u * forc_u + forc_v * forc_v), min=1.0)
    dth = thm - taf
    dqh = forc_q - qaf
    delq = qg - qaf
    dthv = dth * (1.0 + 0.61 * forc_q) + 0.61 * forc_th * dqh
    zldis = forc_hgt_u_patch - displa_v
    mo = fv.monin_obukhov_length(ur, thv, dthv, zldis, z0mv_v)

    def w(v):
        return torch.where(veg, v, 0.0)
    return InitFluxOut(
        btran=w(rms.btran),
        displa=w(displa_v), z0mv=w(z0mv_v), z0hv=w(z0mv_v), z0qv=w(z0mv_v),
        rootr=torch.where(veg[:, None], rms.rootr, 0.0),
        eff_porosity=eff_porosity,
        dayl_factor=w(dayl_factor), air=w(air), bir=w(bir), cir=w(cir),
        el=w(qs.es), qsatl=w(qs.qs), qsatldT=w(qs.qsdT), taf=w(taf),
        qaf=w(qaf), um=w(mo.um), ur=w(ur), obu=w(mo.obu), zldis=w(zldis),
        delq=w(delq), t_veg=torch.where(veg, t_veg, forc_t))


class StabilityOut(NamedTuple):
    btran: torch.Tensor
    qflx_tran_veg: torch.Tensor
    qflx_evap_veg: torch.Tensor
    eflx_sh_veg: torch.Tensor
    wtg: torch.Tensor
    wtl0: torch.Tensor
    wta0: torch.Tensor
    wtal: torch.Tensor
    el: torch.Tensor
    qsatl: torch.Tensor
    qsatldT: torch.Tensor
    taf: torch.Tensor
    qaf: torch.Tensor
    um: torch.Tensor
    dth: torch.Tensor
    dqh: torch.Tensor
    obu: torch.Tensor
    temp1: torch.Tensor
    temp2: torch.Tensor
    temp12m: torch.Tensor
    temp22m: torch.Tensor
    tlbef: torch.Tensor
    delq: torch.Tensor
    dt_veg: torch.Tensor
    t_veg: torch.Tensor
    wtgq: torch.Tensor
    wtalq: torch.Tensor
    wtlq0: torch.Tensor
    wtaq0: torch.Tensor
    itlef: torch.Tensor  # iterations used (diagnostic; reference loop var)
    ci: torch.Tensor     # [2*ncol] sun|shade ci roots (warm-start carry)
    psn_iters: torch.Tensor  # i32 [2*ncol] total inner secant iterations


def stability_iteration(land: c.LandType, p: psn.PFTPsnParams, dtime, snl,
                        frac_veg_nosno, frac_sno, forc_hgt_u_patch,
                        forc_hgt_t_patch, forc_hgt_q_patch, fwet, fdry,
                        laisun, laisha, forc_rho, snow_depth, soilbeta,
                        frac_h2osfc, t_h2osfc, sabv, h2ocan, htop, t_soisno,
                        air, bir, cir, ur, zldis, displa, elai, esai, t_grnd,
                        forc_pbot, forc_q, forc_th, z0mg, z0mv, z0hv, z0qv,
                        thm, thv, qg, nrad, t10, tlai_z, vcmaxcintsha,
                        vcmaxcintsun, parsha_z, parsun_z, laisha_z, laisun_z,
                        forc_pco2, forc_po2, dayl_factor, btran, el, qsatl,
                        qsatldT, taf, qaf, um, obu, delq,
                        t_veg, psn_mode: str | None = None,
                        *, soybean, warm_start: bool = False,
                        ci_prev=None) -> StabilityOut:
    """The canopy stability loop (``canopy_fluxes_impl.hh:185-452``):
    K2 (``ops.canopy.canopy_stability``) for CUDA tensors of which none
    carries a tangent, :func:`stability_iteration_plain` otherwise.  A
    failed build or launch of K2 raises."""
    args = dict(locals())
    if uses_kernel(args):
        from elmkernels_torch.ops.canopy import canopy_stability
        return canopy_stability(**args)
    return stability_iteration_plain(**args)


def uses_kernel(args: dict) -> bool:
    """Whether a call of :func:`stability_iteration` with these arguments
    (by name) runs K2: its tensors are on the card and none of them is
    differentiated (``torch.func.jvp``, forward AD or autograd)."""
    tensors = [v for v in args.values() if isinstance(v, torch.Tensor)]
    tensors += list(args["p"])
    return (_on_card(args["t_grnd"])
            and not any(tangents.carries_tangent(t) for t in tensors))


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def stability_iteration_plain(land: c.LandType, p: psn.PFTPsnParams, dtime,
                              snl, frac_veg_nosno, frac_sno,
                              forc_hgt_u_patch, forc_hgt_t_patch,
                              forc_hgt_q_patch, fwet, fdry, laisun, laisha,
                              forc_rho, snow_depth, soilbeta, frac_h2osfc,
                              t_h2osfc, sabv, h2ocan, htop, t_soisno, air,
                              bir, cir, ur, zldis, displa, elai, esai, t_grnd,
                              forc_pbot, forc_q, forc_th, z0mg, z0mv, z0hv,
                              z0qv, thm, thv, qg, nrad, t10, tlai_z,
                              vcmaxcintsha, vcmaxcintsun, parsha_z, parsun_z,
                              laisha_z, laisun_z, forc_pco2, forc_po2,
                              dayl_factor, btran, el, qsatl, qsatldT, taf,
                              qaf, um, obu, delq, t_veg,
                              psn_mode: str | None = None, *, soybean,
                              warm_start: bool = False,
                              ci_prev=None) -> StabilityOut:
    """Leaf-temperature Newton iteration (<=40 iterations + convergence on
    both dt_veg < 0.01 K and defe < 0.1 W/m2), with per-iteration sun and
    shade photosynthesis solves stacked as one [2*ncol] batch
    (``canopy_fluxes_impl.hh:185-452``).  ``soybean`` is the per-column
    btran-boost mask; ``warm_start`` seeds each ci solve from the previous
    iteration's roots and the first from ``ci_prev``."""
    btran0 = 0.0
    beta = 1.0
    zii = 1000.0
    ria = 0.5
    dlemin = 0.1
    dtmin = 0.01
    itmax = 40
    itmin = 2

    veg = frac_veg_nosno != 0
    t_top_sno = take_layer(t_soisno, c.NLEVSNO - snl)
    t_top_soil = t_soisno[:, c.NLEVSNO]
    ncol = t_grnd.shape[0]
    # stack sun+shade: per-column traits are tiled to [2*ncol]
    p2 = psn.tile_traits(p, 2)

    def _chain1(um_e, obu_e, taf_e):
        """Aerodynamic-resistance chain from iteration-entry (um, obu,
        taf); used by the loop body and once after the loop."""
        ustar = fv.friction_velocity_wind(forc_hgt_u_patch, displa, um_e,
                                          obu_e, z0mv)
        temp1 = fv.friction_velocity_temp(forc_hgt_t_patch, displa, obu_e,
                                          z0hv)
        temp2 = fv.friction_velocity_humidity(forc_hgt_q_patch,
                                              forc_hgt_t_patch, displa,
                                              obu_e, z0hv, z0qv, temp1)
        ram = 1.0 / (ustar * ustar / um_e)
        rah0 = 1.0 / (temp1 * ustar)
        raw0 = 1.0 / (temp2 * ustar)
        uaf = um_e * torch.sqrt(1.0 / (ram * um_e))
        cf_leaf = rdiv(0.01, torch.sqrt(uaf) * torch.sqrt(p.dleaf))
        rb = 1.0 / (cf_leaf * uaf)

        w = torch.exp(-(elai + esai))
        csoilb = rdiv(c.VKC, 0.13 * (z0mg * uaf / 1.5e-5) ** 0.45)
        ri = (c.GRAV * htop * (taf_e - t_grnd)) / (taf_e * uaf ** 2.0)
        ricsoilc = rdiv(c.CSOILC, 1.0 + ria * torch.clamp(ri, max=10.0))
        csoilcn = torch.where(taf_e - t_grnd > 0.0,
                              csoilb * w + ricsoilc * (1.0 - w),
                              csoilb * w + c.CSOILC * (1.0 - w))
        rah1 = 1.0 / (csoilcn * uaf)
        raw1 = rah1
        return (ustar, temp1, temp2, rah0, raw0, rb, uaf, rah1, raw1)

    def _chain2(c1, t_veg_e, qsatl_e, qsatldT_e, qaf_e, delq_e, efeb_e,
                btran_i, rssun, rssha):
        """Flux/energy-balance chain of one iteration from its entry state
        and that iteration's stomatal resistances."""
        ustar, temp1, temp2, rah0, raw0, rb, uaf, rah1, raw1 = c1
        wta = 1.0 / rah0
        wtl = (elai + esai) / rb
        wtg = 1.0 / rah1
        wtshi = 1.0 / (wta + wtl + wtg)
        wtl0 = wtl * wtshi
        wtg0 = wtg * wtshi
        wta0 = wta * wtshi
        wtga = wta0 + wtg0
        wtal = wta0 + wtl0

        rppdry = torch.where(
            fdry > 0.0,
            fdry * rb * (laisun / (rb + rssun) + laisha / (rb + rssha))
            / elai, 0.0)

        efpot = forc_rho * wtl * (qsatl_e - qaf_e)
        can_tran = btran_i > btran0
        qflx_tran_veg = torch.where(
            (efpot > 0.0) & can_tran, efpot * rppdry, 0.0)
        rpp = torch.where(efpot > 0.0,
                          torch.where(can_tran, rppdry + fwet, fwet), 1.0)
        efpot_safe = torch.where(efpot != 0.0, efpot, 1.0)
        rpp = torch.where(
            efpot > 0.0,
            torch.minimum(rpp, (qflx_tran_veg + h2ocan / dtime) / efpot_safe),
            rpp)

        fveg = frac_veg_nosno.to(t_veg_e.dtype)
        wtaq = fveg / raw0
        wtlq = fveg * (elai + esai) / rb * rpp
        snow_depth_c = 0.05
        fsno_dl = snow_depth / snow_depth_c
        elai_dl = 0.5 * (1.0 - torch.clamp(fsno_dl, max=1.0))
        rdl = (1.0 - torch.exp(-elai_dl)) / (0.004 * uaf)
        wtgq = torch.where(delq_e < 0.0, fveg / (raw1 + rdl),
                           soilbeta * fveg / (raw1 + rdl))
        wtsqi = 1.0 / (wtaq + wtlq + wtgq)
        wtgq0 = wtgq * wtsqi
        wtlq0 = wtlq * wtsqi
        wtaq0 = wtaq * wtsqi
        wtgaq = wtaq0 + wtgq0
        wtalq = wtaq0 + wtlq0
        dc1 = forc_rho * c.CPAIR * wtl
        dc2 = c.HVAP * forc_rho * wtlq
        efsh = dc1 * (wtga * t_veg_e - wtg0 * t_grnd - wta0 * thm)
        efe = dc2 * (wtgaq * qsatl_e - wtgq0 * qg - wtaq0 * forc_q)

        # damp oscillating leaf latent heat flux
        osc = efe * efeb_e < 0.0
        erre = torch.where(osc, 0.1 * efe - efe, 0.0)
        efe = torch.where(osc, 0.1 * efe, efe)

        lw_grnd = (frac_sno * t_top_sno ** 4.0
                   + (1.0 - frac_sno - frac_h2osfc) * t_top_soil ** 4.0
                   + frac_h2osfc * t_h2osfc ** 4.0)
        dt_veg = ((sabv + air + bir * t_veg_e ** 4.0 + cir * lw_grnd
                   - efsh - efe)
                  / (-4.0 * bir * t_veg_e ** 3.0 + dc1 * wtga
                     + dc2 * wtgaq * qsatldT_e))
        t_veg_n = t_veg_e + dt_veg
        dels = dt_veg
        del_ = torch.abs(dels)
        big = del_ > 1.0
        dt_veg = torch.where(big, dels / torch.where(big, del_, 1.0), dt_veg)
        t_veg_n = torch.where(big, t_veg_e + dt_veg, t_veg_n)
        err = torch.where(
            big,
            sabv + air + bir * t_veg_e ** 3.0 * (t_veg_e + 4.0 * dt_veg)
            + cir * lw_grnd - (efsh + dc1 * wtga * dt_veg)
            - (efe + dc2 * wtgaq * qsatldT_e * dt_veg), 0.0)

        efpot2 = forc_rho * wtl * (wtgaq * (qsatl_e + qsatldT_e * dt_veg)
                                   - wtgq0 * qg - wtaq0 * forc_q)
        qflx_evap_veg = rpp * efpot2
        qflx_tran_veg = torch.where((efpot2 > 0.0) & can_tran,
                                    efpot2 * rppdry, 0.0)
        ecidif = torch.clamp(qflx_evap_veg - qflx_tran_veg - h2ocan / dtime,
                             min=0.0)
        qflx_evap_veg = torch.minimum(qflx_evap_veg,
                                      qflx_tran_veg + h2ocan / dtime)
        eflx_sh_veg = (efsh + dc1 * wtga * dt_veg + err + erre
                       + c.HVAP * ecidif)
        return dict(
            dt_veg=dt_veg, t_veg_n=t_veg_n, del_=del_, efe=efe,
            wtg=wtg, wtl0=wtl0, wtg0=wtg0, wta0=wta0, wtga=wtga,
            wtal=wtal, wtgq=wtgq, wtalq=wtalq, wtlq0=wtlq0, wtaq0=wtaq0,
            wtgq0=wtgq0, qflx_tran_veg=qflx_tran_veg,
            qflx_evap_veg=qflx_evap_veg, eflx_sh_veg=eflx_sh_veg)

    def _boost(b):
        """Soybean btran boost, applied twice (sun then shade) exactly as
        the reference's in-place mutation sequence does."""
        bs = torch.where(soybean, torch.clamp(b * 1.25, max=1.0), b)
        return bs, torch.where(soybean, torch.clamp(bs * 1.25, max=1.0), bs)

    def cat2(a):
        return torch.cat([a, a], dim=0)

    z = torch.zeros_like(t_grnd)
    s_ci = (ci_prev if (warm_start and ci_prev is not None)
            else torch.cat([z, z]))
    s_psn_iters = torch.zeros((2 * ncol,), dtype=torch.int32,
                              device=z.device)
    s_t_veg, s_el, s_qsatl, s_qsatldT = t_veg, el, qsatl, qsatldT
    s_taf, s_qaf, s_um, s_obu, s_delq, s_btran = taf, qaf, um, obu, delq, \
        btran
    s_del, s_efeb, s_obuold = z, z, z
    s_nmozsgn = torch.zeros_like(snl)
    s_itlef = torch.zeros_like(snl)
    s_stop = ~veg
    p_t_veg, p_qsatl, p_qsatldT, p_taf, p_qaf = t_veg, qsatl, qsatldT, taf, \
        qaf
    p_um, p_obu, p_delq, p_efeb, p_rssun, p_rssha = um, obu, delq, z, z, z

    while bool(((s_itlef <= itmax) & ~s_stop).any()):
        act = (s_itlef <= itmax) & ~s_stop

        c1 = _chain1(s_um, s_obu, s_taf)
        ustar, temp1, temp2, rah0, raw0, rb, uaf, rah1, raw1 = c1
        del2 = s_del
        svpts = s_el
        eah = forc_pbot * s_qaf / 0.622

        btran_sun, btran_sha = _boost(s_btran)
        btran_i = btran_sha
        psn_both = psn.photosynthesis(
            p2, cat2(nrad), cat2(forc_pbot), cat2(s_t_veg), cat2(t10),
            cat2(svpts), cat2(eah), cat2(forc_po2), cat2(forc_pco2),
            cat2(rb), torch.cat([btran_sun, btran_sha]), cat2(dayl_factor),
            cat2(thm), cat2(tlai_z), torch.cat([vcmaxcintsun, vcmaxcintsha]),
            torch.cat([parsun_z, parsha_z]), torch.cat([laisun_z, laisha_z]),
            cat2(act), mode=psn_mode, ci_init=s_ci if warm_start else None)
        rssun = psn_both.rs[:ncol]
        rssha = psn_both.rs[ncol:]

        c2 = _chain2(c1, s_t_veg, s_qsatl, s_qsatldT, s_qaf, s_delq,
                     s_efeb, btran_i, rssun, rssha)
        dt_veg, t_veg_n, del_, efe = (c2["dt_veg"], c2["t_veg_n"],
                                      c2["del_"], c2["efe"])

        qs = qsat(t_veg_n, forc_pbot)
        el_n, qsatl_n, qsatldT_n = qs.es, qs.qs, qs.qsdT

        taf_n = c2["wtg0"] * t_grnd + c2["wta0"] * thm \
            + c2["wtl0"] * t_veg_n
        qaf_n = c2["wtlq0"] * qsatl_n + c2["wtgq0"] * qg \
            + forc_q * c2["wtaq0"]
        dth = thm - taf_n
        dqh = forc_q - qaf_n
        delq_n = c2["wtalq"] * qg - c2["wtlq0"] * qsatl_n \
            - c2["wtaq0"] * forc_q
        tstar = temp1 * dth
        qstar = temp2 * dqh
        thvstar = tstar * (1.0 + 0.61 * forc_q) + 0.61 * forc_th * qstar
        zeta = zldis * c.VKC * c.GRAV * thvstar / (ustar ** 2.0 * thv)
        stab = zeta >= 0.0
        zeta = torch.where(stab, torch.clamp(zeta, 0.01, 2.0),
                           torch.clamp(zeta, -100.0, -0.01))
        wc = beta * torch.clamp(-c.GRAV * ustar * thvstar * zii / thv,
                                min=0.0) ** 0.333
        um_n = torch.where(stab, torch.clamp(ur, min=0.1),
                           torch.sqrt(ur * ur + wc * wc))
        obu_n = zldis / zeta
        flip = s_obuold * obu_n < 0.0
        nmozsgn = s_nmozsgn + flip.to(s_nmozsgn.dtype)
        obu_n = torch.where(nmozsgn >= 4, zldis / (-0.01), obu_n)
        obuold = obu_n

        itlef = s_itlef + 1
        past_min = itlef > itmin
        dele = torch.abs(efe - s_efeb)
        efeb_n = torch.where(past_min, efe, s_efeb)
        det = torch.maximum(del_, del2)
        stop_n = s_stop | (past_min & (det < dtmin) & (dele < dlemin))

        def sel(new, old):
            return torch.where(act, new, old)

        # entry snapshots of the final ACTIVE iteration (output recompute)
        p_t_veg, p_qsatl = sel(s_t_veg, p_t_veg), sel(s_qsatl, p_qsatl)
        p_qsatldT = sel(s_qsatldT, p_qsatldT)
        p_taf, p_qaf = sel(s_taf, p_taf), sel(s_qaf, p_qaf)
        p_um, p_obu = sel(s_um, p_um), sel(s_obu, p_obu)
        p_delq, p_efeb = sel(s_delq, p_delq), sel(s_efeb, p_efeb)
        p_rssun, p_rssha = sel(rssun, p_rssun), sel(rssha, p_rssha)

        act2 = cat2(act)
        s_ci = torch.where(act2 & (psn_both.ci_root > 0.0),
                           psn_both.ci_root, s_ci)
        s_psn_iters = s_psn_iters + torch.where(act2, psn_both.ci_iters, 0)
        s_t_veg, s_el = sel(t_veg_n, s_t_veg), sel(el_n, s_el)
        s_qsatl, s_qsatldT = sel(qsatl_n, s_qsatl), sel(qsatldT_n, s_qsatldT)
        s_taf, s_qaf = sel(taf_n, s_taf), sel(qaf_n, s_qaf)
        s_um, s_obu = sel(um_n, s_um), sel(obu_n, s_obu)
        s_delq, s_btran = sel(delq_n, s_delq), sel(btran_i, s_btran)
        s_del, s_efeb = sel(del_, s_del), sel(efeb_n, s_efeb)
        s_obuold = sel(obuold, s_obuold)
        s_nmozsgn = sel(nmozsgn, s_nmozsgn)
        s_itlef = sel(itlef, s_itlef)
        s_stop = sel(stop_n, s_stop)

    # recompute the final-iteration outputs once from the entry snapshots
    # (identical arithmetic to the body); bare columns stay zero
    c1f = _chain1(p_um, p_obu, p_taf)
    temp12m = fv.friction_velocity_temp2m(p_obu, z0hv)
    temp22m = fv.friction_velocity_humidity2m(p_obu, z0hv, z0qv, temp12m)
    c2f = _chain2(c1f, p_t_veg, p_qsatl, p_qsatldT, p_qaf, p_delq, p_efeb,
                  s_btran, p_rssun, p_rssha)

    def out(x):
        return torch.where(veg, x, 0.0)

    return StabilityOut(
        btran=s_btran, qflx_tran_veg=out(c2f["qflx_tran_veg"]),
        qflx_evap_veg=out(c2f["qflx_evap_veg"]),
        eflx_sh_veg=out(c2f["eflx_sh_veg"]),
        wtg=out(c2f["wtg"]), wtl0=out(c2f["wtl0"]), wta0=out(c2f["wta0"]),
        wtal=out(c2f["wtal"]), el=s_el,
        qsatl=s_qsatl, qsatldT=s_qsatldT, taf=s_taf, qaf=s_qaf, um=s_um,
        dth=out(thm - s_taf), dqh=out(forc_q - s_qaf), obu=s_obu,
        temp1=out(c1f[1]), temp2=out(c1f[2]),
        temp12m=out(temp12m), temp22m=out(temp22m),
        tlbef=out(p_t_veg), delq=s_delq,
        dt_veg=out(c2f["dt_veg"]), t_veg=s_t_veg, itlef=s_itlef,
        wtgq=out(c2f["wtgq"]), wtalq=out(c2f["wtalq"]),
        wtlq0=out(c2f["wtlq0"]), wtaq0=out(c2f["wtaq0"]), ci=s_ci,
        psn_iters=s_psn_iters)


class ComputeFluxOut(NamedTuple):
    h2ocan: torch.Tensor
    eflx_sh_grnd: torch.Tensor
    eflx_sh_snow: torch.Tensor
    eflx_sh_soil: torch.Tensor
    eflx_sh_h2osfc: torch.Tensor
    qflx_evap_soi: torch.Tensor
    qflx_ev_snow: torch.Tensor
    qflx_ev_soil: torch.Tensor
    qflx_ev_h2osfc: torch.Tensor
    dlrad: torch.Tensor
    ulrad: torch.Tensor
    cgrnds: torch.Tensor
    cgrndl: torch.Tensor
    cgrnd: torch.Tensor
    t_ref2m: torch.Tensor
    q_ref2m: torch.Tensor
    rh_ref2m: torch.Tensor


def compute_flux(land: c.LandType, dtime, snl, frac_veg_nosno, frac_sno,
                 t_soisno, frac_h2osfc, t_h2osfc, sabv, qg_snow, qg_soil,
                 qg_h2osfc, dqgdT, htvp, wtg, wtl0, wta0, wtal, air, bir,
                 cir, qsatl, qsatldT, dth, dqh, temp1, temp2, temp12m,
                 temp22m, tlbef, delq, dt_veg, t_veg, t_grnd, forc_pbot,
                 qflx_tran_veg, qflx_evap_veg, eflx_sh_veg, forc_q, forc_rho,
                 thm, emv, emg, forc_lwrad, wtgq, wtalq, wtlq0, wtaq0,
                 h2ocan, eflx_sh_grnd, eflx_sh_snow, eflx_sh_soil,
                 eflx_sh_h2osfc, qflx_evap_soi, qflx_ev_snow, qflx_ev_soil,
                 qflx_ev_h2osfc, dlrad, ulrad, t_ref2m, q_ref2m,
                 rh_ref2m) -> ComputeFluxOut:
    """Post-iteration ground-canopy fluxes, longwave, flux derivatives, and
    2m diagnostics (``canopy_fluxes_impl.hh:454-540``).  Trailing
    arguments carry pass-through values for bare columns."""
    veg = frac_veg_nosno != 0

    t_top_sno = take_layer(t_soisno, c.NLEVSNO - snl)
    t_top_soil = t_soisno[:, c.NLEVSNO]

    lw_grnd = (frac_sno * t_top_sno ** 4.0
               + (1.0 - frac_sno - frac_h2osfc) * t_top_soil ** 4.0
               + frac_h2osfc * t_h2osfc ** 4.0)

    delt = wtal * t_grnd - wtl0 * t_veg - wta0 * thm
    sh_grnd = c.CPAIR * forc_rho * wtg * delt
    sh_snow = c.CPAIR * forc_rho * wtg * (
        wtal * t_top_sno - wtl0 * t_veg - wta0 * thm)
    sh_soil = c.CPAIR * forc_rho * wtg * (
        wtal * t_top_soil - wtl0 * t_veg - wta0 * thm)
    sh_h2osfc = c.CPAIR * forc_rho * wtg * (
        wtal * t_h2osfc - wtl0 * t_veg - wta0 * thm)
    ev_soi = forc_rho * wtgq * delq
    ev_snow = forc_rho * wtgq * (
        wtalq * qg_snow - wtlq0 * qsatl - wtaq0 * forc_q)
    ev_soil = forc_rho * wtgq * (
        wtalq * qg_soil - wtlq0 * qsatl - wtaq0 * forc_q)
    ev_h2osfc = forc_rho * wtgq * (
        wtalq * qg_h2osfc - wtlq0 * qsatl - wtaq0 * forc_q)

    t2m = thm + temp1 * dth * (1.0 / temp12m - 1.0 / temp1)
    q2m = forc_q + temp2 * dqh * (1.0 / temp22m - 1.0 / temp2)
    qs2m = qsat(t2m, forc_pbot)
    rh2m = torch.clamp(q2m / qs2m.qs * 100.0, max=100.0)

    dlrad_n = ((1.0 - emv) * emg * forc_lwrad
               + emv * emg * c.STEBOL * tlbef ** 3.0
               * (tlbef + 4.0 * dt_veg))
    ulrad_n = ((1.0 - emg) * (1.0 - emv) * (1.0 - emv) * forc_lwrad
               + emv * (1.0 + (1.0 - emg) * (1.0 - emv)) * c.STEBOL
               * tlbef ** 3.0 * (tlbef + 4.0 * dt_veg)
               + emg * (1.0 - emv) * c.STEBOL * lw_grnd)

    cgrnds_n = c.CPAIR * forc_rho * wtg * wtal
    cgrndl_n = forc_rho * wtgq * wtalq * dqgdT
    cgrnd_n = cgrnds_n + cgrndl_n * htvp

    h2ocan_n = torch.clamp(h2ocan + (qflx_tran_veg - qflx_evap_veg) * dtime,
                           min=0.0)

    def v(new, old):
        return torch.where(veg, new, old)
    return ComputeFluxOut(
        h2ocan=v(h2ocan_n, h2ocan),
        eflx_sh_grnd=v(sh_grnd, eflx_sh_grnd),
        eflx_sh_snow=v(sh_snow, eflx_sh_snow),
        eflx_sh_soil=v(sh_soil, eflx_sh_soil),
        eflx_sh_h2osfc=v(sh_h2osfc, eflx_sh_h2osfc),
        qflx_evap_soi=v(ev_soi, qflx_evap_soi),
        qflx_ev_snow=v(ev_snow, qflx_ev_snow),
        qflx_ev_soil=v(ev_soil, qflx_ev_soil),
        qflx_ev_h2osfc=v(ev_h2osfc, qflx_ev_h2osfc),
        dlrad=v(dlrad_n, dlrad), ulrad=v(ulrad_n, ulrad),
        cgrnds=torch.where(veg, cgrnds_n, 0.0),
        cgrndl=torch.where(veg, cgrndl_n, 0.0),
        cgrnd=torch.where(veg, cgrnd_n, 0.0),
        t_ref2m=v(t2m, t_ref2m), q_ref2m=v(q2m, q_ref2m),
        rh_ref2m=v(rh2m, rh_ref2m))
