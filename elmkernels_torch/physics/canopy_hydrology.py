"""Canopy interception, throughfall, snow initiation, and surface-water
fraction — batched over columns.

Counterpart of ``elmkernels_tpu/physics/canopy_hydrology.py`` (reference
``src/physics/canopy_hydrology_impl.hh:5-359``).  Combined snow+soil layer
arrays have shape ``[ncol, NLEVSNO+NLEVGRND]`` with snow on top; ``snl`` is
the positive number of active snow layers, so the top active snow layer
sits at index ``NLEVSNO - snl``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from elmkernels_torch import constants as c
from elmkernels_torch.physics.math_utils import levels, safe_div, safe_tanh


class InterceptionOut(NamedTuple):
    h2ocan: torch.Tensor
    qflx_candrip: torch.Tensor
    qflx_through_snow: torch.Tensor
    qflx_through_rain: torch.Tensor
    fracsnow: torch.Tensor
    fracrain: torch.Tensor


def interception(land: c.LandType, frac_veg_nosno, forc_rain, forc_snow,
                 dewmx, elai, esai, dtime, h2ocan) -> InterceptionOut:
    """Canopy interception/storage and throughfall
    (``canopy_hydrology_impl.hh:8-67``)."""
    zero = torch.zeros_like(forc_rain)
    passthrough = InterceptionOut(h2ocan, zero, zero, zero, zero, zero)
    icecase = InterceptionOut(zero, zero, zero, zero, zero, zero)
    if land.lakpoi or land.is_wall:
        return passthrough
    ice = c.ltype_mask(land, c.ISTICE, c.ISTICE_MEC)
    soil_like = c.lor(c.ltype_mask(land, c.ISTSOIL, c.ISTWET, c.ISTCROP),
                      land.urbpoi)
    if ice is True:
        return icecase
    if ice is False and soil_like is False:
        return passthrough

    total = forc_rain + forc_snow
    active = (frac_veg_nosno == 1) & (total > 0.0)

    fracsnow = torch.where(active, safe_div(forc_snow, total, total > 0.0),
                           0.0)
    fracrain = torch.where(active, safe_div(forc_rain, total, total > 0.0),
                           0.0)

    h2ocanmx = dewmx * (elai + esai)
    fpi = 0.25 * (1.0 - torch.exp(-0.5 * (elai + esai)))
    qflx_through_snow = torch.where(active, forc_snow * (1.0 - fpi), 0.0)
    qflx_through_rain = torch.where(active, forc_rain * (1.0 - fpi), 0.0)
    qflx_prec_intr = torch.where(active, total * fpi, 0.0)

    h2ocan_new = torch.where(
        active, torch.clamp(h2ocan + dtime * qflx_prec_intr, min=0.0), h2ocan)
    # excess water beyond leaf capacity drips off
    xrun = (h2ocan_new - h2ocanmx) / dtime
    drip = active & (xrun > 0.0)
    qflx_candrip = torch.where(drip, xrun, 0.0)
    h2ocan_new = torch.where(drip, h2ocanmx, h2ocan_new)
    out = InterceptionOut(h2ocan_new, qflx_candrip, qflx_through_snow,
                          qflx_through_rain, fracsnow, fracrain)
    # per-column ltype: other columns pass through, ice columns zero
    return c.lsel(ice, icecase, c.lsel(soil_like, out, passthrough))


class GroundFluxOut(NamedTuple):
    qflx_snwcp_liq: torch.Tensor
    qflx_snwcp_ice: torch.Tensor
    qflx_snow_grnd: torch.Tensor
    qflx_rain_grnd: torch.Tensor


def ground_flux(land: c.LandType, do_capsnow, frac_veg_nosno, forc_rain,
                forc_snow, qflx_irrig, qflx_candrip, qflx_through_snow,
                qflx_through_rain, fracsnow, fracrain) -> GroundFluxOut:
    """Precipitation (+irrigation) reaching the ground, split rain/snow
    (``canopy_hydrology_impl.hh:82-120``)."""
    if land.is_wall:
        prec_snow = torch.zeros_like(forc_snow)
        prec_rain = torch.zeros_like(forc_rain)
    else:
        bare = frac_veg_nosno == 0
        prec_snow = torch.where(bare, forc_snow,
                                qflx_through_snow + qflx_candrip * fracsnow)
        prec_rain = torch.where(bare, forc_rain,
                                qflx_through_rain + qflx_candrip * fracrain)
    prec_rain = prec_rain + qflx_irrig

    cap = do_capsnow != 0
    return GroundFluxOut(
        qflx_snwcp_liq=torch.where(cap, prec_rain, 0.0),
        qflx_snwcp_ice=torch.where(cap, prec_snow, 0.0),
        qflx_snow_grnd=torch.where(cap, 0.0, prec_snow),
        qflx_rain_grnd=torch.where(cap, 0.0, prec_rain),
    )


class FractionWetOut(NamedTuple):
    fwet: torch.Tensor
    fdry: torch.Tensor


def fraction_wet(land: c.LandType, frac_veg_nosno, dewmx, elai, esai,
                 h2ocan) -> FractionWetOut:
    """Wetted and dry fractions of the canopy
    (``canopy_hydrology_impl.hh:122-142``)."""
    veg = frac_veg_nosno == 1
    vegt = frac_veg_nosno * (elai + esai)
    wet = veg & (h2ocan > 0.0)
    # the reference uses the truncated literal 0.666666666666, keep it
    fwet_raw = safe_div(h2ocan / dewmx, vegt, vegt > 0.0) ** 0.666666666666
    fwet = torch.where(wet, torch.clamp(fwet_raw, max=1.0), 0.0)
    fdry = torch.where(veg, (1.0 - fwet) * elai / (elai + esai), 0.0)
    return FractionWetOut(fwet, fdry)


class SnowInitOut(NamedTuple):
    snow_depth: torch.Tensor
    h2osno: torch.Tensor
    int_snow: torch.Tensor
    swe_old: torch.Tensor       # [ncol, NLEVSNO]
    h2osoi_liq: torch.Tensor    # [ncol, NLEVTOT]
    h2osoi_ice: torch.Tensor    # [ncol, NLEVTOT]
    t_soisno: torch.Tensor      # [ncol, NLEVTOT]
    frac_iceold: torch.Tensor   # [ncol, NLEVTOT]
    snl: torch.Tensor
    dz: torch.Tensor            # [ncol, NLEVTOT]
    z: torch.Tensor             # [ncol, NLEVTOT]
    zi: torch.Tensor            # [ncol, NLEVTOT+1]
    snw_rds: torch.Tensor       # [ncol, NLEVSNO]
    frac_sno_eff: torch.Tensor
    frac_sno: torch.Tensor


def _int_snow_from_frac(h2osno, newsnow, frac, n_melt):
    return safe_div(
        h2osno + newsnow,
        0.5 * (torch.cos(c.ELM_PI
                         * torch.clamp(1.0 - torch.clamp(frac, min=1.e-6),
                                       min=0.0) ** (1.0 / n_melt)) + 1.0))


def _niu_yang_frac(depth, h2osno, newsnow):
    pos = depth > 0.0
    return safe_tanh(safe_div(
        depth,
        2.5 * c.ZLND * torch.clamp(safe_div(h2osno + newsnow, depth * 100.0,
                                            pos), max=800.0),
        pos))


def snow_init(land: c.LandType, dtime, do_capsnow, oldfflag, forc_t, t_grnd,
              qflx_snow_grnd, qflx_snow_melt, n_melt, snow_depth, h2osno,
              int_snow, h2osoi_liq, h2osoi_ice, t_soisno, frac_iceold, snl,
              dz, z, zi, snw_rds, frac_sno_eff, frac_sno) -> SnowInitOut:
    """Snow accumulation: depth/SWE update, snow-covered fraction, and
    creation/growth of the top snow layer
    (``canopy_hydrology_impl.hh:144-308``)."""
    accum_factor = 0.1
    nsno = c.NLEVSNO

    lev_sno = levels(nsno, snl)
    lev_tot = levels(c.NLEVTOT, snl)

    # save initial snow water content per possible snow layer
    active_sno = lev_sno[None, :] >= (nsno - snl[:, None])
    swe_old = torch.where(
        active_sno, h2osoi_liq[:, :nsno] + h2osoi_ice[:, :nsno], 0.0)

    cap = do_capsnow != 0
    newsnow = qflx_snow_grnd * dtime

    # --- non-capsnow branch ---
    # new-snow bulk density (Alta relationship)
    bifall = torch.where(
        forc_t > c.TFRZ + 2.0,
        50.0 + 1.7 * 17.0 ** 1.5,
        torch.where(forc_t > c.TFRZ - 15.0,
                    50.0 + 1.7 * torch.clamp(forc_t - c.TFRZ + 15.0,
                                             min=0.0) ** 1.5,
                    50.0))
    int_snow_nc = torch.maximum(int_snow, h2osno)
    snowmelt = qflx_snow_melt * dtime

    has_snow = h2osno > 0.0

    # FSCA change from melt during previous step
    smr = torch.clamp(safe_div(h2osno, int_snow_nc, int_snow_nc > 0.0),
                      max=1.0)
    frac_sno_melt = 1.0 - (torch.acos(torch.clamp(2.0 * smr - 1.0, max=1.0))
                           / c.ELM_PI) ** n_melt
    frac_sno_1 = torch.where(has_snow & (snowmelt > 0.0), frac_sno_melt,
                             frac_sno)

    # FSCA update from new snow event
    fsno_new = 1.0 - (1.0 - safe_tanh(accum_factor * newsnow)) \
        * (1.0 - frac_sno_1)
    frac_sno_2 = torch.where(has_snow & (newsnow > 0.0), fsno_new,
                             frac_sno_1)
    temp_intsnow = _int_snow_from_frac(h2osno, newsnow, frac_sno_2, n_melt)
    int_snow_2 = torch.where(has_snow & (newsnow > 0.0),
                             torch.clamp(temp_intsnow, max=1.e8),
                             int_snow_nc)

    # snow depth update (subgrid flux form vs uniform cover)
    if c.SUBGRIDFLAG == 1 and not land.urbpoi:
        depth_upd = torch.where(
            frac_sno_2 > 0.0,
            snow_depth + safe_div(newsnow, bifall * frac_sno_2,
                                  frac_sno_2 > 0.0),
            0.0)
    else:
        depth_upd = snow_depth + newsnow / bifall
    snow_depth_1 = torch.where(has_snow, depth_upd, snow_depth)

    # oldfflag==1: Niu & Yang 2007 snow cover fraction
    nyfrac = _niu_yang_frac(snow_depth_1, h2osno, newsnow)
    use_ny = has_snow & (oldfflag == 1)
    frac_sno_3 = torch.where(use_ny & (snow_depth_1 > 0.0), nyfrac,
                             frac_sno_2)
    frac_sno_3 = torch.where(use_ny & (h2osno < 1.0),
                             torch.minimum(frac_sno_3, h2osno), frac_sno_3)

    # --- no pre-existing snow: initialize from new snowfall ---
    fresh = (~has_snow) & (newsnow > 0.0)
    z_avg = newsnow / bifall
    frac_fresh = safe_tanh(accum_factor * newsnow)
    temp_intsnow_f = _int_snow_from_frac(h2osno, newsnow, frac_fresh, n_melt)
    int_snow_fresh = torch.clamp(temp_intsnow_f, max=1.e8)
    if c.SUBGRIDFLAG == 1 and not land.urbpoi:
        depth_fresh = safe_div(z_avg, frac_fresh, frac_fresh > 0.0)
    else:
        depth_fresh = newsnow / bifall
    nyfrac_fresh = _niu_yang_frac(depth_fresh, h2osno, newsnow)
    frac_fresh = torch.where((oldfflag == 1) & (depth_fresh > 0.0),
                             nyfrac_fresh, frac_fresh)

    none_ = (~has_snow) & (newsnow <= 0.0)
    frac_sno_nc = torch.where(fresh, frac_fresh,
                              torch.where(none_, 0.0, frac_sno_3))
    snow_depth_nc = torch.where(fresh, depth_fresh,
                                torch.where(none_, 0.0, snow_depth_1))
    int_snow_nc2 = torch.where(fresh, int_snow_fresh, int_snow_2)

    h2osno_nc = h2osno + newsnow
    int_snow_nc3 = int_snow_nc2 + newsnow
    dz_snowf_nc = snow_depth_nc - snow_depth

    # --- merge capsnow / non-capsnow ---
    frac_sno_new = torch.where(cap, 1.0, frac_sno_nc)
    int_snow_new = torch.where(cap, 5.e2, int_snow_nc3)
    snow_depth_new = torch.where(cap, snow_depth, snow_depth_nc)
    h2osno_new = torch.where(cap, h2osno, h2osno_nc)
    dz_snowf = torch.where(cap, 0.0, dz_snowf_nc)

    # effective snow fraction
    sc = c.ltype_mask(land, c.ISTSOIL, c.ISTCROP)
    if sc is True and c.SUBGRIDFLAG == 1:
        frac_sno_eff_new = frac_sno_new
    elif sc is False or c.SUBGRIDFLAG != 1:
        frac_sno_eff_new = torch.ones_like(frac_sno_new)
    else:
        frac_sno_eff_new = c.lsel(sc, frac_sno_new,
                                  torch.ones_like(frac_sno_new))

    wet = c.ltype_mask(land, c.ISTWET)
    if wet is not False:
        warm = t_grnd > c.TFRZ
        h2osno_new = c.lsel(wet, torch.where(warm, 0.0, h2osno_new),
                            h2osno_new)
        snow_depth_new = c.lsel(wet, torch.where(warm, 0.0, snow_depth_new),
                                snow_depth_new)

    # --- initialize first snow layer when accumulation >= 10 mm ---
    newnode = ((snl == 0) & (qflx_snow_grnd > 0.0)
               & (frac_sno_new * snow_depth_new >= 0.01))
    snl_new = torch.where(newnode, 1, snl)

    bot = nsno - 1  # bottom (ground-adjacent) snow layer index
    onehot_bot = (lev_tot[None, :] == bot) & newnode[:, None]
    dz_new = torch.where(onehot_bot, snow_depth_new[:, None], dz)
    z_new = torch.where(onehot_bot, -0.5 * snow_depth_new[:, None], z)
    lev_zi = levels(c.NLEVTOT + 1, snl)
    onehot_zi = (lev_zi[None, :] == bot) & newnode[:, None]
    zi_new = torch.where(onehot_zi, -snow_depth_new[:, None], zi)
    t_new = torch.where(onehot_bot,
                        torch.clamp(forc_t, max=c.TFRZ)[:, None], t_soisno)
    ice_new = torch.where(onehot_bot, h2osno_new[:, None], h2osoi_ice)
    liq_new = torch.where(onehot_bot, 0.0, h2osoi_liq)
    frac_iceold_new = torch.where(onehot_bot, 1.0, frac_iceold)
    onehot_bot_sno = (lev_sno[None, :] == bot) & newnode[:, None]
    snw_rds_new = torch.where(onehot_bot_sno, c.SNW_RDS_MIN, snw_rds)

    # --- add new snowfall to existing top snow layer ---
    grow = (snl_new > 0) & (~newnode)
    top_idx = nsno - snl_new  # index of top active snow layer
    onehot_top = (lev_tot[None, :] == top_idx[:, None]) & grow[:, None]
    ice_new = ice_new + torch.where(onehot_top, newsnow[:, None], 0.0)
    dz_new = dz_new + torch.where(onehot_top, dz_snowf[:, None], 0.0)

    return SnowInitOut(snow_depth_new, h2osno_new, int_snow_new, swe_old,
                       liq_new, ice_new, t_new, frac_iceold_new, snl_new,
                       dz_new, z_new, zi_new, snw_rds_new, frac_sno_eff_new,
                       frac_sno_new)


class FractionH2osfcOut(NamedTuple):
    h2osfc: torch.Tensor
    h2osoi_liq: torch.Tensor
    frac_sno: torch.Tensor
    frac_sno_eff: torch.Tensor
    frac_h2osfc: torch.Tensor


def fraction_h2osfc(land: c.LandType, micro_sigma, h2osno, h2osfc,
                    h2osoi_liq, frac_sno, frac_sno_eff) -> FractionH2osfcOut:
    """Surface-water fraction from microtopographic variability: a fixed
    10-iteration Newton solve of the submerged-fraction relation, then a
    consistency adjustment against the snow fraction
    (``canopy_hydrology_impl.hh:310-357``)."""
    min_h2osfc = 1.e-8
    sc = c.ltype_mask(land, c.ISTSOIL, c.ISTCROP)
    if sc is False:
        return FractionH2osfcOut(h2osfc, h2osoi_liq, frac_sno,
                                 frac_sno_eff, torch.zeros_like(h2osfc))

    ponded = h2osfc > min_h2osfc
    sigma = 1.0e3 * micro_sigma  # convert to mm
    sigma_safe = torch.where(sigma > 0.0, sigma, 1.0)
    sqrt2 = math.sqrt(2.0)

    d = torch.zeros_like(h2osfc)
    for _ in range(10):  # the JAX package's fixed-count fori_loop
        erf_term = torch.erf(d / (sigma_safe * sqrt2))
        fd = (0.5 * d * (1.0 + erf_term)
              + sigma_safe / math.sqrt(2.0 * c.ELM_PI)
              * torch.exp(-(d ** 2) / (2.0 * sigma_safe ** 2)) - h2osfc)
        dfdd = 0.5 * (1.0 + erf_term)
        d = d - fd / torch.where(dfdd != 0.0, dfdd, 1.0)
    frac_h2osfc = torch.where(
        ponded, 0.5 * (1.0 + torch.erf(d / (sigma_safe * sqrt2))), 0.0)

    # unpondable water goes into the top soil layer
    lev = levels(h2osoi_liq.shape[-1], h2osoi_liq)
    onehot_topsoil = (lev[None, :] == c.NLEVSNO) & (~ponded)[:, None]
    h2osoi_liq_new = h2osoi_liq + torch.where(onehot_topsoil,
                                              h2osfc[:, None], 0.0)
    h2osfc_new = torch.where(ponded, h2osfc, 0.0)

    # keep frac_sno + frac_h2osfc <= 1
    over = (frac_sno > (1.0 - frac_h2osfc)) & (h2osno > 0.0)
    big = over & (frac_h2osfc > 0.01)
    frac_h2osfc_adj = torch.where(big, torch.clamp(1.0 - frac_sno, min=0.01),
                                  frac_h2osfc)
    frac_sno_adj = torch.where(over, 1.0 - frac_h2osfc_adj, frac_sno)
    frac_sno_eff_adj = torch.where(over, frac_sno_adj, frac_sno_eff)
    out = FractionH2osfcOut(h2osfc_new, h2osoi_liq_new, frac_sno_adj,
                            frac_sno_eff_adj, frac_h2osfc_adj)
    if sc is True:
        return out
    return c.lsel(sc, out, FractionH2osfcOut(
        h2osfc, h2osoi_liq, frac_sno, frac_sno_eff,
        torch.zeros_like(h2osfc)))
