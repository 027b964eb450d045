"""Ground temperature/humidity, emissivities, roughness lengths, and
forcing heights — batched over columns.

Counterpart of ``elmkernels_tpu/physics/canopy_temperature.py`` (reference
``src/physics/canopy_temperature_impl.hh:5-329``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from elmkernels_torch import constants as c
from elmkernels_torch.physics import surface_resistance
from elmkernels_torch.physics.math_utils import levels, take_layer
from elmkernels_torch.physics.qsat import qsat


class OldGroundTempOut(NamedTuple):
    t_h2osfc_bef: torch.Tensor
    tssbef: torch.Tensor  # [ncol, NLEVTOT]


def old_ground_temp(land: c.LandType, t_h2osfc, t_soisno) -> OldGroundTempOut:
    """Record pre-update ground/surface-water temperatures."""
    if land.ctype in (c.ICOL_SUNWALL, c.ICOL_SHADEWALL, c.ICOL_ROOF):
        lev = levels(c.NLEVTOT, t_soisno)
        tssbef = torch.where(lev[None, :] > c.NLEVURB, c.SPVAL, t_soisno)
    else:
        tssbef = t_soisno
    return OldGroundTempOut(t_h2osfc, tssbef)


def ground_temp(land: c.LandType, snl, frac_sno_eff, frac_h2osfc, t_h2osfc,
                t_soisno) -> torch.Tensor:
    """Ground temperature as snow/soil/surface-water weighted average."""
    top_sno_t = take_layer(t_soisno, c.NLEVSNO - snl)
    top_soil_t = t_soisno[:, c.NLEVSNO]
    with_snow = (frac_sno_eff * top_sno_t
                 + (1.0 - frac_sno_eff - frac_h2osfc) * top_soil_t
                 + frac_h2osfc * t_h2osfc)
    without = (1.0 - frac_h2osfc) * top_soil_t + frac_h2osfc * t_h2osfc
    return torch.where(snl > 0, with_snow, without)


class SoilAlphaOut(NamedTuple):
    qred: torch.Tensor
    hr: torch.Tensor
    soilalpha: torch.Tensor


def calc_soilalpha(land: c.LandType, frac_sno, frac_h2osfc, h2osoi_liq,
                   h2osoi_ice, dz, t_soisno, watsat, sucsat,
                   bsw) -> SoilAlphaOut:
    """Soil-surface relative-humidity reduction factor (urban/pervious-road
    branches are disabled in the reference and omitted)."""
    smpmin = -1.e8
    qred = torch.ones_like(frac_sno)
    hr = torch.ones_like(frac_sno)
    soilalpha = torch.full_like(frac_sno, c.SPVAL)

    wet_ice = c.ltype_mask(land, c.ISTWET, c.ISTICE, c.ISTICE_MEC)
    defaults = SoilAlphaOut(qred, hr, soilalpha)
    if wet_ice is True:
        return defaults
    sc = c.ltype_mask(land, c.ISTSOIL, c.ISTCROP)
    if sc is not False:
        i0 = c.NLEVSNO
        wx = (h2osoi_liq[:, i0] / c.DENH2O
              + h2osoi_ice[:, i0] / c.DENICE) / dz[:, i0]
        fac = torch.clamp(wx / watsat[:, 0], 0.01, 1.0)
        psit = torch.clamp(-sucsat[:, 0] * fac ** (-bsw[:, 0]), min=smpmin)
        hr_sc = torch.exp(psit / c.ROVERG / t_soisno[:, i0])
        qred_sc = ((1.0 - frac_sno - frac_h2osfc) * hr_sc + frac_sno
                   + frac_h2osfc)
        hr = c.lsel(sc, hr_sc, hr)
        qred = c.lsel(sc, qred_sc, qred)
        soilalpha = c.lsel(sc, qred_sc, soilalpha)
    elif land.ctype in (c.ICOL_SUNWALL, c.ICOL_SHADEWALL):
        qred = torch.zeros_like(frac_sno)
    out = SoilAlphaOut(qred, hr, soilalpha)
    return out if wet_ice is False else c.lsel(wet_ice, defaults, out)


def calc_soilbeta(land: c.LandType, frac_sno, frac_h2osfc, watsat, watfc,
                  h2osoi_liq, h2osoi_ice, dz) -> torch.Tensor:
    return surface_resistance.calc_soilevap_stress(
        land, frac_sno, frac_h2osfc, watsat, watfc, h2osoi_liq, h2osoi_ice,
        dz)


class HumiditiesOut(NamedTuple):
    qg_snow: torch.Tensor
    qg_soil: torch.Tensor
    qg: torch.Tensor
    qg_h2osfc: torch.Tensor
    dqgdT: torch.Tensor


def humidities(land: c.LandType, snl, forc_q, forc_pbot, t_h2osfc, t_grnd,
               frac_sno, frac_sno_eff, frac_h2osfc, qred, hr,
               t_soisno) -> HumiditiesOut:
    """Specific humidities over snow/soil/surface water and d(qg)/dT.

    The reference's unsatisfiable ``qsatg > forc_q && forc_q > qsatg``
    guards are dropped; the live dew-limit guard on the soil branch is kept.
    """
    sc = c.ltype_mask(land, c.ISTSOIL, c.ISTCROP)
    if sc is not False:
        top_sno_t = take_layer(t_soisno, c.NLEVSNO - snl)
        qs_snow = qsat(top_sno_t, forc_pbot)
        qg_snow = qs_snow.qs
        dqgdT = frac_sno * qs_snow.qsdT

        qs_soil = qsat(t_soisno[:, c.NLEVSNO], forc_pbot)
        dew_soil = (qs_soil.qs > forc_q) & (forc_q > hr * qs_soil.qs)
        qsatg_soil = torch.where(dew_soil, forc_q, qs_soil.qs)
        qsatgdT_soil = torch.where(dew_soil, 0.0, qs_soil.qsdT)
        qg_soil = hr * qsatg_soil
        dqgdT = dqgdT + (1.0 - frac_sno - frac_h2osfc) * hr * qsatgdT_soil

        # snl==0: qg_snow tracks qg_soil so hs_top_snow == hs_top_soil in the
        # soil-temperature solve
        no_sno = snl == 0
        qg_snow = torch.where(no_sno, qg_soil, qg_snow)
        dqgdT = torch.where(no_sno, (1.0 - frac_h2osfc) * hr * dqgdT, dqgdT)

        qs_sfc = qsat(t_h2osfc, forc_pbot)
        qg_h2osfc = qs_sfc.qs
        dqgdT = dqgdT + frac_h2osfc * qs_sfc.qsdT
        qg = (frac_sno_eff * qg_snow
              + (1.0 - frac_sno_eff - frac_h2osfc) * qg_soil
              + frac_h2osfc * qg_h2osfc)
        soilcase = HumiditiesOut(qg_snow, qg_soil, qg, qg_h2osfc, dqgdT)
        if sc is True:
            return soilcase

    qs = qsat(t_grnd, forc_pbot)
    qg = qred * qs.qs
    dqgdT = qred * qs.qsdT
    dew = (qs.qs > forc_q) & (forc_q > qred * qs.qs)
    qg = torch.where(dew, forc_q, qg)
    dqgdT = torch.where(dew, 0.0, dqgdT)
    other = HumiditiesOut(qg, qg, qg, qg, dqgdT)
    return other if sc is False else c.lsel(sc, soilcase, other)


class GroundPropertiesOut(NamedTuple):
    emg: torch.Tensor
    emv: torch.Tensor
    htvp: torch.Tensor
    z0mg: torch.Tensor
    z0hg: torch.Tensor
    z0qg: torch.Tensor
    z0mv: torch.Tensor
    z0hv: torch.Tensor
    z0qv: torch.Tensor
    thv: torch.Tensor
    z0m: torch.Tensor
    displa: torch.Tensor


def ground_properties(land: c.LandType, snl, frac_sno, forc_th, forc_q, elai,
                      esai, htop, displar_v, z0mr_v, h2osoi_liq,
                      h2osoi_ice) -> GroundPropertiesOut:
    """Emissivities, latent-heat selector, and roughness lengths.
    ``displar_v``/``z0mr_v`` are the PFT trait values (scalars or [ncol])."""
    ice = c.ltype_mask(land, c.ISTICE, c.ISTICE_MEC)
    if ice is True:
        emg = torch.full_like(frac_sno, 0.97)
    else:
        emg = (1.0 - frac_sno) * 0.96 + frac_sno * 0.97
        if ice is not False:
            emg = c.lsel(ice, torch.full_like(frac_sno, 0.97), emg)

    avmuir = 1.0
    emv = 1.0 - torch.exp(-(elai + esai) / avmuir)

    liq_top = take_layer(h2osoi_liq, c.NLEVSNO - snl)
    ice_top = take_layer(h2osoi_ice, c.NLEVSNO - snl)
    htvp = torch.where((liq_top <= 0.0) & (ice_top > 0.0),
                       torch.full_like(liq_top, c.HSUB), c.HVAP)

    z0mg = torch.where(frac_sno > 0.0, torch.full_like(frac_sno, c.ZSNO),
                       c.ZLND)
    z0m = z0mr_v * htop
    displa = displar_v * htop
    thv = forc_th * (1.0 + 0.61 * forc_q)

    return GroundPropertiesOut(emg, emv, htvp, z0mg, z0mg, z0mg, z0m, z0m,
                               z0m, thv, z0m, displa)


class ForcingHeightOut(NamedTuple):
    forc_hgt_u_patch: torch.Tensor
    forc_hgt_t_patch: torch.Tensor
    forc_hgt_q_patch: torch.Tensor
    thm: torch.Tensor


def forcing_height(land: c.LandType, veg_active, frac_veg_nosno, z0m, z0mg,
                   forc_t, displa, forc_hgt_u_patch, forc_hgt_t_patch,
                   forc_hgt_q_patch) -> ForcingHeightOut:
    """Patch-level forcing heights (+z0m+displa) and 2m-adjusted thm."""
    sc = c.ltype_mask(land, c.ISTSOIL, c.ISTCROP)
    wet_ice = c.ltype_mask(land, c.ISTWET, c.ISTICE, c.ISTICE_MEC)
    if sc is True:
        add = torch.where(frac_veg_nosno == 0, z0mg + displa, z0m + displa)
    elif wet_ice is True:
        add = z0mg
    elif sc is False and wet_ice is False:
        add = torch.zeros_like(z0mg)  # urban: z_0_town + z_d_town == 0
    else:
        add = c.lsel(sc, torch.where(frac_veg_nosno == 0, z0mg + displa,
                                     z0m + displa),
                     c.lsel(wet_ice, z0mg, torch.zeros_like(z0mg)))
    add = torch.where(veg_active, add, 0.0)

    u = forc_hgt_u_patch + add
    t = forc_hgt_t_patch + add
    q = forc_hgt_q_patch + add
    thm = forc_t + 0.0098 * t
    return ForcingHeightOut(u, t, q, thm)
