"""Soil/snow thermal conductivity and heat capacity — batched over columns.

Counterpart of ``elmkernels_tpu/physics/soil_thermal.py`` (reference
``src/physics/soil_thermal_properties_impl.hh:4-276``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from elmkernels_torch import constants as c
from elmkernels_torch.physics.math_utils import levels, safe_div

TKICE = 2.290     # thermal conductivity of ice [W/m/K]
TKWAT = 0.57      # thermal conductivity of water [W/m/K]
TKBDRK = 3.0      # thermal conductivity of bedrock [W/m/K]
TKAIR = 0.023     # thermal conductivity of air [W/m/K]
THIN_SFCLAYER = 1.0e-6  # threshold for thin surface layer


def _ice_or_water(t):
    return torch.where(t < c.TFRZ, torch.full_like(t, TKICE), TKWAT)


def calc_soil_tk(land: c.LandType, h2osoi_liq, h2osoi_ice, t_soisno, dz,
                 watsat, tkmg, tkdry):
    """Soil-layer thermal conductivity [ncol, nlevgrnd].

    Reference: ``soil_thermal_properties_impl.hh:20-88`` (``calc_soil_tk``).
    """
    i0 = c.NLEVSNO
    liq, ice = h2osoi_liq[:, i0:], h2osoi_ice[:, i0:]
    t, dzs = t_soisno[:, i0:], dz[:, i0:]

    icem = c.ltype_mask(land, c.ISTICE, c.ISTICE_MEC)
    wetm = c.ltype_mask(land, c.ISTWET)
    if icem is True:
        return _ice_or_water(t)

    bedrock = levels(c.NLEVGRND, t)[None, :] >= c.NLEVBED
    if wetm is True:
        return torch.where(bedrock, TKBDRK, _ice_or_water(t))

    satw = torch.clamp(
        (liq / c.DENH2O + ice / c.DENICE) / (dzs * watsat), max=1.0)
    wet = satw > 1.0e-6
    dke = torch.where(t >= c.TFRZ,
                      torch.clamp(torch.log10(torch.clamp(satw, min=1e-300))
                                  + 1.0, min=0.0),
                      satw)
    tot = liq / (c.DENH2O * dzs) + ice / (c.DENICE * dzs)
    fl = safe_div(liq / (c.DENH2O * dzs), tot, tot > 0.0)
    dksat = (tkmg * TKWAT ** (fl * watsat)
             * TKICE ** ((1.0 - fl) * watsat))
    thk = torch.where(wet, dke * dksat + (1.0 - dke) * tkdry, tkdry)
    thk = torch.where(bedrock, TKBDRK, thk)
    if icem is False and wetm is False:
        return thk
    icewat = _ice_or_water(t)
    return c.lsel(icem, icewat,
                  c.lsel(wetm, torch.where(bedrock, TKBDRK, icewat), thk))


def _snow_active(snl, like):
    nsno = c.NLEVSNO
    return levels(nsno, like)[None, :] >= (nsno - snl)[:, None]


def calc_snow_tk(snl, frac_sno, h2osoi_liq, h2osoi_ice, dz):
    """Snow-layer thermal conductivity [ncol, NLEVSNO] (inactive layers 0).

    Reference: ``soil_thermal_properties_impl.hh:91-120`` (``calc_snow_tk``).
    """
    nsno = c.NLEVSNO
    active = _snow_active(snl, dz)
    den = frac_sno[:, None] * dz[:, :nsno]
    bw = safe_div(h2osoi_ice[:, :nsno] + h2osoi_liq[:, :nsno], den,
                  den != 0.0)
    thk = TKAIR + (7.75e-5 * bw + 1.105e-6 * bw * bw) * (TKICE - TKAIR)
    return torch.where(active, thk, 0.0)


def calc_face_tk_full(snl, thk, z, zi):
    """Interface thermal conductivity tk[ncol, NLEVTOT]; tk(i) is between
    cells i and i+1 at position zi(i+1); inactive and bottom interfaces 0.

    Reference: ``soil_thermal_properties_impl.hh:127-154``.
    """
    ntot = c.NLEVTOT
    num = thk[:, :-1] * thk[:, 1:] * (z[:, 1:] - z[:, :-1])
    den = (thk[:, :-1] * (z[:, 1:] - zi[:, 1:ntot])
           + thk[:, 1:] * (zi[:, 1:ntot] - z[:, :-1]))
    tk_inner = safe_div(num, den, den != 0.0)
    active = (levels(ntot - 1, thk)[None, :]
              >= (c.NLEVSNO - snl)[:, None])
    tk_inner = torch.where(active, tk_inner, 0.0)
    return torch.cat([tk_inner, torch.zeros_like(tk_inner[:, :1])], dim=1)


def calc_soil_heat_capacity(land: c.LandType, snl, h2osno, watsat,
                            h2osoi_ice, h2osoi_liq, dz, csol):
    """Soil-layer heat capacity [ncol, nlevgrnd].

    Reference: ``soil_thermal_properties_impl.hh:158-196``.
    """
    i0 = c.NLEVSNO
    ice, liq, dzs = h2osoi_ice[:, i0:], h2osoi_liq[:, i0:], dz[:, i0:]
    lev = levels(c.NLEVGRND, dz)
    icem = c.ltype_mask(land, c.ISTICE, c.ISTICE_MEC)
    wetm = c.ltype_mask(land, c.ISTWET)
    if icem is True:
        cv = ice * c.CPICE + liq * c.CPWAT
    elif wetm is True:
        cv = ice * c.CPICE + liq * c.CPWAT
        cv = torch.where(lev[None, :] >= c.NLEVBED, csol * dzs, cv)
    elif isinstance(icem, bool) and isinstance(wetm, bool):
        cv = (csol * (1.0 - watsat) * dzs + ice * c.CPICE + liq * c.CPWAT)
    else:
        cv_ice = ice * c.CPICE + liq * c.CPWAT
        cv_wet = torch.where(lev[None, :] >= c.NLEVBED, csol * dzs, cv_ice)
        cv_soil = (csol * (1.0 - watsat) * dzs + ice * c.CPICE
                   + liq * c.CPWAT)
        cv = c.lsel(icem, cv_ice, c.lsel(wetm, cv_wet, cv_soil))
    # thin snow on bare ground adds its heat capacity to the top soil layer
    add = ((snl == 0) & (h2osno > 0.0))[:, None] & (lev[None, :] == 0)
    return cv + torch.where(add, c.CPICE * h2osno[:, None], 0.0)


def calc_snow_heat_capacity(snl, frac_sno, h2osoi_ice, h2osoi_liq):
    """Snow-layer heat capacity [ncol, NLEVSNO] (inactive 0).

    Reference: ``soil_thermal_properties_impl.hh:200-228``.
    """
    nsno = c.NLEVSNO
    active = _snow_active(snl, h2osoi_ice)
    pos = (frac_sno > 0.0)[:, None]
    cv = torch.where(
        pos,
        torch.clamp(safe_div(c.CPWAT * h2osoi_liq[:, :nsno]
                             + c.CPICE * h2osoi_ice[:, :nsno],
                             frac_sno[:, None], pos), min=THIN_SFCLAYER),
        THIN_SFCLAYER)
    return torch.where(active, cv, 0.0)


def calc_h2osfc_tk(h2osfc, thk_top_soil, z_top_soil):
    """Reference: ``soil_thermal_properties_impl.hh:232-244``."""
    zh2osfc = 1.0e-3 * (0.5 * h2osfc)
    return (TKWAT * thk_top_soil * (z_top_soil + zh2osfc)
            / (TKWAT * z_top_soil + thk_top_soil * zh2osfc))


def calc_h2osfc_heat_capacity(h2osfc, frac_h2osfc):
    """Reference: ``soil_thermal_properties_impl.hh:248-259``."""
    ok = (h2osfc > THIN_SFCLAYER) & (frac_h2osfc > THIN_SFCLAYER)
    return torch.where(
        ok, torch.clamp(c.CPWAT * h2osfc
                        / torch.where(ok, frac_h2osfc, 1.0),
                        min=THIN_SFCLAYER), THIN_SFCLAYER)


def calc_h2osfc_height(h2osfc, frac_h2osfc):
    """Reference: ``soil_thermal_properties_impl.hh:262-272``."""
    ok = (h2osfc > THIN_SFCLAYER) & (frac_h2osfc > THIN_SFCLAYER)
    return torch.where(
        ok, torch.clamp(1.0e-3 * h2osfc / torch.where(ok, frac_h2osfc, 1.0),
                        min=THIN_SFCLAYER), THIN_SFCLAYER)


class ThermalPropsOut(NamedTuple):
    thk: torch.Tensor        # [ncol, NLEVTOT] layer conductivity
    tk: torch.Tensor         # [ncol, NLEVTOT] interface conductivity
    cv: torch.Tensor         # [ncol, NLEVTOT] heat capacity
    tk_h2osfc: torch.Tensor
    c_h2osfc: torch.Tensor
    dz_h2osfc: torch.Tensor


def thermal_properties(land: c.LandType, snl, frac_sno, frac_h2osfc, h2osno,
                       h2osfc, h2osoi_liq, h2osoi_ice, t_soisno, dz, z, zi,
                       watsat, tkmg, tkdry, csol) -> ThermalPropsOut:
    """Full thermal-property stage (reference: the ``soil_thermal_props``
    lambda in ``driver/kokkos/soil_temperature_kokkos.cc:93-107``)."""
    thk_soil = calc_soil_tk(land, h2osoi_liq, h2osoi_ice, t_soisno, dz,
                            watsat, tkmg, tkdry)
    thk_snow = calc_snow_tk(snl, frac_sno, h2osoi_liq, h2osoi_ice, dz)
    thk = torch.cat([thk_snow, thk_soil], dim=1)
    tk = calc_face_tk_full(snl, thk, z, zi)
    cv_soil = calc_soil_heat_capacity(land, snl, h2osno, watsat, h2osoi_ice,
                                      h2osoi_liq, dz, csol)
    cv_snow = calc_snow_heat_capacity(snl, frac_sno, h2osoi_ice, h2osoi_liq)
    cv = torch.cat([cv_snow, cv_soil], dim=1)
    tk_h2osfc = calc_h2osfc_tk(h2osfc, thk[:, c.NLEVSNO], z[:, c.NLEVSNO])
    c_h2osfc = calc_h2osfc_heat_capacity(h2osfc, frac_h2osfc)
    dz_h2osfc = calc_h2osfc_height(h2osfc, frac_h2osfc)
    return ThermalPropsOut(thk, tk, cv, tk_h2osfc, c_h2osfc, dz_h2osfc)
