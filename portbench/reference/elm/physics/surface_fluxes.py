"""Post-solve surface flux corrections and outgoing longwave — batched.

Counterpart of ``elmkernels_tpu/physics/surface_fluxes.py`` (reference
``src/physics/surface_fluxes_impl.hh:4-296``).  The reference's literal
arithmetic is kept where it looks like a typo (``pow(t_h2osfc_bef, 40)``
and ``pow(emg*STEBOL*t_grnd0, 3.0)``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.elm import constants as c
from portbench.reference.elm.physics.math_utils import levels


def _integer_pow(x, n: int):
    """x**n by binary exponentiation, the multiplication order of JAX's
    ``lax.integer_pow`` (what ``x ** 40`` lowers to there)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def prev_tgrnd(snl, frac_sno_eff, frac_h2osfc, t_h2osfc_bef, tssbef_snotop,
               tssbef_soitop):
    """Reference: ``surface_fluxes_impl.hh:9-20``."""
    with_snow = (frac_sno_eff * tssbef_snotop
                 + (1.0 - frac_sno_eff - frac_h2osfc) * tssbef_soitop
                 + frac_h2osfc * t_h2osfc_bef)
    without = (1.0 - frac_h2osfc) * tssbef_soitop + frac_h2osfc * t_h2osfc_bef
    return torch.where(snl > 0, with_snow, without)


class InitialFluxOut(NamedTuple):
    eflx_sh_grnd: torch.Tensor
    qflx_evap_soi: torch.Tensor
    qflx_ev_snow: torch.Tensor
    qflx_ev_soil: torch.Tensor
    qflx_ev_h2osfc: torch.Tensor


def initial_flux_calc(land: c.LandType, snl, frac_sno_eff, frac_h2osfc,
                      t_h2osfc_bef, tssbef_snotop, tssbef_soitop, t_grnd,
                      cgrnds, cgrndl, eflx_sh_grnd, qflx_evap_soi,
                      qflx_ev_snow, qflx_ev_soil,
                      qflx_ev_h2osfc) -> InitialFluxOut:
    """tinc-correct fluxes for the temperature change during the step
    (``surface_fluxes_impl.hh:73-95``)."""
    t_grnd0 = prev_tgrnd(snl, frac_sno_eff, frac_h2osfc, t_h2osfc_bef,
                         tssbef_snotop, tssbef_soitop)
    tinc = t_grnd - t_grnd0
    sh = eflx_sh_grnd + tinc * cgrnds
    ev = qflx_evap_soi + tinc * cgrndl
    if land.urbpoi:
        return InitialFluxOut(sh, ev, ev, torch.zeros_like(ev),
                              torch.zeros_like(ev))
    return InitialFluxOut(sh, ev, qflx_ev_snow + tinc * cgrndl,
                          qflx_ev_soil + tinc * cgrndl,
                          qflx_ev_h2osfc + tinc * cgrndl)


class UpdateFluxOut(NamedTuple):
    qflx_evap_soi: torch.Tensor
    eflx_sh_grnd: torch.Tensor
    qflx_ev_snow: torch.Tensor
    qflx_ev_soil: torch.Tensor
    qflx_ev_h2osfc: torch.Tensor
    eflx_soil_grnd: torch.Tensor
    eflx_sh_tot: torch.Tensor
    qflx_evap_tot: torch.Tensor
    eflx_lh_tot: torch.Tensor
    qflx_evap_grnd: torch.Tensor
    qflx_sub_snow: torch.Tensor
    qflx_dew_snow: torch.Tensor
    qflx_dew_grnd: torch.Tensor
    qflx_snwcp_liq: torch.Tensor
    qflx_snwcp_ice: torch.Tensor


def update_surface_fluxes(land: c.LandType, do_capsnow, snl, dtime, t_grnd,
                          htvp, frac_sno_eff, frac_h2osfc, t_h2osfc_bef,
                          sabg_soil, sabg_snow, dlrad, frac_veg_nosno, emg,
                          forc_lwrad, tssbef_snotop, tssbef_soitop,
                          h2osoi_ice_snotop, h2osoi_liq_snotop, eflx_sh_veg,
                          qflx_evap_veg, qflx_evap_soi, eflx_sh_grnd,
                          qflx_ev_snow, qflx_ev_soil, qflx_ev_h2osfc,
                          qflx_snwcp_liq, qflx_snwcp_ice,
                          elm_correct_seb: bool = False) -> UpdateFluxOut:
    """Evaporation-limited flux update, ground heat flux, totals, and
    evaporation/sublimation/dew partitioning
    (``surface_fluxes_impl.hh:146-230``).  ``elm_correct_seb=True`` uses
    ELM proper's ``4*emg*STEBOL*t_grnd0**3*tinc`` linearization instead of
    the reference's cube of the whole expression."""
    egsmax = torch.clamp((h2osoi_ice_snotop + h2osoi_liq_snotop) / dtime,
                         min=0.0)
    ev_safe = torch.where(qflx_evap_soi != 0.0, qflx_evap_soi, 1.0)
    egirat = torch.where(qflx_evap_soi > egsmax, egsmax / ev_safe, 1.0)

    limited = egirat < 1.0
    save_ev = qflx_evap_soi
    qflx_evap_soi = torch.where(limited, qflx_evap_soi * egirat,
                                qflx_evap_soi)
    eflx_sh_grnd = torch.where(
        limited, eflx_sh_grnd + (save_ev - qflx_evap_soi) * htvp,
        eflx_sh_grnd)
    qflx_ev_snow = torch.where(limited, qflx_ev_snow * egirat, qflx_ev_snow)
    qflx_ev_soil = torch.where(limited, qflx_ev_soil * egirat, qflx_ev_soil)
    qflx_ev_h2osfc = torch.where(limited, qflx_ev_h2osfc * egirat,
                                 qflx_ev_h2osfc)

    # ground heat flux (the reference's literal pow(x, 40) kept, guarded
    # so that f32 overflow cannot turn 0 * inf into NaN)
    h2osfc_lw = torch.where(frac_h2osfc != 0.0,
                            frac_h2osfc * _integer_pow(t_h2osfc_bef, 40), 0.0)
    lw_grnd = (frac_sno_eff * tssbef_snotop ** 4.0
               + (1.0 - frac_sno_eff - frac_h2osfc) * tssbef_soitop ** 4.0
               + h2osfc_lw)
    t_grnd0 = prev_tgrnd(snl, frac_sno_eff, frac_h2osfc, t_h2osfc_bef,
                         tssbef_snotop, tssbef_soitop)
    tinc = t_grnd - t_grnd0
    if elm_correct_seb:
        dlw_lin = 4.0 * emg * c.STEBOL * t_grnd0 ** 3.0 * tinc
    else:  # reference-literal: cubes the whole expression (impl:182)
        dlw_lin = (emg * c.STEBOL * t_grnd0) ** 3.0 * (4.0 * tinc)
    eflx_soil_grnd = (
        (1.0 - frac_sno_eff) * sabg_soil + frac_sno_eff * sabg_snow + dlrad
        + (1.0 - frac_veg_nosno) * emg * forc_lwrad
        - emg * c.STEBOL * lw_grnd
        - dlw_lin
        - (eflx_sh_grnd + qflx_evap_soi * htvp))

    eflx_sh_tot = eflx_sh_veg + eflx_sh_grnd
    qflx_evap_tot = qflx_evap_veg + qflx_evap_soi
    eflx_lh_tot = c.HVAP * qflx_evap_veg + htvp * qflx_evap_soi

    tot_top = h2osoi_liq_snotop + h2osoi_ice_snotop
    tot_safe = torch.where(tot_top > 0.0, tot_top, 1.0)
    evap = qflx_ev_snow >= 0.0
    qflx_evap_grnd = torch.where(
        evap & (tot_top > 0.0),
        torch.clamp(qflx_ev_snow * (h2osoi_liq_snotop / tot_safe), min=0.0),
        0.0)
    qflx_sub_snow = torch.where(evap, qflx_ev_snow - qflx_evap_grnd, 0.0)
    qflx_dew_snow = torch.where(~evap & (t_grnd < c.TFRZ),
                                torch.abs(qflx_ev_snow), 0.0)
    qflx_dew_grnd = torch.where(~evap & (t_grnd >= c.TFRZ),
                                torch.abs(qflx_ev_snow), 0.0)

    cap = (snl > 0) & (do_capsnow != 0)
    qflx_snwcp_liq = torch.where(
        cap, qflx_snwcp_liq + frac_sno_eff * qflx_dew_grnd, qflx_snwcp_liq)
    qflx_snwcp_ice = torch.where(
        cap, qflx_snwcp_ice + frac_sno_eff * qflx_dew_snow, qflx_snwcp_ice)

    return UpdateFluxOut(qflx_evap_soi, eflx_sh_grnd, qflx_ev_snow,
                         qflx_ev_soil, qflx_ev_h2osfc, eflx_soil_grnd,
                         eflx_sh_tot, qflx_evap_tot, eflx_lh_tot,
                         qflx_evap_grnd, qflx_sub_snow, qflx_dew_snow,
                         qflx_dew_grnd, qflx_snwcp_liq, qflx_snwcp_ice)


class LwradOut(NamedTuple):
    eflx_lwrad_out: torch.Tensor
    eflx_lwrad_net: torch.Tensor


def lwrad_outgoing(land: c.LandType, snl, frac_veg_nosno, forc_lwrad,
                   frac_sno_eff, tssbef_snotop, tssbef_soitop, frac_h2osfc,
                   t_h2osfc_bef, t_grnd, ulrad, emg) -> LwradOut:
    """Outgoing/net longwave above the canopy
    (``surface_fluxes_impl.hh:239-259``)."""
    lw_grnd = (frac_sno_eff * tssbef_snotop ** 4.0
               + (1.0 - frac_sno_eff - frac_h2osfc) * tssbef_soitop ** 4.0
               + frac_h2osfc * t_h2osfc_bef ** 4.0)
    t_grnd0 = prev_tgrnd(snl, frac_sno_eff, frac_h2osfc, t_h2osfc_bef,
                         tssbef_snotop, tssbef_soitop)
    tinc = t_grnd - t_grnd0
    out = (ulrad + (1 - frac_veg_nosno) * (1.0 - emg) * forc_lwrad
           + (1 - frac_veg_nosno) * emg * c.STEBOL * lw_grnd
           + 4.0 * emg * c.STEBOL * t_grnd0 ** 3.0 * tinc)
    return LwradOut(out, out - forc_lwrad)


def soil_energy_balance(land: c.LandType, snl, eflx_soil_grnd, xmf,
                        xmf_h2osfc, frac_h2osfc, t_h2osfc, t_h2osfc_bef,
                        dtime, eflx_h2osfc_to_snow, frac_sno_eff, t_soisno,
                        tssbef, fact):
    """Soil energy balance residual (``surface_fluxes_impl.hh:262-294``)."""
    errsoi = (eflx_soil_grnd - xmf - xmf_h2osfc
              - frac_h2osfc * (t_h2osfc - t_h2osfc_bef) * (t_h2osfc / dtime)
              + eflx_h2osfc_to_snow)
    lev = levels(c.NLEVTOT, snl)[None, :]
    top = (c.NLEVSNO - snl)[:, None]
    fact_safe = torch.where(fact != 0.0, fact, 1.0)
    dheat = (t_soisno - tssbef) / fact_safe
    snow_rows = (lev >= top) & (lev < c.NLEVSNO)
    soil_rows = lev >= c.NLEVSNO
    return errsoi - torch.sum(
        torch.where(snow_rows, frac_sno_eff[:, None] * dheat, 0.0)
        + torch.where(soil_rows, dheat, 0.0), dim=1)
