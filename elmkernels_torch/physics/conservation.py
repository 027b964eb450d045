"""Water and energy conservation evaluators, batched over columns.

Counterpart of ``elmkernels_tpu/physics/conservation.py`` (reference
``src/physics/conserved_quantity_evaluators_impl.hh:3-110``).
"""

from __future__ import annotations

import torch

from elmkernels_torch import constants as c


def column_water_mass(h2ocan, h2osno, h2osfc, h2osoi_ice, h2osoi_liq):
    """Total column water [kg/m2] as the reference evaluates it (lines
    5-15): ``h2osno`` and every layer's ice and liquid, so an active pack
    counts twice (the step uses :func:`column_water_mass_tracked`)."""
    return (h2ocan + h2osno + h2osfc
            + torch.sum(h2osoi_ice + h2osoi_liq, dim=-1))


def column_water_mass_tracked(h2ocan, h2osno, h2osfc, h2osoi_ice,
                              h2osoi_liq):
    """Total column water [kg/m2] without the reference's double count:
    the pack enters via h2osno only; the layer sum covers soil rows."""
    return (h2ocan + h2osno + h2osfc
            + torch.sum(h2osoi_ice[..., c.NLEVSNO:]
                        + h2osoi_liq[..., c.NLEVSNO:], dim=-1))


def column_water_balance_error(begwb, endwb, hydrology_source_sink,
                               forc_rain, forc_snow, qflx_evap_tot,
                               qflx_snwcp_ice, dtime):
    return ((endwb - begwb)
            - (forc_rain + forc_snow - hydrology_source_sink - qflx_evap_tot
               - qflx_snwcp_ice) * dtime)


def snow_water_balance_error(snl, qflx_dew_snow, qflx_dew_grnd,
                             qflx_sub_snow, qflx_evap_grnd, qflx_snow_melt,
                             qflx_snwcp_ice, qflx_snwcp_liq,
                             qflx_sl_top_soil, frac_sno_eff, qflx_rain_grnd,
                             qflx_snow_grnd, qflx_h2osfc_ice, h2osno,
                             h2osno_old, dtime, do_capsnow):
    src_cap = (frac_sno_eff * (qflx_dew_snow + qflx_dew_grnd)
               + qflx_h2osfc_ice + qflx_snow_grnd + qflx_rain_grnd)
    snk_cap = (frac_sno_eff * (qflx_sub_snow + qflx_evap_grnd)
               + qflx_snwcp_ice + qflx_snwcp_liq + qflx_snow_melt
               + qflx_sl_top_soil)
    src_nc = (qflx_snow_grnd
              + frac_sno_eff * (qflx_rain_grnd + qflx_dew_snow
                                + qflx_dew_grnd) + qflx_h2osfc_ice)
    snk_nc = (frac_sno_eff * (qflx_sub_snow + qflx_evap_grnd)
              + qflx_snow_melt + qflx_sl_top_soil)
    cap = do_capsnow != 0
    src = torch.where(cap, src_cap, src_nc)
    snk = torch.where(cap, snk_cap, snk_nc)
    err = (h2osno - h2osno_old) - (src - snk) * dtime
    return torch.where(snl > 0, err, 0.0)


def solar_shortwave_balance_error(fsa, fsr, forc_solad, forc_solai):
    return fsa + fsr - (forc_solad[:, 0] + forc_solad[:, 1]
                        + forc_solai[:, 0] + forc_solai[:, 1])


def solar_longwave_balance_error(eflx_lwrad_out, eflx_lwrad_net, forc_lwrad):
    return eflx_lwrad_out - eflx_lwrad_net - forc_lwrad


def surface_energy_balance_error(sabv, sabg_chk, forc_lwrad, eflx_lwrad_out,
                                 eflx_sh_tot, eflx_lh_tot, eflx_soil_grnd):
    return (sabv + sabg_chk + forc_lwrad - eflx_lwrad_out - eflx_sh_tot
            - eflx_lh_tot - eflx_soil_grnd)


def net_radiation(fsa, eflx_lwrad_net):
    return fsa - eflx_lwrad_net
