"""Monin-Obukhov surface fluxes for snow/soil surfaces without vegetation
(frac_veg_nosno == 0) — batched over columns.

Counterpart of ``elmkernels_tpu/physics/bareground_fluxes.py`` (reference
``src/physics/bareground_fluxes_impl.hh:4-165``).  The fixed 3-iteration
stability loop is a Python loop; masked (vegetated) columns pass their
inputs through unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.elm import constants as c
from portbench.reference.elm.physics import friction_velocity as fv
from portbench.reference.elm.physics.math_utils import take_layer
from portbench.reference.elm.physics.qsat import qsat


class InitFluxOut(NamedTuple):
    dlrad: torch.Tensor
    ulrad: torch.Tensor
    zldis: torch.Tensor
    displa: torch.Tensor
    dth: torch.Tensor
    dqh: torch.Tensor
    obu: torch.Tensor
    ur: torch.Tensor
    um: torch.Tensor


def initialize_flux(land: c.LandType, frac_veg_nosno, forc_u, forc_v, forc_q,
                    forc_th, forc_hgt_u_patch, thm, thv, t_grnd, qg, z0mg,
                    dlrad, ulrad, zldis, displa, dth, dqh, obu, ur,
                    um) -> InitFluxOut:
    """``bareground_fluxes_impl.hh:6-27``; the trailing arguments carry
    prior values for masked (vegetated) columns."""
    if land.lakpoi or land.urbpoi:
        return InitFluxOut(dlrad, ulrad, zldis, displa, dth, dqh, obu, ur, um)
    m = frac_veg_nosno == 0

    ur_n = torch.clamp(torch.sqrt(forc_u * forc_u + forc_v * forc_v),
                       min=1.0)
    dth_n = thm - t_grnd
    dqh_n = forc_q - qg
    zldis_n = forc_hgt_u_patch
    dthv = dth_n * (1.0 + 0.61 * forc_q) + 0.61 * forc_th * dqh_n
    mo = fv.monin_obukhov_length(ur_n, thv, dthv, zldis_n, z0mg)

    return InitFluxOut(
        dlrad=torch.where(m, 0.0, dlrad), ulrad=torch.where(m, 0.0, ulrad),
        zldis=torch.where(m, zldis_n, zldis),
        displa=torch.where(m, 0.0, displa),
        dth=torch.where(m, dth_n, dth), dqh=torch.where(m, dqh_n, dqh),
        obu=torch.where(m, mo.obu, obu), ur=torch.where(m, ur_n, ur),
        um=torch.where(m, mo.um, um))


class StabilityOut(NamedTuple):
    z0hg: torch.Tensor
    z0qg: torch.Tensor
    obu: torch.Tensor
    um: torch.Tensor
    temp1: torch.Tensor
    temp2: torch.Tensor
    temp12m: torch.Tensor
    temp22m: torch.Tensor
    ustar: torch.Tensor


def stability_iteration(land: c.LandType, frac_veg_nosno, forc_hgt_t_patch,
                        forc_hgt_u_patch, forc_hgt_q_patch, z0mg, zldis,
                        displa, dth, dqh, ur, forc_q, forc_th, thv, z0hg,
                        z0qg, obu, um, temp1, temp2, temp12m, temp22m,
                        ustar) -> StabilityOut:
    """Fixed 3-iteration Monin-Obukhov stability loop
    (``bareground_fluxes_impl.hh:29-78``)."""
    if land.lakpoi or land.urbpoi:
        return StabilityOut(z0hg, z0qg, obu, um, temp1, temp2, temp12m,
                            temp22m, ustar)
    m = frac_veg_nosno == 0
    beta = 1.0
    zii = 1000.0

    z0hg_i, z0qg_i, obu_i, um_i = z0hg, z0qg, obu, um
    t1_i, t2_i, t12_i, t22_i, ustar_i = temp1, temp2, temp12m, temp22m, ustar
    for _ in range(3):
        ustar_i = fv.friction_velocity_wind(forc_hgt_u_patch, displa, um_i,
                                            obu_i, z0mg)
        t1_i = fv.friction_velocity_temp(forc_hgt_t_patch, displa, obu_i,
                                         z0hg_i)
        t2_i = fv.friction_velocity_humidity(forc_hgt_q_patch,
                                             forc_hgt_t_patch, displa, obu_i,
                                             z0hg_i, z0qg_i, t1_i)
        t12_i = fv.friction_velocity_temp2m(obu_i, z0hg_i)
        t22_i = fv.friction_velocity_humidity2m(obu_i, z0hg_i, z0qg_i, t12_i)

        tstar = t1_i * dth
        qstar = t2_i * dqh
        thvstar = tstar * (1.0 + 0.61 * forc_q) + 0.61 * forc_th * qstar
        z0hg_i = z0mg / torch.exp(0.13 * (ustar_i * z0mg / 1.5e-5) ** 0.45)
        z0qg_i = z0hg_i
        zeta = zldis * c.VKC * c.GRAV * thvstar / (ustar_i ** 2.0 * thv)

        stab = zeta >= 0.0
        zeta = torch.where(stab, torch.clamp(zeta, 0.01, 2.0),
                           torch.clamp(zeta, -100.0, -0.01))
        wc = beta * torch.clamp(-c.GRAV * ustar_i * thvstar * zii / thv,
                                min=0.0) ** 0.333
        um_i = torch.where(stab, torch.clamp(ur, min=0.1),
                           torch.sqrt(ur * ur + wc * wc))
        obu_i = zldis / zeta

    return StabilityOut(
        z0hg=torch.where(m, z0hg_i, z0hg), z0qg=torch.where(m, z0qg_i, z0qg),
        obu=torch.where(m, obu_i, obu), um=torch.where(m, um_i, um),
        temp1=torch.where(m, t1_i, temp1), temp2=torch.where(m, t2_i, temp2),
        temp12m=torch.where(m, t12_i, temp12m),
        temp22m=torch.where(m, t22_i, temp22m),
        ustar=torch.where(m, ustar_i, ustar))


class ComputeFluxOut(NamedTuple):
    cgrnds: torch.Tensor
    cgrndl: torch.Tensor
    cgrnd: torch.Tensor
    eflx_sh_grnd: torch.Tensor
    eflx_sh_tot: torch.Tensor
    eflx_sh_snow: torch.Tensor
    eflx_sh_soil: torch.Tensor
    eflx_sh_h2osfc: torch.Tensor
    qflx_evap_soi: torch.Tensor
    qflx_evap_tot: torch.Tensor
    qflx_ev_snow: torch.Tensor
    qflx_ev_soil: torch.Tensor
    qflx_ev_h2osfc: torch.Tensor
    t_ref2m: torch.Tensor
    q_ref2m: torch.Tensor
    rh_ref2m: torch.Tensor


def compute_flux(land: c.LandType, frac_veg_nosno, snl, forc_rho, soilbeta,
                 dqgdT, htvp, t_h2osfc, qg_snow, qg_soil, qg_h2osfc,
                 t_soisno, forc_pbot, dth, dqh, temp1, temp2, temp12m,
                 temp22m, ustar, forc_q, thm, eflx_sh_grnd, eflx_sh_tot,
                 eflx_sh_snow, eflx_sh_soil, eflx_sh_h2osfc, qflx_evap_soi,
                 qflx_evap_tot, qflx_ev_snow, qflx_ev_soil, qflx_ev_h2osfc,
                 t_ref2m, q_ref2m, rh_ref2m) -> ComputeFluxOut:
    """Sensible/latent heat fluxes, flux derivatives, and 2m diagnostics
    (``bareground_fluxes_impl.hh:80-163``)."""
    zero = torch.zeros_like(thm)
    if land.lakpoi:
        return ComputeFluxOut(zero, zero, zero, eflx_sh_grnd, eflx_sh_tot,
                              eflx_sh_snow, eflx_sh_soil, eflx_sh_h2osfc,
                              qflx_evap_soi, qflx_evap_tot, qflx_ev_snow,
                              qflx_ev_soil, qflx_ev_h2osfc, t_ref2m, q_ref2m,
                              rh_ref2m)
    if land.urbpoi:
        m = torch.zeros_like(frac_veg_nosno, dtype=torch.bool)
    else:
        m = frac_veg_nosno == 0

    rah = 1.0 / (temp1 * ustar)
    raw = 1.0 / (temp2 * ustar)
    raih = forc_rho * c.CPAIR / rah
    raiw = torch.where(dqh > 0.0, forc_rho / raw, soilbeta * forc_rho / raw)

    cgrnds_n = raih
    cgrndl_n = raiw * dqgdT
    cgrnd_n = cgrnds_n + htvp * cgrndl_n

    sh_grnd = -raih * dth
    top_sno_t = take_layer(t_soisno, c.NLEVSNO - snl)
    sh_snow = -raih * (thm - top_sno_t)
    sh_soil = -raih * (thm - t_soisno[:, c.NLEVSNO])
    sh_h2osfc = -raih * (thm - t_h2osfc)

    ev_soi = -raiw * dqh
    ev_snow = -raiw * (forc_q - qg_snow)
    ev_soil = -raiw * (forc_q - qg_soil)
    ev_h2osfc = -raiw * (forc_q - qg_h2osfc)

    t2m = thm + temp1 * dth * (1.0 / temp12m - 1.0 / temp1)
    q2m = forc_q + temp2 * dqh * (1.0 / temp22m - 1.0 / temp2)
    qs2m = qsat(t2m, forc_pbot)
    rh2m = torch.clamp(q2m / qs2m.qs * 100.0, max=100.0)

    def w(new, old):
        return torch.where(m, new, old)
    return ComputeFluxOut(
        cgrnds=w(cgrnds_n, zero), cgrndl=w(cgrndl_n, zero),
        cgrnd=w(cgrnd_n, zero),
        eflx_sh_grnd=w(sh_grnd, eflx_sh_grnd),
        eflx_sh_tot=w(sh_grnd, eflx_sh_tot),
        eflx_sh_snow=w(sh_snow, eflx_sh_snow),
        eflx_sh_soil=w(sh_soil, eflx_sh_soil),
        eflx_sh_h2osfc=w(sh_h2osfc, eflx_sh_h2osfc),
        qflx_evap_soi=w(ev_soi, qflx_evap_soi),
        qflx_evap_tot=w(ev_soi, qflx_evap_tot),
        qflx_ev_snow=w(ev_snow, qflx_ev_snow),
        qflx_ev_soil=w(ev_soil, qflx_ev_soil),
        qflx_ev_h2osfc=w(ev_h2osfc, qflx_ev_h2osfc),
        t_ref2m=w(t2m, t_ref2m), q_ref2m=w(q2m, q_ref2m),
        rh_ref2m=w(rh2m, rh_ref2m))
