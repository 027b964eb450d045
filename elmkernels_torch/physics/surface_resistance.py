"""Soil evaporative stress (beta) and leaf boundary-layer conductance.

Counterpart of ``elmkernels_tpu/physics/surface_resistance.py`` (reference
``src/physics/surface_resistance_impl.hh:5-63``).
"""

from __future__ import annotations

import torch

from elmkernels_torch import constants as c
from elmkernels_torch.physics.math_utils import rdiv


def calc_soilevap_stress(land: c.LandType, frac_sno, frac_h2osfc, watsat,
                         watfc, h2osoi_liq, h2osoi_ice, dz) -> torch.Tensor:
    """Lee & Pielke (1992) soil-evaporation beta factor, snow-modified.

    ``watsat``/``watfc`` are soil-only arrays (layer 0 = top soil layer);
    liq/ice/dz are combined snow+soil arrays.
    """
    wet_ice = c.ltype_mask(land, c.ISTWET, c.ISTICE, c.ISTICE_MEC)
    sc = c.ltype_mask(land, c.ISTSOIL, c.ISTCROP)
    if wet_ice is True:
        return torch.ones_like(frac_sno)
    if wet_ice is False and sc is False:
        return torch.zeros_like(frac_sno)

    i0 = c.NLEVSNO
    wx = (h2osoi_liq[:, i0] / c.DENH2O
          + h2osoi_ice[:, i0] / c.DENICE) / dz[:, i0]
    dry = wx < watfc[:, 0]
    fac_fc = torch.clamp(wx / watfc[:, 0], 0.01, 1.0)
    beta_dry = ((1.0 - frac_sno - frac_h2osfc) * 0.25
                * (1.0 - torch.cos(c.ELM_PI * fac_fc)) ** 2.0
                + frac_sno + frac_h2osfc)
    beta = torch.where(dry, beta_dry, 1.0)
    if sc is True:
        return beta
    # per column: soil/crop -> beta, wetland/ice -> 1, others -> 0
    return c.lsel(wet_ice, torch.ones_like(frac_sno),
                  c.lsel(sc, beta, torch.zeros_like(frac_sno)))


def getlblcef(rho, temp):
    """Leaf boundary-layer conductance coefficient.

    Reference: ``surface_resistance_impl.hh:48-61`` (``getlblcef``).
    """
    C = 120.0
    T0 = 291.25
    mu0 = 18.27e-6
    prandtl = 0.72
    mu = rdiv(mu0 * (T0 + C), temp + C) * (temp / T0) ** 1.5 / rho
    diffh2o = 0.229e-4 * (temp / 273.15) ** 1.75
    sc = mu / diffh2o
    return 2.0 / c.VKC * (sc / prandtl) ** (2.0 / 3.0)
