"""Cold-start initialization: soil temperature/water, root fraction,
topography factors, and per-step init — batched.

Counterpart of ``elmkernels_tpu/physics/init_state.py`` (reference
``src/physics/init_soil_state_impl.hh``, ``init_topography_impl.hh`` and
``init_timestep_impl.hh``); its snow-layer initialization from a snow
depth is not ported yet, as the model cold-starts without snow.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from elmkernels_torch import constants as c
from elmkernels_torch.physics.math_utils import levels, rdiv, take_layer

_NSNO = c.NLEVSNO


def init_soil_temp(land: c.LandType, snl, ncol, dtype=torch.float64):
    """Cold-start temperature profile + t_grnd (``init_soil_temp``)."""
    ice = c.ltype_mask(land, c.ISTICE, c.ISTICE_MEC)
    wet = c.ltype_mask(land, c.ISTWET)
    t_soil = 250.0 if ice else (277.0 if wet else 274.0)
    lev = levels(c.NLEVTOT, snl)[None, :]
    snow_active = (lev < _NSNO) & (lev >= (_NSNO - snl)[:, None])
    zero = torch.zeros((ncol, c.NLEVTOT), dtype=dtype, device=snl.device)
    t = torch.where(lev >= _NSNO, t_soil,
                    torch.where(snow_active, 250.0, zero))
    t_grnd = take_layer(t, _NSNO - snl)
    return t, t_grnd


def init_soilh2o_state(land: c.LandType, snl, watsat, t_soisno, dz):
    """Cold-start soil water from volumetric content (soil/crop path of
    ``init_soilh2o_state``)."""
    bed = levels(c.NLEVGRND, watsat)[None, :] >= c.NLEVBED
    if c.ltype_mask(land, c.ISTSOIL, c.ISTCROP):
        vol0 = torch.where(bed, 0.0, torch.full_like(watsat, 0.15))
    elif c.ltype_mask(land, c.ISTWET):
        vol0 = torch.where(bed, 0.0, torch.ones_like(watsat))
    else:
        vol0 = torch.ones_like(watsat)
    h2osoi_vol = torch.minimum(vol0.expand_as(watsat), watsat)

    dz_soil = dz[:, _NSNO:]
    frozen = t_soisno[:, _NSNO:] <= c.TFRZ
    ice_soil = torch.where(frozen, dz_soil * c.DENICE * h2osoi_vol, 0.0)
    liq_soil = torch.where(frozen, 0.0, dz_soil * c.DENH2O * h2osoi_vol)

    active = levels(_NSNO, dz)[None, :] >= (_NSNO - snl)[:, None]
    ice_snow = torch.where(active, dz[:, :_NSNO] * 250.0, 0.0)
    liq_snow = torch.zeros_like(ice_snow)

    h2osoi_ice = torch.cat([ice_snow, ice_soil], dim=1)
    h2osoi_liq = torch.cat([liq_snow, liq_soil], dim=1)
    return h2osoi_vol, h2osoi_liq, h2osoi_ice


def init_vegrootfr(vtype, roota_par, rootb_par, zi_soil):
    """Zeng (2001) root fraction profile [ncol, NLEVGRND]; ``zi_soil``
    holds soil interfaces.  NOVEG columns get an all-zero profile."""
    ncol = zi_soil.shape[0]
    out = zi_soil.new_zeros((ncol, c.NLEVGRND))
    for i in range(c.NLEVSOI - 1):
        out[:, i] = 0.5 * (torch.exp(-roota_par * zi_soil[:, i])
                           + torch.exp(-rootb_par * zi_soil[:, i])
                           - torch.exp(-roota_par * zi_soil[:, i + 1])
                           - torch.exp(-rootb_par * zi_soil[:, i + 1]))
    out[:, c.NLEVSOI - 1] = 0.5 * (
        torch.exp(-roota_par * zi_soil[:, c.NLEVSOI - 1])
        + torch.exp(-rootb_par * zi_soil[:, c.NLEVSOI - 1]))
    noveg = torch.as_tensor(vtype, device=zi_soil.device) == c.NOVEG
    noveg = noveg[:, None] if noveg.ndim else noveg
    return torch.where(noveg, 0.0, out)


def init_topo_slope(raw_topo_slope):
    return torch.clamp(raw_topo_slope, min=0.2)


def init_melt_factor(land: c.LandType, topo_std):
    if c.ltype_mask(land, c.ISTICE_MEC):
        return torch.full_like(topo_std, 10.0)
    return rdiv(200.0, torch.clamp(topo_std, min=10.0))


def init_micro_sigma(topo_slope):
    slopebeta = 3.0
    slopemax = 0.4
    slope0 = slopemax ** (-1.0 / slopebeta)
    return (topo_slope + slope0) ** (-slopebeta)


class InitTimestepOut(NamedTuple):
    do_capsnow: torch.Tensor
    frac_veg_nosno: torch.Tensor
    frac_iceold: torch.Tensor


def init_timestep(land: c.LandType, veg_active, frac_veg_nosno_alb, snl,
                  h2osno, h2osoi_ice, h2osoi_liq,
                  frac_iceold) -> InitTimestepOut:
    """Per-step resets: snow capping flag, exposed-vegetation flag, ice
    fraction of snow from previous step (``init_timestep_impl.hh``)."""
    do_capsnow = (h2osno > c.H2OSNO_MAX).long()
    frac_veg_nosno = torch.where(veg_active, frac_veg_nosno_alb, 0)
    active = levels(_NSNO, snl)[None, :] >= (_NSNO - snl)[:, None]
    tot = h2osoi_liq[:, :_NSNO] + h2osoi_ice[:, :_NSNO]
    frac = h2osoi_ice[:, :_NSNO] / torch.where(tot != 0.0, tot, 1.0)
    frac_iceold = torch.where(active, frac, frac_iceold[:, :_NSNO])
    return InitTimestepOut(do_capsnow, frac_veg_nosno, frac_iceold)
