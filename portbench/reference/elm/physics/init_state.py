"""Cold-start initialization: snow layers and state, soil
temperature/water, root fraction, topography factors, and per-step init —
batched.

Counterpart of ``elmkernels_tpu/physics/init_state.py`` (reference
``src/physics/init_snow_state_impl.hh``, ``init_soil_state_impl.hh``,
``init_topography_impl.hh`` and ``init_timestep_impl.hh``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.elm import constants as c
from portbench.reference.elm.physics.math_utils import (levels, rdiv, safe_tanh,
                                                 take_layer)

_NSNO = c.NLEVSNO


class InitSnowLayersOut(NamedTuple):
    snl: torch.Tensor
    dz: torch.Tensor   # [ncol, NLEVSNO] snow part
    z: torch.Tensor
    zi: torch.Tensor   # [ncol, NLEVSNO+1] (zi[NLEVSNO] = 0)


def _select(conds, vals, default, like):
    """``jnp.select``: the value of the first true condition, else
    ``default``."""
    out = torch.full_like(like, default) if not isinstance(
        default, torch.Tensor) else default
    for cond, val in reversed(list(zip(conds, vals))):
        out = torch.where(cond, val, out)
    return out


def init_snow_layers(snow_depth, lakpoi: bool) -> InitSnowLayersOut:
    """Snow layer structure from an initial snow depth: the reference's
    8-interval depth ladder (``init_snow_state_impl.hh``,
    ``init_snow_layers``).  With snow, layers above the top active one
    keep the SPVAL sentinel; with none (or on a lake) everything is 0."""
    d = snow_depth
    ncol = d.shape[0]
    dz = torch.zeros((ncol, _NSNO), dtype=d.dtype, device=d.device)
    if lakpoi:
        return InitSnowLayersOut(torch.zeros_like(d, dtype=torch.int64), dz,
                                 torch.zeros_like(dz),
                                 d.new_zeros((ncol, _NSNO + 1)))

    snl = _select([d < 0.01, d <= 0.03, d <= 0.07, d <= 0.18, d <= 0.41],
                  [0, 1, 2, 3, 4], 5, torch.zeros_like(d, dtype=torch.int64))
    d4 = _select(
        [d < 0.01,
         d <= 0.03,               # snl=1: all in layer 4
         d <= 0.04,               # snl=2: half/half
         d <= 0.07,               # snl=2: 0.02 + rest
         d <= 0.12,               # snl=3
         d <= 0.18,               # snl=3
         d <= 0.29,               # snl=4
         d <= 0.41,               # snl=4
         d <= 0.64],              # snl=5
        [0.0, d, d / 2.0, d - 0.02, (d - 0.02) / 2.0, d - 0.07,
         (d - 0.07) / 2.0, d - 0.18, (d - 0.18) / 2.0], d - 0.41, d)
    d3 = _select(
        [d <= 0.03, d <= 0.04, d <= 0.07, d <= 0.12, d <= 0.18, d <= 0.29,
         d <= 0.41, d <= 0.64],
        [0.0, d / 2.0, 0.02, (d - 0.02) / 2.0, 0.05, (d - 0.07) / 2.0,
         0.11, (d - 0.18) / 2.0], 0.23, d)
    d2 = _select([d <= 0.07, d <= 0.18, d <= 0.41], [0.0, 0.02, 0.05], 0.11,
                 d)
    d1 = _select([d <= 0.18, d <= 0.41], [0.0, 0.02], 0.05, d)
    d0 = torch.where(d <= 0.41, 0.0, torch.full_like(d, 0.02))
    dz = torch.stack([d0, d1, d2, d3, d4], dim=1)

    top = _NSNO - snl
    inactive = levels(_NSNO, d)[None, :] < top[:, None]
    none = (d < 0.01)[:, None]
    dz = torch.where(none, 0.0, torch.where(inactive, c.SPVAL, dz))

    zi = torch.full((ncol, _NSNO + 1), c.SPVAL, dtype=d.dtype,
                    device=d.device)
    zi[:, _NSNO] = 0.0
    z = torch.full((ncol, _NSNO), c.SPVAL, dtype=d.dtype, device=d.device)
    for i in range(_NSNO - 1, -1, -1):
        act = i >= top
        z[:, i] = torch.where(act, zi[:, i + 1] - 0.5 * dz[:, i], z[:, i])
        zi[:, i] = torch.where(act, zi[:, i + 1] - dz[:, i], zi[:, i])
    z = torch.where(none, 0.0, z)
    zi = torch.where(none, 0.0, zi)
    return InitSnowLayersOut(snl, dz, z, zi)


def init_snow_state(land: c.LandType, snl, snow_depth, h2osno):
    """Initial ``frac_sno`` and ``snw_rds`` (``init_snow_state_impl.hh``,
    ``init_snow_state``; the other snow fields start at 0)."""
    if land.urbpoi:
        frac_sno = torch.clamp(snow_depth / 0.05, max=1.0)
    else:
        snowbd = torch.clamp(
            h2osno / torch.where(snow_depth > 0.0, snow_depth, 1.0),
            max=400.0)
        fmelt = snowbd / 100.0
        frac_sno = torch.where(
            snow_depth > 0.0,
            safe_tanh(snow_depth / (2.5 * c.ZLND * fmelt)), 0.0)
    lev = levels(_NSNO, snl)[None, :]
    active = lev >= (_NSNO - snl)[:, None]
    thin = ((snl == 0) & (h2osno > 0.0))[:, None] & (lev == _NSNO - 1)
    mask = active | thin
    snw_rds = torch.where(mask, snow_depth.new_full(mask.shape,
                                                    c.SNW_RDS_MIN), 0.0)
    return frac_sno, snw_rds


def init_soil_temp(land: c.LandType, snl, ncol, dtype=torch.float64):
    """Cold-start temperature profile + t_grnd (``init_soil_temp``)."""
    ice = c.ltype_mask(land, c.ISTICE, c.ISTICE_MEC)
    wet = c.ltype_mask(land, c.ISTWET)
    if isinstance(ice, bool):
        t_soil = 250.0 if ice else (277.0 if wet else 274.0)
    else:
        t_soil = torch.full(ice.shape, 274.0, dtype=dtype, device=ice.device)
        t_soil = torch.where(ice, 250.0, torch.where(wet, 277.0, t_soil))
        t_soil = t_soil[:, None]
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
    sc = c.ltype_mask(land, c.ISTSOIL, c.ISTCROP)
    wet = c.ltype_mask(land, c.ISTWET)
    if sc is True:
        vol0 = torch.where(bed, 0.0, torch.full_like(watsat, 0.15))
    elif wet is True:
        vol0 = torch.where(bed, 0.0, torch.ones_like(watsat))
    elif isinstance(sc, bool) and isinstance(wet, bool):
        vol0 = torch.ones_like(watsat)
    else:
        ones = torch.ones_like(watsat)
        vol0 = c.lsel(sc, torch.where(bed, 0.0, torch.full_like(watsat, 0.15)),
                      c.lsel(wet, torch.where(bed, 0.0, ones), ones))
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
    icemec = c.ltype_mask(land, c.ISTICE_MEC)
    if icemec is True:
        return torch.full_like(topo_std, 10.0)
    melt = rdiv(200.0, torch.clamp(topo_std, min=10.0))
    if icemec is False:
        return melt
    return c.lsel(icemec, torch.full_like(topo_std, 10.0), melt)


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
