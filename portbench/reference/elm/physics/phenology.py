"""Satellite phenology interpolation with snow-burial adjustment.

Counterpart of ``elmkernels_tpu/physics/phenology.py`` (reference
``src/physics/phenology_physics_impl.hh``, from ELM's
SatellitePhenologyMod.F90).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.elm import constants as c


class PhenologyOut(NamedTuple):
    tlai: torch.Tensor
    tsai: torch.Tensor
    htop: torch.Tensor
    hbot: torch.Tensor
    elai: torch.Tensor
    esai: torch.Tensor
    frac_veg_nosno_alb: torch.Tensor


def compute_phenology(mlai1, mlai2, msai1, msai2, mhtop1, mhtop2, mhbot1,
                      mhbot2, snow_depth, frac_sno, vtype, wt1,
                      wt2) -> PhenologyOut:
    """Interpolate monthly LAI/SAI/heights and bury by snow
    (Wang & Zeng 2007 for short vegetation).  m*1/m*2 are the two
    bracketing monthly slices [ncol]; ``vtype`` is an int64 [ncol] tensor.
    """
    veg = vtype != c.NOVEG
    tlai = torch.where(veg, wt1 * mlai1 + wt2 * mlai2, 0.0)
    tsai = torch.where(veg, wt1 * msai1 + wt2 * msai2, 0.0)
    htop = torch.where(veg, wt1 * mhtop1 + wt2 * mhtop2, 0.0)
    hbot = torch.where(veg, wt1 * mhbot1 + wt2 * mhbot2, 0.0)

    tall = (vtype > c.NOVEG) & (vtype <= c.NBRDLF_DCD_BRL_SHRUB)
    ol = torch.clamp(torch.clamp(snow_depth - hbot, min=0.0),
                     max=torch.clamp(htop - hbot, min=0.0))
    fb_tall = 1.0 - ol / torch.clamp(htop - hbot, min=1.e-06)
    fb_short = 1.0 - torch.clamp(snow_depth, 0.0, 0.2) / 0.2
    fb = torch.where(tall, fb_tall, fb_short)

    elai = torch.clamp(tlai * (1.0 - frac_sno) + tlai * fb * frac_sno,
                       min=0.0)
    esai = torch.clamp(tsai * (1.0 - frac_sno) + tsai * fb * frac_sno,
                       min=0.0)
    elai = torch.where(elai < 0.05, 0.0, elai)
    esai = torch.where(esai < 0.05, 0.0, esai)
    frac_veg_nosno_alb = ((elai + esai) >= 0.05).long()
    return PhenologyOut(tlai, tsai, htop, hbot, elai, esai,
                        frac_veg_nosno_alb)
