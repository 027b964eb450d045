"""Absorbed, transmitted, and reflected solar radiation — batched over
columns.

Counterpart of ``elmkernels_tpu/physics/surface_radiation.py`` (reference
``src/physics/surface_radiation_impl.hh:5-240``).  Band loops (numrad=2)
run on the trailing axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.elm import constants as c
from portbench.reference.elm.physics.math_utils import levels


class TotalAbsorbedOut(NamedTuple):
    sabv: torch.Tensor
    fsa: torch.Tensor
    sabg: torch.Tensor
    sabg_soil: torch.Tensor
    sabg_snow: torch.Tensor
    trd: torch.Tensor  # [ncol, numrad] transmitted direct flux onto ground
    tri: torch.Tensor  # [ncol, numrad] transmitted diffuse flux onto ground


def total_absorbed_radiation(land: c.LandType, snl, ftdd, ftid, ftii,
                             forc_solad, forc_solai, fabd, fabi, albsod,
                             albsoi, albsnd, albsni, albgrd,
                             albgri) -> TotalAbsorbedOut:
    """Canopy-absorbed and ground-absorbed solar radiation by band
    (``surface_radiation_impl.hh:28-73``)."""
    cad = forc_solad * fabd
    cai = forc_solai * fabi
    sabv = torch.sum(cad + cai, dim=-1)
    fsa = sabv

    trd = forc_solad * ftdd
    tri = forc_solad * ftid + forc_solai * ftii

    sabg_soil = torch.sum(trd * (1.0 - albsod) + tri * (1.0 - albsoi),
                          dim=-1)
    sabg_snow = torch.sum(trd * (1.0 - albsnd) + tri * (1.0 - albsni),
                          dim=-1)
    sabg = torch.sum(trd * (1.0 - albgrd) + tri * (1.0 - albgri), dim=-1)
    fsa = fsa + sabg

    no_snow = snl == 0
    if c.SUBGRIDFLAG == 0:
        no_snow = torch.ones_like(no_snow)
    sabg_snow = torch.where(no_snow, sabg, sabg_snow)
    sabg_soil = torch.where(no_snow, sabg, sabg_soil)
    return TotalAbsorbedOut(sabv, fsa, sabg, sabg_soil, sabg_snow, trd, tri)


def layer_absorbed_radiation(land: c.LandType, snl, sabg, sabg_snow,
                             snow_depth, flx_absdv, flx_absdn, flx_absiv,
                             flx_absin, trd, tri) -> torch.Tensor:
    """Absorbed solar flux per snow layer + top soil layer (``sabg_lyr``,
    [ncol, NLEVSNO+1]), from the SNICAR flux factors with the 60/40 or
    75/25 redistribution when the factors disagree with the layer count
    (``surface_radiation_impl.hh:75-175``)."""
    nsno = c.NLEVSNO
    lev = levels(nsno + 1, snl)[None, :]

    # CASE 2: snow layers present — SNICAR flux factors
    sabg_lyr = (flx_absdv * trd[:, 0:1] + flx_absdn * trd[:, 1:2]
                + flx_absiv * tri[:, 0:1] + flx_absin * tri[:, 1:2])
    active = lev >= (nsno - snl)[:, None]
    sabg_snl_sum = torch.sum(torch.where(active, sabg_lyr, 0.0), dim=-1)

    # redistribution when stored factors mismatch the current snow pack
    mismatch = torch.abs(sabg_snl_sum - sabg_snow) > 0.00001
    one_layer = snl == 1
    top = (nsno - snl)[:, None]
    s = sabg_snow[:, None]
    redis_1 = torch.where(lev == nsno - 1, s * 0.6,
                          torch.where(lev == nsno, s * 0.4, 0.0))
    redis_n = torch.where(lev == top, s * 0.75,
                          torch.where(lev == top + 1, s * 0.25, 0.0))
    redis = torch.where(one_layer[:, None], redis_1, redis_n)
    sabg_lyr = torch.where(mismatch[:, None], redis, sabg_lyr)

    if c.SUBGRIDFLAG == 0:
        shallow = snow_depth < 0.1
        shal_1 = torch.where(lev == nsno - 1, sabg[:, None], 0.0)
        shal = torch.where(one_layer[:, None], shal_1, redis_n)
        sabg_lyr = torch.where(shallow[:, None], shal, sabg_lyr)

    # CASE 1: no snow layers — everything into the top soil layer
    bare = torch.where(lev == nsno, sabg[:, None], 0.0)
    return torch.where((snl == 0)[:, None], bare, sabg_lyr)


def reflected_radiation(land: c.LandType, albd, albi, forc_solad,
                        forc_solai) -> torch.Tensor:
    """Reflected solar radiation ``fsr`` (``surface_radiation_impl.hh:
    177-198``)."""
    return torch.sum(albd * forc_solad + albi * forc_solai, dim=-1)


class SunShadeOut(NamedTuple):
    parsun_z: torch.Tensor  # [ncol, nlevcan]
    parsha_z: torch.Tensor
    laisun_z: torch.Tensor
    laisha_z: torch.Tensor
    laisun: torch.Tensor
    laisha: torch.Tensor


def canopy_sunshade_fractions(land: c.LandType, nrad, elai, tlai_z, fsun_z,
                              forc_solad, forc_solai, fabd_sun_z, fabd_sha_z,
                              fabi_sun_z, fabi_sha_z) -> SunShadeOut:
    """Sunlit/shaded LAI and absorbed-PAR profiles per canopy layer
    (``surface_radiation_impl.hh:200-238``)."""
    ipar = 0  # PAR band index (visible)
    m = levels(tlai_z.shape[-1], nrad)[None, :] < nrad[:, None]

    laisun_z = torch.where(m, tlai_z * fsun_z, 0.0)
    laisha_z = torch.where(m, tlai_z * (1.0 - fsun_z), 0.0)
    laisun = torch.sum(laisun_z, dim=-1)
    laisha = torch.sum(laisha_z, dim=-1)

    parsun_z = torch.where(
        m, forc_solad[:, ipar:ipar + 1] * fabd_sun_z
        + forc_solai[:, ipar:ipar + 1] * fabi_sun_z, 0.0)
    parsha_z = torch.where(
        m, forc_solad[:, ipar:ipar + 1] * fabd_sha_z
        + forc_solai[:, ipar:ipar + 1] * fabi_sha_z, 0.0)
    return SunShadeOut(parsun_z, parsha_z, laisun_z, laisha_z, laisun, laisha)
