"""Pedotransfer functions: soil hydraulic and thermal constants from
sand/clay/organic content (Cosby et al. 1984 + organic-matter mixing).

Counterpart of ``elmkernels_tpu/physics/soil_texture.py`` (reference
``src/physics/soil_texture_hydraulic_model_impl.hh:4-118``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.elm import constants as c
from portbench.reference.elm.physics.math_utils import rdiv


class SoilHydraulicsOut(NamedTuple):
    watsat: torch.Tensor
    bsw: torch.Tensor
    sucsat: torch.Tensor
    watdry: torch.Tensor
    watopt: torch.Tensor
    watfc: torch.Tensor
    tkmg: torch.Tensor
    tkdry: torch.Tensor
    csol: torch.Tensor


def pedotransfer(pct_sand, pct_clay):
    """Cosby et al. (1984) Table 5.  Reference: impl:5-15."""
    watsat = 0.489 - 0.00126 * pct_sand
    bsw = 2.91 + 0.159 * pct_clay
    sucsat = 10.0 * 10.0 ** (1.88 - 0.0131 * pct_sand)
    xksat = 0.0070556 * 10.0 ** (-0.884 + 0.0153 * pct_sand)
    return watsat, bsw, sucsat, xksat


def soil_hydraulic_params(pct_sand, pct_clay, zsoi,
                          om_frac) -> SoilHydraulicsOut:
    """Organic-matter-mixed hydraulic + thermal constants per layer.

    Reference: impl:17-97 (``soil_hydraulic_params``).
    """
    zsapric = 0.5
    pcalpha = 0.5
    pcbeta = 0.139
    om_tkd = 0.05
    om_tkm = 0.25
    om_csol = 2.5

    watsat, bsw, sucsat, xksat = pedotransfer(pct_sand, pct_clay)
    om_watsat = torch.clamp(0.93 - 0.1 * (zsoi / zsapric), min=0.83)
    om_b = torch.clamp(2.7 + 9.3 * (zsoi / zsapric), max=12.0)
    om_sucsat = torch.clamp(10.3 - 0.2 * (zsoi / zsapric), max=10.1)
    om_hksat = torch.clamp(0.28 - 0.2799 * (zsoi / zsapric), min=0.0001)

    bulk_den = (1.0 - watsat) * 2.7e3
    tkm = ((1.0 - om_frac) * (8.8 * pct_sand + 2.92 * pct_clay)
           / (pct_sand + pct_clay) + om_tkm * om_frac)
    watsat = (1.0 - om_frac) * watsat + om_watsat * om_frac
    bsw = (1.0 - om_frac) * (2.91 + 0.159 * pct_clay) + om_frac * om_b
    sucsat = (1.0 - om_frac) * sucsat + om_sucsat * om_frac

    perc_norm = (1.0 - pcalpha) ** (-pcbeta)
    perc_frac = torch.where(
        om_frac > pcalpha,
        perc_norm * torch.clamp(om_frac - pcalpha, min=0.0) ** pcbeta, 0.0)
    uncon_frac = (1.0 - om_frac) + (1.0 - perc_frac) * om_frac
    den = ((1.0 - om_frac) / xksat
           + ((1.0 - perc_frac) * om_frac) / om_hksat)
    uncon_hksat = torch.where(
        om_frac < 1.0, uncon_frac / torch.where(den != 0.0, den, 1.0), 0.0)
    hksat = uncon_frac * uncon_hksat + (perc_frac * om_frac) * om_hksat

    tkmg = tkm ** (1.0 - watsat)
    tkdry = (((0.135 * bulk_den + 64.7) / (2.7e3 - 0.947 * bulk_den))
             * (1.0 - om_frac) + om_tkd * om_frac)
    csol = ((1.0 - om_frac) * (2.128 * pct_sand + 2.385 * pct_clay)
            / (pct_sand + pct_clay) + om_csol * om_frac) * 1.0e6

    watdry = watsat * rdiv(316230.0, sucsat) ** (-1.0 / bsw)
    watopt = watsat * rdiv(158490.0, sucsat) ** (-1.0 / bsw)
    watfc = watsat * rdiv(0.1, hksat * c.SECSPDAY) ** (1.0 / (2.0 * bsw + 3.0))
    return SoilHydraulicsOut(watsat, bsw, sucsat, watdry, watopt, watfc,
                             tkmg, tkdry, csol)


def init_soil_hydraulics(organic_max, pct_sand, pct_clay, organic,
                         zsoi_soil) -> SoilHydraulicsOut:
    """All-layer initialization: organic mixing over NLEVSOI layers, then
    the deepest-soil texture for the bedrock-adjacent layers with
    csol = bedrock.  Reference: impl:99-118 (``init_soil_hydraulics``).
    """
    csol_bedrock = 2.0e6
    om_frac = (organic / organic_max) ** 2.0

    nextend = c.NLEVGRND - c.NLEVSOI
    sand_ext = torch.cat(
        [pct_sand, pct_sand[:, -1:].repeat(1, nextend)], dim=1)
    clay_ext = torch.cat(
        [pct_clay, pct_clay[:, -1:].repeat(1, nextend)], dim=1)
    om_ext = torch.cat(
        [om_frac, om_frac.new_zeros((om_frac.shape[0], nextend))], dim=1)

    out = soil_hydraulic_params(sand_ext, clay_ext, zsoi_soil, om_ext)
    lev = torch.arange(c.NLEVGRND, device=zsoi_soil.device)[None, :]
    csol = torch.where(lev >= c.NLEVSOI, csol_bedrock, out.csol)
    return out._replace(csol=csol)
