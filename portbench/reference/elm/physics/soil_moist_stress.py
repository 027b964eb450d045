"""Root-zone soil moisture stress (btran) and per-layer root resistance.

Counterpart of ``elmkernels_tpu/physics/soil_moist_stress.py`` (reference
``src/physics/soil_moist_stress_impl.hh:5-135``).  PERCHROOT/PERCHROOT_ALT
are static config (both 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.elm import constants as c
from portbench.reference.elm.physics.math_utils import safe_div


def soil_suction(smpsat, s, bsw):
    """Reference: ``soil_moist_stress_impl.hh:22-23``."""
    return -smpsat * s ** (-bsw)


def calc_effective_soilporosity(watsat, h2osoi_ice, dz):
    """Effective porosity = watsat - vol_ice, per soil layer [ncol, nlevgrnd].

    Reference: ``soil_moist_stress_impl.hh:60-73``.
    """
    i0 = c.NLEVSNO
    vol_ice = torch.minimum(
        watsat, h2osoi_ice[:, i0:] / (c.DENICE * dz[:, i0:]))
    return watsat - vol_ice


def calc_volumetric_h2oliq(eff_por, h2osoi_liq, dz):
    """Volumetric liquid water content per soil layer [ncol, nlevgrnd].

    Reference: ``soil_moist_stress_impl.hh:75-85``.
    """
    i0 = c.NLEVSNO
    return torch.minimum(eff_por,
                         h2osoi_liq[:, i0:] / (dz[:, i0:] * c.DENH2O))


class RootMoistStressOut(NamedTuple):
    rootr: torch.Tensor  # [ncol, nlevgrnd]
    btran: torch.Tensor


def calc_root_moist_stress(h2osoi_liqvol, rootfr, t_soisno, tc_stress,
                           sucsat, watsat, bsw, smpso, smpsc, eff_porosity,
                           altmax_indx, altmax_lastyear_indx,
                           btran) -> RootMoistStressOut:
    """Per-layer root water stress and integrated transpiration factor.

    Reference: ``soil_moist_stress_impl.hh:87-133``; ``h2osoi_liqvol`` is
    soil-only (layer 0 = top soil).
    """
    i0 = c.NLEVSNO
    t_soil = t_soisno[:, i0:]

    wet = (h2osoi_liqvol > 0.0) & (t_soil > c.TFRZ + tc_stress)
    s_node = torch.clamp(
        safe_div(h2osoi_liqvol, eff_porosity, eff_porosity > 0.0), min=0.01)
    smp_node = torch.maximum(torch.as_tensor(smpsc, dtype=s_node.dtype,
                                             device=s_node.device),
                             soil_suction(sucsat, s_node, bsw))
    rresis = torch.clamp(
        (eff_porosity / watsat) * (smp_node - smpsc) / (smpso - smpsc),
        max=1.0)
    rootr = torch.where(wet, rootfr * rresis, 0.0)

    btran_new = btran + torch.sum(torch.clamp(rootr, min=0.0) * wet, dim=-1)
    pos = btran_new > 0.0
    rootr = torch.where(pos[:, None],
                        rootr / torch.where(pos, btran_new, 1.0)[:, None],
                        0.0)
    return RootMoistStressOut(rootr, btran_new)
