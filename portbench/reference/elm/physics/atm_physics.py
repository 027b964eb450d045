"""Derived atmospheric forcing: time interpolation, humidity/longwave/
shortwave/precipitation processing, and constitutive air properties.

Counterpart of ``elmkernels_tpu/physics/atm_physics.py`` (reference
``src/physics/atm_physics_impl.hh:1-300``).  Each ``process_*`` takes the
two bracketing raw forcing slices [ncol] plus scalar interpolation weights
and returns the derived forcing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.elm import constants as c
from portbench.reference.elm.physics.math_utils import rdiv

# Lowe (1977) saturation vapor pressure polynomials (impl:219-244)
_AW = (6.107799961, 4.436518521e-01, 1.428945805e-02, 2.650648471e-04,
       3.031240396e-06, 2.034080948e-08, 6.136820929e-11)
_AI = (6.109177956, 5.034698970e-01, 1.886013408e-02, 4.176223716e-04,
       5.824720280e-06, 4.838803174e-08, 1.838826904e-10)


def _poly(coeffs, x):
    acc = torch.full_like(x, coeffs[-1])
    for a in reversed(coeffs[:-1]):
        acc = a + x * acc
    return acc


def tdc(t):
    """K -> C clipped to [-50, 50].  Reference: impl:213-214."""
    return torch.clamp(t - c.TFRZ, -50.0, 50.0)


def esatw(t):
    """Saturation vapor pressure over water [Pa].  Reference: impl:218-229."""
    return 100.0 * _poly(_AW, t)


def esati(t):
    """Saturation vapor pressure over ice [Pa].  Reference: impl:233-244."""
    return 100.0 * _poly(_AI, t)


def interp_forcing(wt1, wt2, forc1, forc2):
    """Reference: impl:206-210."""
    return forc1 * wt1 + forc2 * wt2


def process_tbot(wt1, wt2, tbot1, tbot2):
    """Air temperature and potential temperature.  Reference: impl:37-44."""
    t = torch.clamp(interp_forcing(wt1, wt2, tbot1, tbot2), max=323.0)
    return t, t  # forc_tbot, forc_thbot


def process_pbot(wt1, wt2, pbot1, pbot2):
    """Air pressure.  Reference: impl:55-60."""
    return torch.clamp(interp_forcing(wt1, wt2, pbot1, pbot2), min=4.0e4)


def process_qbot(wt1, wt2, qbot1, qbot2, forc_tbot, forc_pbot,
                 is_rh: bool = False):
    """Specific humidity; RH inputs converted via Lowe esat.

    Reference: impl:73-84.
    """
    q = torch.clamp(interp_forcing(wt1, wt2, qbot1, qbot2), min=1.0e-9)
    if is_rh:
        e = torch.where(forc_tbot > c.TFRZ, esatw(tdc(forc_tbot)),
                        esati(tdc(forc_tbot)))
        qsat = 0.622 * e / (forc_pbot - 0.378 * e)
        q = q * qsat / 100.0
    return q


def process_flds(wt1, wt2, flds1, flds2, forc_pbot, forc_qbot, forc_tbot):
    """Downward longwave with bad-data fallback.  Reference: impl:99-110."""
    flds = interp_forcing(wt1, wt2, flds1, flds2)
    e = forc_pbot * forc_qbot / (0.622 + 0.378 * forc_qbot)
    ea = 0.70 + 5.95e-5 * 0.01 * e * torch.exp(rdiv(1500.0, forc_tbot))
    synth = ea * c.STEBOL * forc_tbot ** 4.0
    return torch.where((flds <= 50.0) | (flds >= 600.0), synth, flds)


class SolarOut(NamedTuple):
    forc_solad: torch.Tensor  # [ncol, 2]
    forc_solai: torch.Tensor


def process_fsds(fsds, coszen) -> SolarOut:
    """Split incident shortwave into vis/nir direct/diffuse.

    Reference: impl:124-143.
    """
    swndr = torch.clamp(fsds * coszen * 0.5, min=0.0)
    swndf = swndr
    swvdr = swndr
    swvdf = swndr
    rv = torch.clamp(0.17639 + 0.00380 * swvdr - 9.0039e-06 * swvdr ** 2.0
                     + 8.1351e-09 * swvdr ** 3.0, 0.01, 0.99)
    rn = torch.clamp(0.29548 + 0.00504 * swndr - 1.4957e-05 * swndr ** 2.0
                     + 1.4881e-08 * swndr ** 3.0, 0.01, 0.99)
    solad = torch.stack([rv * swvdr, rn * swndr], dim=-1)
    solai = torch.stack([(1.0 - rv) * swvdf, (1.0 - rn) * swndf], dim=-1)
    return SolarOut(solad, solai)


def process_prec(prec, forc_tbot):
    """Rain/snow partition around freezing.  Reference: impl:156-164."""
    frac = torch.clamp((forc_tbot - c.TFRZ) * 0.5, 0.0, 1.0)
    p = torch.clamp(prec, min=0.0)
    return frac * p, (1.0 - frac) * p  # rain, snow


def process_wind(wt1, wt2, wind1, wind2):
    """Reference: impl:176-182."""
    return interp_forcing(wt1, wt2, wind1, wind2), 0.0  # u, v


def process_zbot(ncol, dtype=torch.float64, device=None):
    """Forcing heights, hardwired 30 m.  Reference: impl:194-203."""
    h = torch.full((ncol,), 30.0, dtype=dtype, device=device)
    return h, h, h, h  # forc_hgt, _u, _t, _q


def derive_forc_vp(forc_qbot, forc_pbot):
    """Reference: impl:249-254."""
    return forc_qbot * forc_pbot / (0.622 + 0.378 * forc_qbot)


def derive_forc_rho(forc_pbot, forc_qbot, forc_tbot):
    """Reference: impl:257-262."""
    return ((forc_pbot - 0.378 * derive_forc_vp(forc_qbot, forc_pbot))
            / (c.RAIR * forc_tbot))


def derive_forc_po2(forc_pbot):
    """Reference: impl:266-267."""
    return c.O2_MOLAR_CONST * forc_pbot


def derive_forc_pco2(forc_pbot):
    """Reference: impl:271-272."""
    return c.CO2_PPMV * 1.0e-6 * forc_pbot
