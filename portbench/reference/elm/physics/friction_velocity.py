"""Monin-Obukhov friction velocity and profile factors (Zeng et al. 1998).

Counterpart of ``elmkernels_tpu/physics/friction_velocity.py`` (reference
``src/physics/friction_velocity_impl.hh:13-175``).  All four regimes are
evaluated for every column and the applicable one is selected.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from portbench.reference.elm import constants as c
from portbench.reference.elm.physics.math_utils import rdiv

_ZETAM = 1.574  # transition point, wind profile
_ZETAT = 0.465  # transition point, temperature profile


def stability_func1(zeta):
    """psi_m used in the wind profile.  Reference: lines 16-23."""
    chik2 = torch.sqrt(torch.clamp(1.0 - 16.0 * zeta, min=0.0))
    chik = torch.sqrt(chik2)
    return (2.0 * torch.log((1.0 + chik) * 0.5)
            + torch.log((1.0 + chik2) * 0.5)
            - 2.0 * torch.atan(chik) + c.ELM_PI * 0.5)


def stability_func2(zeta):
    """psi_h used in the scalar profiles.  Reference: lines 26-32."""
    chik2 = torch.sqrt(torch.clamp(1.0 - 16.0 * zeta, min=0.0))
    return 2.0 * torch.log((1.0 + chik2) * 0.5)


def _sf1_scalar(zeta: float) -> float:
    chik2 = math.sqrt(max(1.0 - 16.0 * zeta, 0.0))
    chik = math.sqrt(chik2)
    return (2.0 * math.log((1.0 + chik) * 0.5) + math.log((1.0 + chik2) * 0.5)
            - 2.0 * math.atan(chik) + c.ELM_PI * 0.5)


def _sf2_scalar(zeta: float) -> float:
    chik2 = math.sqrt(max(1.0 - 16.0 * zeta, 0.0))
    return 2.0 * math.log((1.0 + chik2) * 0.5)


_PSI_M_ZETAM = _sf1_scalar(-_ZETAM)
_PSI_H_ZETAT = _sf2_scalar(-_ZETAT)


class MOLengthOut(NamedTuple):
    um: torch.Tensor
    obu: torch.Tensor


def monin_obukhov_length(ur, thv, dthv, zldis, z0m) -> MOLengthOut:
    """Initial wind-speed magnitude and Monin-Obukhov length.

    Reference: lines 34-59 (``monin_obukhov_length``).
    """
    wc = 0.5
    um = torch.where(dthv >= 0.0, torch.clamp(ur, min=0.1),
                     torch.sqrt(ur * ur + wc * wc))
    rib = c.GRAV * zldis * dthv / (thv * um * um)
    zeta_stable = torch.clamp(
        rib * torch.log(zldis / z0m)
        / (1.0 - 5.0 * torch.clamp(rib, max=0.19)), 0.01, 2.0)
    zeta_unstable = torch.clamp(rib * torch.log(zldis / z0m), -100.0, -0.01)
    zeta = torch.where(rib >= 0.0, zeta_stable, zeta_unstable)
    return MOLengthOut(um, zldis / zeta)


def _safe_log(x):
    return torch.log(torch.clamp(x, min=1e-300))


def _safe_npow(x, p):
    # pow of a possibly-negative base in a branch not selected
    return torch.clamp(x, min=1e-300) ** p


def friction_velocity_wind(forc_hgt_u_patch, displa, um, obu, z0m):
    """u* from the 4-regime wind profile.  Reference: lines 61-81."""
    zldis = forc_hgt_u_patch - displa
    zeta = zldis / obu

    very_unstable = c.VKC * um / (
        _safe_log(-_ZETAM * obu / z0m) - _PSI_M_ZETAM
        + stability_func1(z0m / obu)
        + 1.14 * (_safe_npow(-zeta, 0.333) - _ZETAM ** 0.333))
    unstable = c.VKC * um / (
        _safe_log(zldis / z0m) - stability_func1(zeta)
        + stability_func1(z0m / obu))
    stable = c.VKC * um / (
        _safe_log(zldis / z0m) + 5.0 * zeta - 5.0 * z0m / obu)
    very_stable = c.VKC * um / (
        _safe_log(obu / z0m) + 5.0 - 5.0 * z0m / obu
        + (5.0 * _safe_log(zeta) + zeta - 1.0))

    return torch.where(
        zeta < -_ZETAM, very_unstable,
        torch.where(zeta < 0.0, unstable,
                    torch.where(zeta <= 1.0, stable, very_stable)))


def _profile_factor(zldis, obu, z0):
    """Shared 4-regime scalar profile factor (temp/humidity variants)."""
    zeta = zldis / obu
    very_unstable = rdiv(c.VKC, (
        _safe_log(-_ZETAT * obu / z0) - _PSI_H_ZETAT
        + stability_func2(z0 / obu)
        + 0.8 * (_ZETAT ** -0.333 - _safe_npow(-zeta, -0.333))))
    unstable = rdiv(c.VKC, (
        _safe_log(zldis / z0) - stability_func2(zeta)
        + stability_func2(z0 / obu)))
    stable = rdiv(c.VKC, _safe_log(zldis / z0) + 5.0 * zeta - 5.0 * z0 / obu)
    very_stable = rdiv(c.VKC, (
        _safe_log(obu / z0) + 5.0 - 5.0 * z0 / obu
        + (5.0 * _safe_log(zeta) + zeta - 1.0)))
    return torch.where(
        zeta < -_ZETAT, very_unstable,
        torch.where(zeta < 0.0, unstable,
                    torch.where(zeta <= 1.0, stable, very_stable)))


def friction_velocity_temp(forc_hgt_t_patch, displa, obu, z0h):
    """Temperature profile factor temp1.  Reference: lines 83-102."""
    return _profile_factor(forc_hgt_t_patch - displa, obu, z0h)


def friction_velocity_humidity(forc_hgt_q_patch, forc_hgt_t_patch, displa,
                               obu, z0h, z0q, temp1):
    """Humidity profile factor temp2.  Reference: lines 104-128."""
    same = (forc_hgt_q_patch == forc_hgt_t_patch) & (z0q == z0h)
    return torch.where(same, temp1,
                       _profile_factor(forc_hgt_q_patch - displa, obu, z0q))


def friction_velocity_temp2m(obu, z0h):
    """2m temperature profile factor temp12m.  Reference: lines 130-148."""
    return _profile_factor(2.0 + z0h, obu, z0h)


def friction_velocity_humidity2m(obu, z0h, z0q, temp12m):
    """2m humidity profile factor temp22m.  Reference: lines 150-173."""
    return torch.where(z0q == z0h, temp12m,
                       _profile_factor(2.0 + z0q, obu, z0q))
