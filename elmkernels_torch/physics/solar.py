"""Solar geometry: declination, instantaneous and timestep-averaged cosine
of the solar zenith angle, and daylength.

Counterpart of ``elmkernels_tpu/physics/solar.py`` (reference
``src/physics/incident_shortwave.cc:14-121`` and ``day_length.cc``).  The
daylength latitude-clamp fix and its ``elm_clamp_quirk`` opt-out are kept
as in the JAX package (see its module docstring and PARITY.md).
"""

from __future__ import annotations

import torch

from elmkernels_torch import constants as c
from elmkernels_torch.physics.math_utils import const

_TWO_PI = 2.0 * c.ELM_PI
_PI = c.ELM_PI
_F64_EPS = 2.220446049250313e-16


def declination_angle_sin(doy):
    """Reference: incident_shortwave.cc:17."""
    return 23.45 * _PI / 180.0 * torch.sin(_TWO_PI * (284.0 + doy) / 365.0)


def coszen(latrad, lonrad, jday):
    """Instantaneous cos(zenith), floored at 0.001.

    Reference: incident_shortwave.cc:20-24.
    """
    decrad = declination_angle_sin(torch.floor(jday))
    cosz = (torch.sin(latrad) * torch.sin(decrad)
            - torch.cos(latrad) * torch.cos(decrad)
            * torch.cos((jday - torch.floor(jday)) * _TWO_PI + lonrad))
    return torch.clamp(cosz, min=0.001)


def _ensure_tan_defined(var):
    half = _PI / 2.0
    return torch.where(var == half, var - 1.0e-05,
                       torch.where(var == -half, var + 1.0e-05, var))


def average_cosz(latrad, lonrad, dt, jday):
    """Timestep-averaged cos(zenith) by hour-angle integration.

    Reference: incident_shortwave.cc:34-121 (``average_cosz`` chain).
    ``jday`` is a 0-d tensor; the result is [ncol].
    """
    dtrad = dt * _TWO_PI / 86400.0
    t_start = (jday - torch.floor(jday)) * _TWO_PI + lonrad - _PI
    t_start = torch.where(t_start >= _PI, t_start - _TWO_PI,
                          torch.where(t_start < -_PI, t_start + _TWO_PI,
                                      t_start))
    t_end = t_start + dtrad
    declin = declination_angle_sin(torch.floor(jday))
    cos_h_raw = (-torch.tan(_ensure_tan_defined(latrad))
                 * torch.tan(_ensure_tan_defined(declin)))
    cos_h = torch.where(
        cos_h_raw <= -1.0, _PI,
        torch.where(cos_h_raw >= 1.0, 0.0,
                    torch.acos(torch.clamp(cos_h_raw, -1.0, 1.0))))

    # hour angles (incident_shortwave.cc:62-95)
    case1 = (t_end >= _PI) & (t_start <= _PI) & (_PI - cos_h <= dtrad)
    case2 = (t_end >= -_PI) & (t_start <= -_PI) & (_PI - cos_h <= dtrad)

    ha0_1 = torch.clamp(t_start, -cos_h, cos_h)
    ha1_1 = cos_h
    ha2_1 = _TWO_PI - cos_h
    ha3_1 = torch.clamp(t_end, _TWO_PI - cos_h, _TWO_PI + cos_h)

    ha0_2 = torch.clamp(t_start, -_TWO_PI - cos_h, -_TWO_PI + cos_h)
    ha1_2 = -_TWO_PI + cos_h
    ha2_2 = -cos_h
    ha3_2 = torch.clamp(t_end, -cos_h, cos_h)

    ts_wrap = torch.where(t_start > _PI, t_start - _TWO_PI,
                          torch.where(t_start < -_PI, t_start + _TWO_PI,
                                      t_start))
    te_wrap = torch.where(t_end > _PI, t_end - _TWO_PI,
                          torch.where(t_end < -_PI, t_end + _TWO_PI, t_end))
    ha0_3 = torch.clamp(ts_wrap, -cos_h, cos_h)
    ha1_3 = torch.clamp(te_wrap, -cos_h, cos_h)

    ha0 = torch.where(case1, ha0_1, torch.where(case2, ha0_2, ha0_3))
    ha1 = torch.where(case1, ha1_1, torch.where(case2, ha1_2, ha1_3))
    ha2 = torch.where(case1, ha2_1, torch.where(case2, ha2_2, 0.0))
    ha3 = torch.where(case1, ha3_1, torch.where(case2, ha3_2, 0.0))

    aa = torch.sin(latrad) * torch.sin(declin)
    bb = torch.cos(latrad) * torch.cos(declin)
    val = ((aa * (ha1 - ha0) + bb * (torch.sin(ha1) - torch.sin(ha0)))
           / dtrad
           + (aa * (ha3 - ha2) + bb * (torch.sin(ha3) - torch.sin(ha2)))
           / dtrad)
    return torch.where((ha1 > ha0) | (ha3 > ha2), val, 0.0)


def daylength(lat, decl, elm_clamp_quirk: bool = False):
    """Daylength in seconds.  Reference: day_length.cc (``daylength``);
    ``decl`` is a tensor or a Python float."""
    secs_per_radian = 13750.9871
    lat_epsilon = 10.0 * _F64_EPS
    pole = _PI / 2.0
    offset_pole = pole - lat_epsilon
    sign = 1.0 if elm_clamp_quirk else -1.0
    my_lat = torch.clamp(torch.clamp(lat, min=sign * offset_pole),
                         max=offset_pole)
    if not isinstance(decl, torch.Tensor):
        decl = const(float(decl), lat)
    temp = torch.clamp(-(torch.sin(my_lat) * torch.sin(decl))
                       / (torch.cos(my_lat) * torch.cos(decl)), -1.0, 1.0)
    return 2.0 * secs_per_radian * torch.acos(temp)


def max_daylength(lat, elm_clamp_quirk: bool = False):
    """Reference: day_length.cc (``max_daylength``)."""
    return torch.where(
        lat < 0.0, daylength(lat, -0.409571, elm_clamp_quirk),
        daylength(lat, 0.409571, elm_clamp_quirk))
