"""Saturation vapor pressure/humidity and temperature derivatives.

Counterpart of ``elmkernels_tpu/physics/qsat.py``: 8th-order Lowe-style
polynomials with water (0..100 C) and ice (-75..0 C) branches
(reference ``src/physics/qsat_impl.hh:6-78``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference.elm import constants as c

# water vapor es coefficients (T >= 0 C)
_A = (6.11213476, 0.444007856, 0.143064234e-01, 0.264461437e-03,
      0.305903558e-05, 0.196237241e-07, 0.892344772e-10, -0.373208410e-12,
      0.209339997e-15)
# water vapor d(es)/dT
_B = (0.444017302, 0.286064092e-01, 0.794683137e-03, 0.121211669e-04,
      0.103354611e-06, 0.404125005e-09, -0.788037859e-12, -0.114596802e-13,
      0.381294516e-16)
# ice es (T < 0 C)
_C = (6.11123516, 0.503109514, 0.188369801e-01, 0.420547422e-03,
      0.614396778e-05, 0.602780717e-07, 0.387940929e-09, 0.149436277e-11,
      0.262655803e-14)
# ice d(es)/dT
_D = (0.503277922, 0.377289173e-01, 0.126801703e-02, 0.249468427e-04,
      0.313703411e-06, 0.257180651e-08, 0.133268878e-10, 0.394116744e-13,
      0.498070196e-16)


def _horner(coeffs, x):
    acc = torch.full_like(x, coeffs[-1])
    for a in reversed(coeffs[:-1]):
        acc = a + x * acc
    return acc


class QSatOut(NamedTuple):
    es: torch.Tensor    # saturation vapor pressure [Pa]
    esdT: torch.Tensor  # d(es)/dT [Pa/K]
    qs: torch.Tensor    # saturation specific humidity [kg/kg]
    qsdT: torch.Tensor  # d(qs)/dT [1/K]


def qsat(T, p) -> QSatOut:
    td = torch.clamp(T - c.TFRZ, -75.0, 100.0)
    water = td >= 0.0
    es = torch.where(water, _horner(_A, td), _horner(_C, td)) * 100.0
    esdT = torch.where(water, _horner(_B, td), _horner(_D, td)) * 100.0
    vp = 1.0 / (p - 0.378 * es)
    vp1 = 0.622 * vp
    vp2 = vp1 * vp
    return QSatOut(es, esdT, es * vp1, esdT * vp2 * p)
