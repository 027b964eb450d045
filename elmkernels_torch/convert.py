"""Carry parameters and state between the JAX package and the port.

The JAX package's ``ModelParams``, ``ModelState``, ``PFTPsnParams``,
``PFTAlbParams`` and ``SnicarTables`` come in as dicts of numpy arrays or
floats (``{k: np.asarray(v) for k, v in nt._asdict().items()}``); nothing
of JAX is imported here.  Float fields become tensors of the given dtype on
the given device, integer fields int64 (``snl`` is int32 in the JAX
package).  :func:`to_numpy` is the inverse, for tests.
"""

from __future__ import annotations

import numpy as np
import torch

from elmkernels_torch.data.state import ModelParams, ModelState
from elmkernels_torch.physics.photosynthesis import PFTPsnParams
from elmkernels_torch.physics.snow_snicar import SnicarTables
from elmkernels_torch.physics.surface_albedo import PFTAlbParams


def _tensor(v, dtype, device):
    a = np.asarray(v)
    if a.dtype.kind in "iub":
        return torch.as_tensor(a.astype(np.int64), device=device)
    return torch.as_tensor(a.astype(np.float64), dtype=dtype, device=device)


def _fields(cls, d: dict, dtype, device):
    missing = set(cls._fields) - set(d)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return cls(**{k: _tensor(d[k], dtype, device) for k in cls._fields})


def state_from_numpy(d: dict, dtype=torch.float64, device=None) -> ModelState:
    return _fields(ModelState, d, dtype, device)


def params_from_numpy(d: dict, dtype=torch.float64,
                      device=None) -> ModelParams:
    return _fields(ModelParams, d, dtype, device)


def psn_from_numpy(d: dict, dtype=torch.float64,
                   device=None) -> PFTPsnParams:
    return _fields(PFTPsnParams, d, dtype, device)


def snicar_from_numpy(d: dict, dtype=torch.float64,
                      device=None) -> SnicarTables:
    return _fields(SnicarTables, d, dtype, device)


def alb_from_numpy(d: dict, dtype=torch.float64,
                   device=None) -> PFTAlbParams:
    """The per-band optics ([numrad] arrays) become tuples of 0-d tensors,
    the port's homogeneous-domain form."""
    def bands(v):
        return tuple(_tensor(x, dtype, device) for x in np.asarray(v))
    return PFTAlbParams(rhol=bands(d["rhol"]), rhos=bands(d["rhos"]),
                        taul=bands(d["taul"]), taus=bands(d["taus"]),
                        xl=_tensor(d["xl"], dtype, device))


def to_numpy(nt) -> dict:
    """A port NamedTuple as a dict of numpy arrays (tuples of tensors
    become arrays)."""
    def arr(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        if isinstance(v, (tuple, list)):
            return np.stack([arr(x) for x in v])
        if isinstance(v, dict):
            return {k: arr(x) for k, x in v.items()}
        return np.asarray(v)
    return {k: arr(v) for k, v in nt._asdict().items()}
