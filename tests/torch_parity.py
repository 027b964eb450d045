"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: synthetic
parameter files, JAX and port models built from them, numpy -> torch
conversion and a recursive closeness check.

Parity tolerance.  Loop-free f64 code matches to rtol 1e-10, the golden
tests' tolerance (PARITY.md preamble), with an absolute floor of 1e-12 for
quantities that cancel to roundoff near zero (canopy water on a drying
leaf reaches ~1e-20 kg/m2, where one side rounds to 1e-19 and the other
to 0).
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from elmkernels_torch import convert
from elmkernels_torch.data import synthetic

RTOL = 1.0e-10
ATOL = 1.0e-12


def write_files(directory):
    """The synthetic clm_params and SNICAR optics NetCDFs in
    ``directory``; returns (pft_path, snicar_path)."""
    pft = directory / "clm_params_synthetic.nc"
    snicar = directory / "snicar_optics_synthetic.nc"
    synthetic.write_clm_params(pft)
    synthetic.write_snicar_optics(snicar)
    return str(pft), str(snicar)


def jax_model(files, ncol, **flags):
    """The JAX package's Model on the CPU, built from the synthetic files."""
    from elmkernels_tpu.driver.model import Model
    with jax.default_device(jax.devices("cpu")[0]):
        return Model(ncol=ncol, pft_path=files[0], snicar_path=files[1],
                     **flags)


def torch_model(files, ncol, **flags):
    from elmkernels_torch.driver.model import Model
    return Model(ncol=ncol, pft_path=files[0], snicar_path=files[1],
                 device="cpu", **flags)


def nt_numpy(nt) -> dict:
    """A JAX NamedTuple as {field: numpy array}."""
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def carry_model(jm, tm):
    """Give the port model the JAX model's state."""
    tm.state = convert.state_from_numpy(nt_numpy(jm.state))


def to_torch(a):
    a = np.asarray(a)
    if a.dtype.kind in "iub":
        return torch.as_tensor(a.astype(np.int64) if a.dtype.kind != "b"
                               else a.copy())
    return torch.as_tensor(a.astype(np.float64))


def as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(j, t, rtol=RTOL, atol=ATOL, path="out"):
    """Recursively compare a JAX result ``j`` with a port result ``t``
    (NamedTuples, tuples, dicts, arrays, numbers); NaNs must coincide."""
    if isinstance(j, tuple) and hasattr(j, "_fields"):
        assert tuple(j._fields) == tuple(t._fields), path
        for k in j._fields:
            assert_close(getattr(j, k), getattr(t, k), rtol, atol,
                         f"{path}.{k}")
        return
    if isinstance(j, dict):
        assert set(j) == set(t), path
        for k in j:
            assert_close(j[k], t[k], rtol, atol, f"{path}[{k}]")
        return
    if isinstance(j, (tuple, list)):
        assert len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            assert_close(a, b, rtol, atol, f"{path}[{i}]")
        return
    if isinstance(j, str):
        assert j == t, (path, j, t)
        return
    a = as_numpy(j)
    b = as_numpy(t)
    if a.dtype.kind in "iub" and b.dtype.kind in "iub":
        np.testing.assert_array_equal(b.astype(np.int64),
                                      a.astype(np.int64), err_msg=path)
        return
    np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                               rtol=rtol, atol=atol, equal_nan=True,
                               err_msg=path)
