"""Small numerical helpers shared by the port's physics modules.

Counterpart of ``elmkernels_tpu/physics/math_utils.py``.  Guarded
divisions and roots are made safe *before* the select, so the untaken side
of a ``torch.where`` never produces NaN/Inf that a later reduction could
pick up (the JAX package follows the same rule).
"""

from __future__ import annotations

import torch


_CONSTANTS: dict = {}


def const(values, like, dtype=None):
    """A constant (a number or a table) as a tensor on ``like``'s device,
    ``like``'s dtype unless ``dtype`` is given.  It is made once per
    (values, dtype, device) and kept, so a step that needs it makes no
    host-to-device copy, and so no host wait, after the first.  Callers
    must not write into it."""
    dtype = like.dtype if dtype is None else dtype
    key = (values, dtype, like.device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype,
                                           device=like.device)
    return t


def rdiv(num: float, den):
    """``num / den`` for a Python number over a tensor, divided as IEEE
    division.  PyTorch evaluates ``number / tensor`` as
    ``reciprocal(tensor) * number``, which rounds twice; the JAX package
    and the CUDA kernels divide once."""
    return torch.full_like(den, num) / den


def safe_div(num, den, cond=None, fill=0.0):
    """num/den where ``cond`` (default ``den != 0``) holds, else ``fill``."""
    if cond is None:
        cond = den != 0.0
    den_safe = torch.where(cond, den, 1.0)
    return torch.where(cond, num / den_safe, fill)


def safe_sqrt(x):
    """sqrt with its input clamped to >= 0."""
    return torch.sqrt(torch.clamp(x, min=0.0))


def safe_pow(x, p):
    """x**p with x clamped to >= 0 (the reference takes pow of guarded
    positives)."""
    return torch.clamp(x, min=0.0) ** p


def safe_tanh(x):
    """tanh with its input clamped to |x| <= 40 and output to [-1, 1]
    (bit-identical to plain tanh in f64; kept for parity with the JAX
    package's TPU-safe version)."""
    return torch.clamp(torch.tanh(torch.clamp(x, -40.0, 40.0)), -1.0, 1.0)


def take_layer(a, idx):
    """``a[n, L], idx[n] -> a[n, idx[n]]``; out-of-range indices give 0."""
    L = a.shape[1]
    ok = (idx >= 0) & (idx < L)
    safe = torch.clamp(idx, 0, L - 1).long()
    val = torch.gather(a, 1, safe[:, None])[:, 0]
    return torch.where(ok, val, 0.0)


def gather_layers(a, idx):
    """``a[n, L], idx[n, K] -> out[n, k] = a[n, idx[n, k]]``; out-of-range
    indices give 0."""
    L = a.shape[1]
    ok = (idx >= 0) & (idx < L)
    safe = torch.clamp(idx, 0, L - 1).long()
    return torch.where(ok, torch.gather(a, 1, safe), 0.0)


def levels(n, like):
    """``arange(n)`` as int64 on ``like``'s device."""
    return torch.arange(n, device=like.device)


def fill(like, value):
    """A tensor shaped and typed like ``like`` holding ``value``."""
    return torch.full_like(like, value)
