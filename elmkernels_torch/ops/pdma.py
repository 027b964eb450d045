"""Wrapper of the ``pdma_solve`` CUDA kernel (csrc/pdma_solve.cu).

It replaces ``pdma_solve_plain`` of
``elmkernels_torch/physics/soil_temperature.py`` (the JAX package's
``soil_temperature.py:pdma_solve``) for tensors on the card.
``pdma_solve.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from elmkernels_torch.ops import build

ROWS, BANDS = 21, 5


def pdma_solve(lhs, rhs):
    """Solve the batched 21-row pentadiagonal systems ``lhs`` [ncol, 21, 5]
    (bands: 2nd super, super, diag, sub, 2nd sub) with ``rhs`` [ncol, 21],
    both float64 on one CUDA device.  Returns x [ncol, 21]."""
    if not (lhs.is_cuda and rhs.is_cuda) or lhs.device != rhs.device:
        raise ValueError("pdma_solve takes CUDA tensors on one device")
    if lhs.dtype != torch.float64 or rhs.dtype != torch.float64:
        raise TypeError("pdma_solve takes float64")
    ncol = lhs.shape[0]
    if lhs.shape != (ncol, ROWS, BANDS) or rhs.shape != (ncol, ROWS):
        raise ValueError(f"pdma_solve: lhs {tuple(lhs.shape)} / rhs "
                         f"{tuple(rhs.shape)} are not [n, 21, 5] / [n, 21]")
    lhs, rhs = lhs.contiguous(), rhs.contiguous()
    x = torch.empty_like(rhs)
    fn = build.load("pdma_solve").pdma_solve_f64
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    err = fn(ncol, lhs.data_ptr(), rhs.data_ptr(), x.data_ptr(), stream)
    build.check(err, "pdma_solve")
    pdma_solve.launches += 1
    return x


pdma_solve.launches = 0
