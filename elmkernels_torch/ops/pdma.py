"""Wrapper of the ``pdma_solve`` CUDA kernel (csrc/pdma_solve.cu).

It replaces ``pdma_solve_plain`` of
``elmkernels_torch/physics/soil_temperature.py`` (the JAX package's
``soil_temperature.py:pdma_solve``) for tensors on the card.
``pdma_solve.launches`` counts the kernel's launches.  :class:`PdmaSolve`
is the ``torch.autograd.Function`` the step calls: its ``jvp`` launches the
kernel again for the tangent (dx = A^-1 (db - dA x)).
"""

from __future__ import annotations

import ctypes

import torch

from elmkernels_torch.ops import build, tangents
from elmkernels_torch.physics import soil_temperature as stp

ROWS, BANDS = 21, 5
# the kernel moves whole tiles of columns by bulk copy, which needs
# 16-byte aligned addresses
ALIGN = 16


def _aligned(t):
    """``t`` contiguous at a 16-byte aligned address.  A contiguous view
    with a storage offset (e.g. ``big[1:]``) may start off alignment; it is
    copied into a fresh tensor, which the allocator aligns to 256 bytes.
    The main path passes fresh tensors, which need no copy."""
    t = t.contiguous()
    return t if t.data_ptr() % ALIGN == 0 else t.clone()


def pdma_solve(lhs, rhs):
    """Solve the batched 21-row pentadiagonal systems ``lhs`` [ncol, 21, 5]
    (bands: 2nd super, super, diag, sub, 2nd sub) with ``rhs`` [ncol, 21],
    both float64 on one CUDA device.  Returns x [ncol, 21]."""
    if not (lhs.is_cuda and rhs.is_cuda) or lhs.device != rhs.device:
        raise ValueError("pdma_solve takes CUDA tensors on one device")
    tangents.refuse("pdma_solve", "elmkernels_torch.ops.pdma.PdmaSolve",
                    (lhs, rhs))
    if lhs.dtype != torch.float64 or rhs.dtype != torch.float64:
        raise TypeError("pdma_solve takes float64")
    ncol = lhs.shape[0]
    if lhs.shape != (ncol, ROWS, BANDS) or rhs.shape != (ncol, ROWS):
        raise ValueError(f"pdma_solve: lhs {tuple(lhs.shape)} / rhs "
                         f"{tuple(rhs.shape)} are not [n, 21, 5] / [n, 21]")
    lhs, rhs = _aligned(lhs), _aligned(rhs)
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


def _solve(lhs, rhs):
    return (pdma_solve(lhs, rhs) if lhs.is_cuda
            else stp.pdma_solve_plain(lhs, rhs))


class PdmaSolve(torch.autograd.Function):
    """The pentadiagonal solve as a differentiable function of ``lhs`` and
    ``rhs``.  Tangent rule: differentiating A x = b gives
    dx = A^-1 (db - dA x), one more solve with the same ``lhs`` (the
    banded mat-vec is plain tensor arithmetic).  On CPU tensors it solves
    with ``pdma_solve_plain``.  Forward mode only."""

    @staticmethod
    def forward(lhs, rhs):
        return _solve(lhs, rhs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs, output)

    @staticmethod
    def jvp(ctx, dlhs, drhs):
        lhs, _, x = (tangents.primal(t) for t in ctx.saved_tensors)
        with tangents.plain_dispatch():
            r = (torch.zeros_like(x) if drhs is None
                 else tangents.primal(drhs))
            if dlhs is not None:
                r = r - stp.band_matvec(tangents.primal(dlhs), x)
            return _solve(lhs, r)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "the pentadiagonal solve has no reverse mode (nor has the JAX "
            "package's step); differentiate the step with torch.func.jvp")


def solve(lhs, rhs):
    """x through :class:`PdmaSolve`: the step's entry point on the card."""
    return PdmaSolve.apply(lhs, rhs)


def layout() -> dict:
    """What the kernel's launch chooses on the current card: columns per
    tile, pipeline stages, dynamic shared memory per block, resident
    blocks per SM and SMs (so the grid is their product, capped at the
    number of tiles)."""
    fn = build.load("pdma_solve").pdma_solve_layout
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    build.check(fn(out), "pdma_solve_layout")
    keys = ("tile_columns", "stages", "smem_bytes_per_block",
            "blocks_per_sm", "sms")
    return dict(zip(keys, out))
