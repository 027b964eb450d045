"""Wrappers of the ``pdma_solve`` CUDA kernel (csrc/pdma_solve.cu), in
float64 (:func:`pdma_solve`) and float32 (:func:`pdma_solve_f32`).

They replace ``pdma_solve_plain`` of
``elmkernels_torch/physics/soil_temperature.py`` (the JAX package's
``soil_temperature.py:pdma_solve``) for tensors on the card; each counts
its launches on itself (``pdma_solve.launches``,
``pdma_solve_f32.launches``).  :class:`PdmaSolve` is the
``torch.autograd.Function`` the step calls, in the model's dtype: its
``jvp`` launches the float64 kernel again for the tangent
(dx = A^-1 (db - dA x)).
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


def _launch(name, symbol, dtype, lhs, rhs):
    """Launch the kernel's C entry ``symbol`` on ``lhs``/``rhs`` of
    ``dtype``; returns x.  ``name`` is the calling wrapper's."""
    if not (lhs.is_cuda and rhs.is_cuda) or lhs.device != rhs.device:
        raise ValueError(f"{name} takes CUDA tensors on one device")
    tangents.refuse(name, "elmkernels_torch.ops.pdma.PdmaSolve",
                    (lhs, rhs))
    if lhs.dtype != dtype or rhs.dtype != dtype:
        raise TypeError(f"{name} takes {str(dtype).replace('torch.', '')}")
    ncol = lhs.shape[0]
    if lhs.shape != (ncol, ROWS, BANDS) or rhs.shape != (ncol, ROWS):
        raise ValueError(f"{name}: lhs {tuple(lhs.shape)} / rhs "
                         f"{tuple(rhs.shape)} are not [n, 21, 5] / [n, 21]")
    lhs, rhs = _aligned(lhs), _aligned(rhs)
    x = torch.empty_like(rhs)
    fn = getattr(build.load("pdma_solve"), symbol)
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    err = fn(ncol, lhs.data_ptr(), rhs.data_ptr(), x.data_ptr(), stream)
    build.check(err, name)
    return x


def pdma_solve(lhs, rhs):
    """Solve the batched 21-row pentadiagonal systems ``lhs`` [ncol, 21, 5]
    (bands: 2nd super, super, diag, sub, 2nd sub) with ``rhs`` [ncol, 21],
    both float64 on one CUDA device.  Returns x [ncol, 21]."""
    x = _launch("pdma_solve", "pdma_solve_f64", torch.float64, lhs, rhs)
    pdma_solve.launches += 1
    return x


pdma_solve.launches = 0


def pdma_solve_f32(lhs, rhs):
    """:func:`pdma_solve` in float32: the same operations in the same
    order, rounded to float32 (the model's all-float32 mode)."""
    x = _launch("pdma_solve_f32", "pdma_solve_f32", torch.float32, lhs, rhs)
    pdma_solve_f32.launches += 1
    return x


pdma_solve_f32.launches = 0


def _solve(lhs, rhs):
    if not lhs.is_cuda:
        return stp.pdma_solve_plain(lhs, rhs)
    return (pdma_solve_f32(lhs, rhs) if lhs.dtype == torch.float32
            else pdma_solve(lhs, rhs))


class PdmaSolve(torch.autograd.Function):
    """The pentadiagonal solve as a differentiable function of ``lhs`` and
    ``rhs``.  Tangent rule: differentiating A x = b gives
    dx = A^-1 (db - dA x), one more solve with the same ``lhs`` (the
    banded mat-vec is plain tensor arithmetic), in float64 only.  On CPU
    tensors it solves with ``pdma_solve_plain``.  Forward mode only."""

    @staticmethod
    def forward(lhs, rhs):
        return _solve(lhs, rhs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs, output)

    @staticmethod
    def jvp(ctx, dlhs, drhs):
        lhs, _, x = (tangents.primal(t) for t in ctx.saved_tensors)
        if x.dtype != torch.float64:
            raise TypeError(
                f"PdmaSolve's tangent rule runs in float64 (the "
                f"tangent-linear model's type), not {x.dtype}: build the "
                f"model with dtype=torch.float64 to differentiate it")
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


def layout(dtype=torch.float64) -> dict:
    """What the kernel's launch in ``dtype`` chooses on the current card:
    columns per tile, pipeline stages, dynamic shared memory per block,
    resident blocks per SM and SMs (so the grid is their product, capped
    at the number of tiles)."""
    fn = build.load("pdma_solve").pdma_solve_layout
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 5)()
    itemsize = torch.empty((), dtype=dtype).element_size()
    build.check(fn(itemsize, out), "pdma_solve_layout")
    keys = ("tile_columns", "stages", "smem_bytes_per_block",
            "blocks_per_sm", "sms")
    return dict(zip(keys, out))
