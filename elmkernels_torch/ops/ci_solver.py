"""Wrapper of the ``ci_hybrid_solve`` CUDA kernel (csrc/ci_hybrid_solve.cu).

It replaces the masked-batch ``hybrid_solve_plain`` of
``elmkernels_torch/physics/photosynthesis.py`` (the JAX package's
``photosynthesis.py:hybrid_solve``, once the Pallas kernel
``ops/ci_solver.py:ci_hybrid_solve``) for tensors on the card.
``ci_hybrid_solve.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from elmkernels_torch.ops import build
from elmkernels_torch.physics.photosynthesis import CiEnv, PsnOut

_MODES = {"c3": 0, "c4": 1, "mixed": 2}
_FUNCS = {torch.float64: "ci_hybrid_solve_f64",
          torch.float32: "ci_hybrid_solve_f32"}


def _bind(lib, fname):
    fn = getattr(lib, fname)
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ci_hybrid_solve(x0_init, env: CiEnv, mode: str, enabled):
    """The per-leaf ci root solve on the card: returns ``(ci, PsnOut,
    secant iterations per leaf)`` exactly as ``hybrid_solve_plain`` with a
    zero ``out_init``.  All inputs are [n] tensors on one CUDA device, in
    float64 or float32 (one dtype); ``enabled`` is bool."""
    if not x0_init.is_cuda:
        raise ValueError("ci_hybrid_solve takes CUDA tensors")
    if mode not in _MODES:
        raise ValueError(f"unknown photosynthesis mode {mode!r}")
    dtype = x0_init.dtype
    if dtype not in _FUNCS:
        raise TypeError(f"ci_hybrid_solve takes float64 or float32, "
                        f"not {dtype}")
    n = x0_init.shape[0]
    dev = x0_init.device

    def prep(t):
        t = torch.as_tensor(t, device=dev)
        if t.device != dev or t.dtype != dtype or t.shape != (n,):
            raise ValueError("ci_hybrid_solve: every CiEnv field must be "
                             f"a [{n}] {dtype} tensor on {dev}")
        return t.contiguous()

    envs = [prep(v) for v in env]
    x0 = prep(x0_init)
    en = enabled.to(device=dev, dtype=torch.bool).contiguous()
    if en.shape != (n,):
        raise ValueError("ci_hybrid_solve: enabled must be [n]")
    outs = [torch.empty(n, dtype=dtype, device=dev) for _ in range(7)]
    iters = torch.empty(n, dtype=torch.int32, device=dev)

    fn = _bind(build.load("ci_hybrid_solve"), _FUNCS[dtype])
    env_ptrs = (ctypes.c_void_p * len(envs))(*[t.data_ptr() for t in envs])
    out_ptrs = (ctypes.c_void_p * 8)(*[t.data_ptr() for t in outs],
                                     iters.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_MODES[mode], n, env_ptrs, x0.data_ptr(), en.data_ptr(),
             out_ptrs, stream)
    build.check(err, "ci_hybrid_solve")
    ci_hybrid_solve.launches += 1
    return outs[0], PsnOut(*outs[1:]), iters


ci_hybrid_solve.launches = 0
