"""Wrappers of the ``ci_hybrid_solve`` CUDA kernels (csrc/ci_hybrid_solve.cu).

They replace the masked-batch ``hybrid_solve_plain`` of
``elmkernels_torch/physics/photosynthesis.py`` (the JAX package's
``photosynthesis.py:hybrid_solve``, once the Pallas kernel
``ops/ci_solver.py:ci_hybrid_solve``) for tensors on the card:

- :func:`ci_hybrid_solve` (K1) launches the solve;
- :func:`ci_hybrid_solve_jvp` (K1-T) launches its tangent version, float64
  only: the solve on (value, tangent) pairs, leaf by leaf on lanes that
  take a new leaf as soon as theirs ends (:func:`jvp_layout`);
- :class:`CiSolve` is the ``torch.autograd.Function`` the step calls: its
  forward launches K1, its ``jvp`` K1-T, so that ``torch.func.jvp`` through
  the step carries the tangent through the solve.  On CPU tensors it runs
  the plain versions (``hybrid_solve_plain`` and ``hybrid_solve_jvp_plain``).

``ci_hybrid_solve.launches`` and ``ci_hybrid_solve_jvp.launches`` count the
kernels' launches.  Both wrappers refuse a tensor that carries a tangent.
"""

from __future__ import annotations

import ctypes

import torch

from elmkernels_torch.ops import build, tangents
from elmkernels_torch.physics import photosynthesis as psn
from elmkernels_torch.physics.photosynthesis import CiEnv, PsnOut

_MODES = {"c3": 0, "c4": 1, "mixed": 2}
_FUNCS = {torch.float64: "ci_hybrid_solve_f64",
          torch.float32: "ci_hybrid_solve_f32"}
_P = ctypes.c_void_p


def _ptrs(tensors):
    return (_P * len(tensors))(*[t.data_ptr() for t in tensors])


def _inputs(name, x0_init, env, mode, enabled, dtypes):
    """The checked, contiguous inputs of a launch: (x0, env list, enabled)."""
    if not x0_init.is_cuda:
        raise ValueError(f"{name} takes CUDA tensors")
    tangents.refuse(name, "elmkernels_torch.ops.ci_solver.CiSolve",
                    (x0_init, enabled, *env))
    if mode not in _MODES:
        raise ValueError(f"unknown photosynthesis mode {mode!r}")
    dtype = x0_init.dtype
    if dtype not in dtypes:
        raise TypeError(f"{name} takes {' or '.join(map(str, dtypes))}, "
                        f"not {dtype}")
    n = x0_init.shape[0]
    dev = x0_init.device

    def prep(t):
        t = torch.as_tensor(t, device=dev)
        if t.device != dev or t.dtype != dtype or t.shape != (n,):
            raise ValueError(f"{name}: every CiEnv field must be a [{n}] "
                             f"{dtype} tensor on {dev}")
        return t.contiguous()

    en = enabled.to(device=dev, dtype=torch.bool).contiguous()
    if en.shape != (n,):
        raise ValueError(f"{name}: enabled must be [n]")
    return prep(x0_init), [prep(v) for v in env], en, prep


def ci_hybrid_solve(x0_init, env: CiEnv, mode: str, enabled):
    """The per-leaf ci root solve on the card: returns ``(ci, PsnOut,
    secant iterations per leaf)`` exactly as ``hybrid_solve_plain`` with a
    zero ``out_init``.  All inputs are [n] tensors on one CUDA device, in
    float64 or float32 (one dtype); ``enabled`` is bool."""
    x0, envs, en, _ = _inputs("ci_hybrid_solve", x0_init, env, mode,
                              enabled, _FUNCS)
    n, dev, dtype = x0.shape[0], x0.device, x0.dtype
    outs = [torch.empty(n, dtype=dtype, device=dev) for _ in range(7)]
    iters = torch.empty(n, dtype=torch.int32, device=dev)
    fn = getattr(build.load("ci_hybrid_solve"), _FUNCS[dtype])
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, _P, _P, _P, _P, _P]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_MODES[mode], n, _ptrs(envs), x0.data_ptr(), en.data_ptr(),
             _ptrs(outs + [iters]), stream)
    build.check(err, "ci_hybrid_solve")
    ci_hybrid_solve.launches += 1
    return outs[0], PsnOut(*outs[1:]), iters


ci_hybrid_solve.launches = 0


def ci_hybrid_solve_jvp(x0_init, dx0, env: CiEnv, denv: CiEnv, mode: str,
                        enabled, sched=None):
    """K1 and its tangent on the card, float64: returns ``(ci, PsnOut,
    iterations, dci, tangent PsnOut)``, what ``torch.func.jvp`` of
    ``hybrid_solve_plain`` along ``(dx0, denv)`` gives.

    ``sched``: the launch's counters, two zeroed int64 on the card
    (allocated here when None).  Each launch has its own, so launches on
    several streams do not share one; after the launch ``sched[1]`` holds
    the evaluation steps its warps took (a step: one evaluation by every
    lane that holds a leaf)."""
    x0, envs, en, prep = _inputs("ci_hybrid_solve_jvp", x0_init, env, mode,
                                 enabled, (torch.float64,))
    tangents.refuse("ci_hybrid_solve_jvp",
                    "elmkernels_torch.ops.ci_solver.CiSolve", (dx0, *denv))
    dx, denvs = prep(dx0), [prep(v) for v in denv]
    n, dev = x0.shape[0], x0.device
    outs = [torch.empty(n, dtype=torch.float64, device=dev)
            for _ in range(14)]
    iters = torch.empty(n, dtype=torch.int32, device=dev)
    if sched is None:
        sched = torch.zeros(2, dtype=torch.int64, device=dev)
    elif (sched.device != dev or sched.dtype != torch.int64
          or sched.shape != (2,)):
        raise ValueError(f"ci_hybrid_solve_jvp: sched must be a [2] int64 "
                         f"tensor on {dev}")
    fn = build.load("ci_hybrid_solve").ci_hybrid_solve_jvp_f64
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong, _P, _P, _P, _P, _P, _P,
                   _P, _P, _P]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(_MODES[mode], n, _ptrs(envs), _ptrs(denvs), x0.data_ptr(),
             dx.data_ptr(), en.data_ptr(), _ptrs(outs[:7] + [iters]),
             _ptrs(outs[7:]), sched.data_ptr(), stream)
    build.check(err, "ci_hybrid_solve_jvp")
    ci_hybrid_solve_jvp.launches += 1
    return (outs[0], PsnOut(*outs[1:7]), iters, outs[7],
            PsnOut(*outs[8:]))


ci_hybrid_solve_jvp.launches = 0


def jvp_layout() -> dict:
    """What K1-T's launch chooses on the current card: threads and dynamic
    shared memory a block, resident blocks a SM, SMs (the persistent
    grid is their product, capped at the chunks' need)."""
    fn = build.load("ci_hybrid_solve").ci_hybrid_solve_jvp_layout
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    build.check(fn(out), "ci_hybrid_solve_jvp_layout")
    keys = ("threads", "smem_bytes_per_block", "blocks_per_sm", "sms")
    return dict(zip(keys, out))


def _solve(x0, env, mode, enabled):
    """K1 for CUDA tensors, its plain version for CPU tensors."""
    if x0.is_cuda:
        return ci_hybrid_solve(x0, env, mode, enabled)
    return psn.hybrid_solve_plain(x0, env, mode, enabled)


def _solve_jvp(x0, dx0, env, denv, mode, enabled):
    """K1-T for CUDA tensors, its plain version for CPU tensors."""
    if x0.is_cuda:
        return ci_hybrid_solve_jvp(x0, dx0, env, denv, mode, enabled)
    return psn.hybrid_solve_jvp_plain(x0, dx0, env, denv, mode, enabled)


class CiSolve(torch.autograd.Function):
    """The ci solve as a differentiable function of ``x0`` and the 19
    ``CiEnv`` fields (separate arguments: a NamedTuple argument is not
    traversed for tangents).  Outputs: ci, the six ``PsnOut`` fields and
    the iteration counts (not differentiable).  Forward mode only: the JAX
    package has no reverse mode through the step."""

    @staticmethod
    def forward(mode, x0, enabled, *env):
        ci, out, it = _solve(x0, CiEnv(*env), mode, enabled)
        return (ci, *out, it)

    @staticmethod
    def setup_context(ctx, inputs, output):
        mode, x0, enabled, *env = inputs
        ctx.mode = mode
        ctx.save_for_forward(x0, enabled, *env)
        ctx.mark_non_differentiable(output[-1])

    @staticmethod
    def jvp(ctx, _, dx0, __, *denv):
        x0, enabled, *env = (tangents.primal(t) for t in ctx.saved_tensors)
        with tangents.plain_dispatch():
            dx0 = (torch.zeros_like(x0) if dx0 is None
                   else tangents.primal(dx0))
            denv = CiEnv(*(torch.zeros_like(v) if d is None
                           else tangents.primal(d)
                           for v, d in zip(env, denv)))
            _, _, _, dci, dout = _solve_jvp(x0, dx0, CiEnv(*env), denv,
                                            ctx.mode, enabled)
        return (dci, *dout, None)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the ci solve has no reverse mode (nor has the JAX package's "
            "step); differentiate the step with torch.func.jvp")


def solve(x0_init, env: CiEnv, mode: str, enabled):
    """``(ci, PsnOut, iterations)`` through :class:`CiSolve`: the step's
    entry point on the card."""
    res = CiSolve.apply(mode, x0_init, enabled, *env)
    return res[0], PsnOut(*res[1:7]), res[7]
