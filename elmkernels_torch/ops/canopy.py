"""Wrapper of K2, the canopy stability loop as one CUDA kernel
(csrc/canopy_stability.cu).

It replaces ``stability_iteration_plain`` of
``elmkernels_torch/physics/canopy_fluxes.py`` (the JAX package's
``canopy_fluxes.py:stability_iteration``, a masked ``lax.while_loop``) for
tensors on the card: the whole loop in one launch, both leaves'
photosynthesis and ci solves inlined, so a step launches it once and waits
on nothing (a persistent grid whose lanes take a new column as soon as
theirs stops; the source's header has the design).
``physics.canopy_fluxes.stability_iteration`` routes to it.

:func:`canopy_stability` takes ``stability_iteration``'s arguments and
returns its ``StabilityOut``; ``canopy_stability.launches`` counts its
launches.  It refuses a tensor that carries a tangent: the kernel has no
tangent version, and the dispatcher sends differentiated calls to the
plain loop.  :func:`kernel_inputs` lays the arguments out as the kernel
reads them, without copies: a 0-d input or trait goes as itself with a
stride of 0 (the CPU tests give the same layout to the kernel's host
build).  :func:`layout` and :func:`counters` read the launch's occupancy
and its lanes' use on the card.
"""

from __future__ import annotations

import ctypes

import torch

from elmkernels_torch import constants as c
from elmkernels_torch.ops import build, tangents
from elmkernels_torch.physics import friction_velocity as fv
from elmkernels_torch.physics import photosynthesis as psn

_MODES = {"c3": 0, "c4": 1, "mixed": 2}
_FUNCS = {torch.float64: "canopy_stability_f64",
          torch.float32: "canopy_stability_f32"}
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
# the launch functions' parameters (csrc/canopy_stability.cu's entry points):
# mode, KernelInputs.pointers, the counters and the stream
ARGTYPES = [ctypes.c_int, ctypes.c_longlong, _P, _P, _P, _P, _P,
            ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_longlong, _P,
            ctypes.c_int, ctypes.c_double, _P, _P, _P, _P, _P, _P, _P]
# the launch's counters (the source's kSched)
_SCHED = 5

# the kernel's per-column inputs, by stability_iteration's argument names
# (csrc/canopy_stability.cu's enum order); fveg is frac_veg_nosno in the
# loop's type
IN_FIELDS = (
    "frac_sno", "forc_hgt_u_patch", "forc_hgt_t_patch", "forc_hgt_q_patch",
    "fwet", "fdry", "laisun", "laisha", "forc_rho", "snow_depth", "soilbeta",
    "frac_h2osfc", "t_h2osfc", "sabv", "h2ocan", "htop", "air", "bir", "cir",
    "ur", "zldis", "displa", "elai", "esai", "t_grnd", "forc_pbot", "forc_q",
    "forc_th", "z0mg", "z0mv", "z0hv", "z0qv", "thm", "thv", "qg", "t10",
    "vcmaxcintsha", "vcmaxcintsun", "parsha_z", "parsun_z", "laisha_z",
    "laisun_z", "forc_pco2", "forc_po2", "dayl_factor", "btran", "el",
    "qsatl", "qsatldT", "taf", "qaf", "um", "obu", "delq", "t_veg", "fveg")
# [ncol, nlevcan] canopy-layer inputs of which the loop reads layer 0
_LAYERED = {"vcmaxcintsha", "vcmaxcintsun", "parsha_z", "parsun_z",
            "laisha_z", "laisun_z"}

# the Python-level constants of the loop (the kernel's Consts, in order):
# those Python computes with its math library are passed, not recomputed
CONSTS = (c.VKC, c.GRAV, c.CSOILC, c.CPAIR, c.HVAP, c.TFRZ, c.RGAS, c.ELM_PI,
          fv._ZETAM, fv._ZETAT, fv._PSI_M_ZETAM, fv._PSI_H_ZETAT,
          fv._ZETAM ** 0.333, fv._ZETAT ** -0.333, psn._SCO, psn._RSMAX0,
          psn._FNPS, psn._THETA_PSII)
_CONSTS = (ctypes.c_double * len(CONSTS))(*CONSTS)
# the kernel's inputs in order: IN_FIELDS, then the traits
_NAMES = (*IN_FIELDS, *psn.PFTPsnParams._fields)

# StabilityOut's [ncol] floating fields, in its order (itlef, ci and
# psn_iters come apart)
OUT_FIELDS = (
    "btran", "qflx_tran_veg", "qflx_evap_veg", "eflx_sh_veg", "wtg", "wtl0",
    "wta0", "wtal", "el", "qsatl", "qsatldT", "taf", "qaf", "um", "dth",
    "dqh", "obu", "temp1", "temp2", "temp12m", "temp22m", "tlbef", "delq",
    "dt_veg", "t_veg", "wtgq", "wtalq", "wtlq0", "wtaq0")


class KernelInputs:
    """The arguments of one launch, laid out as the kernel reads them:
    ``fields`` (IN_FIELDS order) and ``traits`` (PFTPsnParams order), each
    a [n] view or a 0-d tensor, with ``strides`` (elements between two
    columns, fields then traits: 0 for a 0-d tensor, so that every column
    reads its one value); ``t_soisno`` [n, nlevtot]; ``snl`` int32;
    ``soybean`` bool, [n] or 0-d, and its stride; ``ci_prev`` [2n] or None;
    and the scalars."""

    def __init__(self, mode, dtype, n, fields, traits, t_soisno, snl,
                 soybean, ci_prev, warm_start, dtime, snl_dtype):
        self.mode, self.dtype, self.n = mode, dtype, n
        self.fields, self.traits = fields, traits
        self.strides = [t.stride(0) if t.dim() else 0
                        for t in (*fields, *traits)]
        self.t_soisno, self.snl, self.soybean = t_soisno, snl, soybean
        self.ci_prev, self.warm_start, self.dtime = ci_prev, warm_start, dtime
        self.snl_dtype = snl_dtype

    def outputs(self):
        """Fresh outputs: OUT_FIELDS, itlef, ci, psn_iters."""
        n, dev = self.n, self.t_soisno.device
        outs = [torch.empty(n, dtype=self.dtype, device=dev)
                for _ in OUT_FIELDS]
        return (outs, torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(2 * n, dtype=self.dtype, device=dev),
                torch.empty(2 * n, dtype=torch.int32, device=dev))

    def pointers(self, outs, itlef, ci, psn_iters):
        """The launch function's arguments after ``mode`` (see the
        source's entry points)."""
        nin = len(IN_FIELDS)
        strides = self.strides
        return (self.n, _ptrs(self.fields), (_I64 * nin)(*strides[:nin]),
                _ptrs(self.traits), (_I64 * len(self.traits))(
                    *strides[nin:]),
                self.t_soisno.data_ptr(), self.t_soisno.shape[1], c.NLEVSNO,
                self.snl.data_ptr(), self.soybean.data_ptr(),
                self.soybean.stride(0) if self.soybean.ndim else 0,
                self.ci_prev.data_ptr() if self.ci_prev is not None
                else None, int(self.warm_start), self.dtime, _CONSTS,
                _ptrs(outs), itlef.data_ptr(), ci.data_ptr(),
                psn_iters.data_ptr())

    def result(self, outs, itlef, ci, psn_iters):
        """The outputs as ``StabilityOut``."""
        from elmkernels_torch.physics.canopy_fluxes import StabilityOut
        vals = dict(zip(OUT_FIELDS, outs))
        return StabilityOut(**vals, itlef=itlef.to(self.snl_dtype), ci=ci,
                            psn_iters=psn_iters)


def _ptrs(ts):
    return (_P * len(ts))(*[t.data_ptr() for t in ts])


def kernel_inputs(args: dict) -> KernelInputs:
    """``stability_iteration``'s arguments (by name) checked and laid out
    as the kernel reads them, without copies: every floating input in one
    type on one device, [ncol] (a view of layer 0 for a canopy-layer
    input) or 0-d; only ``frac_veg_nosno`` is converted to the loop's
    type, and ``t_soisno`` and ``ci_prev`` made contiguous where they are
    not."""
    name = "canopy_stability"
    t_grnd = args["t_grnd"]
    dtype, dev, n = t_grnd.dtype, t_grnd.device, t_grnd.shape[0]
    if dtype not in _FUNCS:
        raise TypeError(f"{name} takes float64 or float32, not {dtype}")
    mode = args.get("psn_mode") or psn.psn_mode_of(args["p"])
    if mode not in _MODES:
        raise ValueError(f"unknown photosynthesis mode {mode!r}")
    dtime = args["dtime"]
    if isinstance(dtime, torch.Tensor):
        raise TypeError(f"{name} takes dtime as a Python number (the plain "
                        f"loop divides by it as one)")

    def prep(k, t, shape=(n,)):
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(t, device=dev)
        if t.dtype is not dtype or t.device != dev:
            raise ValueError(f"{name}: {k} must be a {dtype} tensor on {dev}"
                             f", not {t.dtype} on {t.device}")
        if t.dim() == 2 and k in _LAYERED:
            t = t[:, 0]
        if t.dim() and t.shape != shape:
            raise ValueError(f"{name}: {k} must be {list(shape)} or a "
                             f"scalar, not {list(t.shape)}")
        return t

    given = [args[k] for k in IN_FIELDS[:-1]]
    given.append(args["frac_veg_nosno"].to(dtype))
    given.extend(args["p"])
    shape = (n,)
    laid = []
    for k, t in zip(_NAMES, given):
        # the common case inline: a tensor of the type on the device, [n]
        # or 0-d; anything else through prep, which converts or raises
        if (isinstance(t, torch.Tensor) and t.dtype is dtype
                and t.device == dev and (t.dim() == 0 or t.shape == shape)):
            laid.append(t)
        else:
            laid.append(prep(k, t))
    nin = len(IN_FIELDS)
    fields, traits = laid[:nin], laid[nin:]
    t_soisno = args["t_soisno"]
    t_soisno = prep("t_soisno", t_soisno, tuple(t_soisno.shape))
    if t_soisno.ndim != 2 or t_soisno.shape[0] != n:
        raise ValueError(f"{name}: t_soisno must be [{n}, nlevtot]")
    snl = args["snl"]
    if snl.shape != (n,) or snl.device != dev or snl.is_floating_point():
        raise ValueError(f"{name}: snl must be an integer [{n}] tensor on "
                         f"{dev}")
    soybean = torch.as_tensor(args["soybean"], device=dev)
    if soybean.device != dev or soybean.shape not in ((n,), ()):
        raise ValueError(f"{name}: soybean must be a [{n}] mask on {dev}")
    ci_prev = args.get("ci_prev")
    warm = bool(args.get("warm_start"))
    if warm and ci_prev is not None:
        ci_prev = prep("ci_prev", ci_prev, (2 * n,)).expand(2 * n)
        ci_prev = ci_prev.contiguous()
    else:
        ci_prev = None
    return KernelInputs(mode, dtype, n, fields, traits,
                        t_soisno.contiguous(),
                        snl.to(torch.int32).contiguous(),
                        soybean.to(torch.bool), ci_prev, warm,
                        float(dtime), snl.dtype)


def canopy_stability(land, p, dtime, snl, frac_veg_nosno, frac_sno,
                     forc_hgt_u_patch, forc_hgt_t_patch, forc_hgt_q_patch,
                     fwet, fdry, laisun, laisha, forc_rho, snow_depth,
                     soilbeta, frac_h2osfc, t_h2osfc, sabv, h2ocan, htop,
                     t_soisno, air, bir, cir, ur, zldis, displa, elai, esai,
                     t_grnd, forc_pbot, forc_q, forc_th, z0mg, z0mv, z0hv,
                     z0qv, thm, thv, qg, nrad, t10, tlai_z, vcmaxcintsha,
                     vcmaxcintsun, parsha_z, parsun_z, laisha_z, laisun_z,
                     forc_pco2, forc_po2, dayl_factor, btran, el, qsatl,
                     qsatldT, taf, qaf, um, obu, delq, t_veg,
                     psn_mode: str | None = None, *, soybean,
                     warm_start: bool = False, ci_prev=None):
    """``stability_iteration`` on the card in one launch: returns its
    ``StabilityOut`` exactly as ``stability_iteration_plain`` computes it
    (``nrad`` and ``tlai_z``, which the loop does not read, and ``land``
    are accepted for the same signature).  Every floating input is a
    float64 or float32 tensor (one type) on one CUDA device, [ncol] or a
    scalar; traits 0-d or [ncol]."""
    args = dict(locals())
    if not t_grnd.is_cuda:
        raise ValueError("canopy_stability takes CUDA tensors")
    tensors = [v for v in args.values() if isinstance(v, torch.Tensor)]
    tensors += list(p)
    tangents.refuse("canopy_stability",
                    "elmkernels_torch.physics.canopy_fluxes."
                    "stability_iteration", tensors,
                    instead="which runs the plain loop for such a call")
    k = kernel_inputs(args)
    outs = k.outputs()
    # the launch's own counters, from the caching allocator on its stream
    # (private to a graph under capture); the kernel zeroes them
    global _last_sched
    _last_sched = torch.empty(_SCHED, dtype=torch.int64, device=t_grnd.device)
    stream = torch.cuda.current_stream(t_grnd.device).cuda_stream
    err = _entry(k.dtype)(_MODES[k.mode], *k.pointers(*outs),
                          _last_sched.data_ptr(), stream)
    build.check(err, "canopy_stability")
    canopy_stability.launches += 1
    return k.result(*outs)


canopy_stability.launches = 0
_last_sched = None

_entries: dict = {}


def _entry(dtype):
    """K2's launch function for ``dtype``, its ctypes signature set once."""
    fn = _entries.get(dtype)
    if fn is None:
        fn = getattr(build.load("canopy_stability"), _FUNCS[dtype])
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _entries[dtype] = fn
    return fn


def layout(dtype=torch.float64, mode: str = "mixed") -> dict:
    """What K2's launch chooses on the current device for ``mode`` in
    ``dtype``: threads and dynamic shared memory bytes a block, resident
    blocks an SM, SMs, registers a thread and local (spilled) bytes a
    thread.  Needs a card."""
    lib = build.load("canopy_stability")
    out = (ctypes.c_int * 6)()
    build.check(lib.canopy_stability_layout(
        ctypes.c_int(dtype == torch.float64), ctypes.c_int(_MODES[mode]),
        out), "canopy_stability_layout")
    keys = ("threads", "smem_bytes", "blocks_per_sm", "sms", "registers",
            "local_bytes")
    return dict(zip(keys, out))


def counters() -> dict:
    """The counters of K2's last launch (of :func:`canopy_stability`),
    once it has ended (synchronizes its device): chunks claimed (with each
    warp's last, failed, claim), warp and lane rounds, warp and lane
    evaluation steps, and the lanes' use of each (the share of a warp's
    lanes that ran a pass's head or tail in its rounds, that evaluated in
    its evaluation steps).  Needs a card."""
    if _last_sched is None:
        raise RuntimeError("canopy_stability has not launched")
    torch.cuda.synchronize(_last_sched.device)
    chunks, wr, lr, we, le = _last_sched.tolist()
    return dict(chunks=chunks, warp_rounds=wr, lane_rounds=lr,
                warp_eval_steps=we, lane_eval_steps=le,
                round_lane_use=lr / (32 * wr) if wr else None,
                eval_lane_use=le / (32 * we) if we else None)
