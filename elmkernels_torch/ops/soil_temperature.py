"""Wrapper of K7, the soil temperature module as one CUDA kernel
(csrc/soil_temperature.cu).

It replaces ``soil_temperature_block_plain`` of
``elmkernels_torch/physics/soil_temperature.py`` (the JAX package's
``driver/step.py`` chain after ``thermal_properties``: the surface heat
fluxes, the Crank-Nicolson system of the snow, surface-water and soil
layers and its pentadiagonal solve, the two phase changes and the ground
temperature, several hundred masked full-width operations) for tensors on
the card: one thread a column runs the whole module, in one launch.
``physics.soil_temperature.soil_temperature_block`` routes to it.

:func:`soil_temperature` takes ``soil_temperature_block``'s arguments and
returns its ``SoilTemperatureOut``; ``soil_temperature.launches`` counts its
launches.  It refuses a tensor that carries a tangent: the kernel has no
tangent version, and the dispatcher sends differentiated calls to the
plain chain.  :func:`kernel_inputs` lays the arguments out as the kernel
reads them, without copies: a 0-d input goes as itself with a stride of 0,
a layered input as itself with its row stride (the CPU tests give the same
layout to the kernel's host build).  The outputs are fresh tensors: no
input is written.  :func:`layout` reads the launch's registers, spills,
shared memory and resident blocks on the card.

The kernel runs a block of ``THREADS`` columns, one thread each, and
stages the block's rows through shared memory: each thread holds
``SLOTS`` values there (:func:`shared_bytes`).
"""

from __future__ import annotations

import ctypes

import torch

from elmkernels_torch import constants as c
from elmkernels_torch.ops import build, tangents
from elmkernels_torch.physics import soil_temperature as stp
from elmkernels_torch.physics.math_utils import const

_FUNCS = {torch.float64: "soil_temperature_f64",
          torch.float32: "soil_temperature_f32"}
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
# the launch functions' parameters (csrc/soil_temperature.cu's entry
# points): n, the inputs and their strides, snl, frac_veg_nosno and the
# supercooled-water mask with their strides, dtime, the constants, the
# outputs, imelt and the stream
ARGTYPES = [_I64, _P, _P, _P, _P, _P, _P, _I64, _P, _I64, ctypes.c_double,
            _P, _P, _P, _P, _P]

# the kernel's [ncol] inputs, by soil_temperature_block's argument names
# (csrc/soil_temperature.cu's enum order)
IN_FIELDS = (
    "frac_sno_eff", "frac_sno", "frac_h2osfc", "h2osfc", "h2osno",
    "int_snow", "snow_depth", "t_grnd", "t_h2osfc", "sabg_snow", "sabg_soil",
    "dlrad", "emg", "forc_lwrad", "htvp", "eflx_sh_soil", "qflx_ev_soil",
    "eflx_sh_h2osfc", "qflx_ev_h2osfc", "eflx_sh_snow", "qflx_ev_snow",
    "cgrnd", "dz_h2osfc", "c_h2osfc", "tk_h2osfc")
# the layered inputs, [ncol, L] with a row stride, by their widths L
LAYER_FIELDS = {
    "t_soisno": c.NLEVTOT, "h2osoi_liq": c.NLEVTOT,
    "h2osoi_ice": c.NLEVTOT, "dz": c.NLEVTOT, "z": c.NLEVTOT,
    "zi": c.NLEVTOT + 1, "tk": c.NLEVTOT, "cv": c.NLEVTOT,
    "sabg_lyr": c.NLEVSNO + 1, "watsat": c.NLEVGRND, "sucsat": c.NLEVGRND,
    "bsw": c.NLEVGRND}
# SoilTemperatureOut's [ncol] floating fields, in the kernel's order
OUT_FIELDS = (
    "sabg_chk", "dhsdT", "t_grnd", "t_h2osfc", "h2osfc", "int_snow",
    "h2osno", "snow_depth", "xmf_h2osfc", "qflx_h2osfc_to_ice",
    "eflx_h2osfc_to_snow", "xmf", "qflx_snomelt", "qflx_snow_melt")
# its layered floating fields, by their widths (imelt, int64, apart)
LAYER_OUT = {"fact": c.NLEVTOT, "t_soisno": c.NLEVTOT,
             "h2osoi_ice": c.NLEVTOT, "h2osoi_liq": c.NLEVTOT,
             "qflx_snofrz_lyr": c.NLEVSNO}
# the Python-level constants of the module (the kernel's Consts, in order)
CONSTS = (c.TFRZ, c.STEBOL, c.HFUS, c.GRAV, c.DENICE, c.CPWAT, stp.CNFAC,
          stp.CAPR)
_CONSTS = (ctypes.c_double * len(CONSTS))(*CONSTS)
# columns a block, a column's shared-memory slots, and the slot stride's
# padding (csrc/soil_temperature.cu's kB, kSlots and kLd - kB)
THREADS, SLOTS, _PAD = 64, 143, 1


def shared_bytes(dtype) -> int:
    """Dynamic shared memory of one K7 block in ``dtype``: the slots of its
    columns, then a byte a column for each layer's ``imelt``."""
    item = torch.empty((), dtype=dtype).element_size()
    return SLOTS * (THREADS + _PAD) * item + c.NLEVTOT * THREADS


class KernelInputs:
    """The arguments of one launch, laid out as the kernel reads them:
    ``fields`` (IN_FIELDS order), each [n] or 0-d, with ``strides`` (0 for
    a 0-d tensor); ``layers`` (LAYER_FIELDS order), each [n, L] with unit
    element stride, with ``row_strides``; ``snl`` and ``frac_veg_nosno``
    int64, the supercooled-water mask uint8 ([n] or 0-d); and
    ``dtime``."""

    def __init__(self, dtype, n, fields, layers, snl, fveg, scmask, dtime):
        self.dtype, self.n = dtype, n
        self.fields, self.layers = fields, layers
        self.strides = [_stride(t) for t in fields]
        self.row_strides = [t.stride(0) for t in layers]
        self.snl, self.fveg, self.scmask = snl, fveg, scmask
        self.dtime = dtime

    def outputs(self):
        """Fresh outputs: OUT_FIELDS, the layered ones (LAYER_OUT) and
        imelt."""
        n, dev, dt = self.n, self.snl.device, self.dtype
        return ([torch.empty(n, dtype=dt, device=dev) for _ in OUT_FIELDS],
                [torch.empty(n, w, dtype=dt, device=dev)
                 for w in LAYER_OUT.values()],
                torch.empty(n, c.NLEVTOT, dtype=torch.int64, device=dev))

    def pointers(self, outs, lay_out, imelt):
        """The launch function's arguments (see the source's entry
        points), without the stream."""
        return (self.n, _ptrs(self.fields),
                (_I64 * len(self.fields))(*self.strides),
                _ptrs(self.layers),
                (_I64 * len(self.layers))(*self.row_strides),
                self.snl.data_ptr(), self.fveg.data_ptr(), _stride(self.fveg),
                self.scmask.data_ptr(), _stride(self.scmask), self.dtime,
                _CONSTS, _ptrs(outs), _ptrs(lay_out), imelt.data_ptr())

    @staticmethod
    def result(outs, lay_out, imelt) -> stp.SoilTemperatureOut:
        """The outputs as ``SoilTemperatureOut``."""
        return stp.SoilTemperatureOut(
            **dict(zip(OUT_FIELDS, outs)), **dict(zip(LAYER_OUT, lay_out)),
            imelt=imelt)


def _stride(t: torch.Tensor) -> int:
    return t.stride(0) if t.dim() else 0


def _ptrs(ts):
    return (_P * len(ts))(*[t.data_ptr() for t in ts])


def kernel_inputs(args: dict) -> KernelInputs:
    """``soil_temperature_block``'s arguments (by name) checked and laid
    out as the kernel reads them, without copies: every floating input in
    one type on one device, [ncol] or 0-d, or [ncol, L] with unit element
    stride; ``snl`` and ``frac_veg_nosno`` int64.  Only a layered input
    whose elements are not adjacent, an integer input of another type and
    a per-column land mask (a bool tensor) are copied."""
    name = "soil_temperature"
    t_soisno = args["t_soisno"]
    dtype, dev = t_soisno.dtype, t_soisno.device
    if dtype not in _FUNCS:
        raise TypeError(f"{name} takes float64 or float32, not {dtype}")
    if t_soisno.ndim != 2 or t_soisno.shape[1] != c.NLEVTOT:
        raise ValueError(f"{name}: t_soisno must be [ncol, {c.NLEVTOT}]")
    n = t_soisno.shape[0]
    dtime = args["dtime"]
    if isinstance(dtime, torch.Tensor):
        raise TypeError(f"{name} takes dtime as a Python number (the plain "
                        f"chain divides by it as one)")

    def check(k, t):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {k} must be a tensor")
        if t.dtype is not dtype or t.device != dev:
            raise ValueError(f"{name}: {k} must be a {dtype} tensor on {dev}"
                             f", not {t.dtype} on {t.device}")
        return t

    fields = []
    for k in IN_FIELDS:
        t = check(k, args[k])
        if t.dim() and t.shape != (n,):
            raise ValueError(f"{name}: {k} must be [{n}] or a scalar, not "
                             f"{list(t.shape)}")
        fields.append(t)
    layers = []
    for k, w in LAYER_FIELDS.items():
        t = check(k, args[k])
        if t.shape != (n, w):
            raise ValueError(f"{name}: {k} must be [{n}, {w}], not "
                             f"{list(t.shape)}")
        layers.append(t if t.stride(1) == 1 else t.contiguous())

    def integer(k, t, shapes):
        if (not isinstance(t, torch.Tensor) or t.device != dev
                or t.is_floating_point() or t.shape not in shapes):
            raise ValueError(f"{name}: {k} must be an integer tensor of "
                             f"shape {shapes[0]} on {dev}")
        return t.to(torch.int64)

    snl = integer("snl", args["snl"], [(n,)]).contiguous()
    fveg = integer("frac_veg_nosno", args["frac_veg_nosno"], [(n,), ()])
    scmask = c.ltype_mask(args["land"], c.ISTSOIL, c.ISTCROP)
    if isinstance(scmask, bool):
        scmask = const(int(scmask), t_soisno, torch.uint8)
    elif scmask.shape != (n,) or scmask.device != dev:
        raise ValueError(f"{name}: the land type must be one per domain or "
                         f"[{n}] on {dev}")
    else:
        scmask = scmask.to(torch.uint8)
    return KernelInputs(dtype, n, fields, layers, snl, fveg, scmask,
                        float(dtime))


def soil_temperature(land, dtime, snl, frac_veg_nosno, frac_sno_eff,
                     frac_sno, frac_h2osfc, h2osfc, h2osno, int_snow,
                     snow_depth, t_grnd, t_h2osfc, sabg_snow, sabg_soil,
                     sabg_lyr, dlrad, emg, forc_lwrad, htvp, eflx_sh_soil,
                     qflx_ev_soil, eflx_sh_h2osfc, qflx_ev_h2osfc,
                     eflx_sh_snow, qflx_ev_snow, cgrnd, t_soisno, h2osoi_liq,
                     h2osoi_ice, dz, z, zi, tk, cv, dz_h2osfc, c_h2osfc,
                     tk_h2osfc, watsat, sucsat, bsw):
    """``soil_temperature_block`` on the card in one launch: returns its
    ``SoilTemperatureOut`` exactly as ``soil_temperature_block_plain``
    computes it.  Every floating input is a float64 or float32 tensor (one
    type) on one CUDA device: [ncol] or a scalar, or [ncol, L] layers."""
    args = dict(locals())
    tangents.refuse("soil_temperature",
                    "elmkernels_torch.physics.soil_temperature."
                    "soil_temperature_block",
                    [t for t in args.values() if isinstance(t, torch.Tensor)],
                    instead="which runs the plain chain for such a call")
    if not t_soisno.is_cuda:
        raise ValueError("soil_temperature takes CUDA tensors")
    k = kernel_inputs(args)
    outs = k.outputs()
    stream = torch.cuda.current_stream(t_soisno.device).cuda_stream
    err = _entry(k.dtype)(*k.pointers(*outs), stream)
    build.check(err, "soil_temperature")
    soil_temperature.launches += 1
    return k.result(*outs)


soil_temperature.launches = 0

_entries: dict = {}


def _entry(dtype):
    """K7's launch function for ``dtype``, its ctypes signature set once."""
    fn = _entries.get(dtype)
    if fn is None:
        fn = getattr(build.load("soil_temperature"), _FUNCS[dtype])
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _entries[dtype] = fn
    return fn


def layout(dtype=torch.float64) -> dict:
    """What K7's launch uses on the current device in ``dtype``: threads a
    block, registers a thread, local (spilled) bytes a thread, resident
    blocks an SM and dynamic shared memory bytes a block.  Needs a card."""
    lib = build.load("soil_temperature")
    out = (ctypes.c_int * 5)()
    build.check(lib.soil_temperature_layout(
        ctypes.c_int(dtype == torch.float64), out), "soil_temperature_layout")
    keys = ("threads", "registers", "local_bytes", "blocks_per_sm",
            "shared_bytes")
    return dict(zip(keys, out))
