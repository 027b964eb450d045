"""Wrapper of K5, the snow-hydrology block as one CUDA kernel
(csrc/snow_hydrology.cu).

It replaces ``snow_hydrology_block_plain`` of
``elmkernels_torch/physics/snow_hydrology.py`` (the JAX package's
``driver/step.py`` from ``snow_water`` to the snow aging: the ten functions
of ``physics/snow_hydrology.py``, whose ``lax.scan``s over the 5 snow
positions the plain block runs as Python loops of masked full-width
operations) for tensors on the card: one thread a column runs the whole
block, in one launch.  ``physics.snow_hydrology.snow_hydrology_block``
routes to it.

:func:`snow_hydrology` takes ``snow_hydrology_block``'s arguments and
returns its ``SnowBlockOut``; ``snow_hydrology.launches`` counts its
launches.  It refuses a tensor that carries a tangent: the kernel has no
tangent version, and the dispatcher sends differentiated calls to the
plain block.  :func:`kernel_inputs` lays the arguments out as the kernel
reads them, without copies: a 0-d input (a deposition rate, a land-type
mask) goes as itself with a stride of 0, a layered input as itself with
its row stride (the CPU tests give the same layout to the kernel's host
build).  The outputs are fresh tensors: no input is written.
:func:`layout` reads the launch's registers, spills, shared memory and
resident blocks on the card.

The kernel runs a block of ``THREADS`` columns, one thread each, and
stages the block's rows through shared memory: each thread holds
``SLOTS`` values there (:func:`shared_bytes`).
"""

from __future__ import annotations

import ctypes

import torch

from elmkernels_torch import constants as c
from elmkernels_torch.data.state import AERO_DEP_KEYS, AERO_SPECIES
from elmkernels_torch.ops import build, tangents
from elmkernels_torch.physics.math_utils import const

_FUNCS = {torch.float64: "snow_hydrology_f64",
          torch.float32: "snow_hydrology_f32"}
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
# the launch functions' parameters (csrc/snow_hydrology.cu's entry
# points): elm, n, the inputs and their strides, snl, do_capsnow, imelt and
# the masks with their strides, the tables and their sizes, nlevtot,
# dtime, the constants, the outputs and the stream
ARGTYPES = [_INT, _I64, _P, _P, _P, _P, _P, _P, _I64, _P, _I64, _P, _I64,
            _P, _I64, _P, _P, _P, _INT, _INT, _INT, _INT, ctypes.c_double,
            _P, _P, _P, _P, _P]

# the kernel's [ncol] inputs, by snow_hydrology_block's argument names
# (csrc/snow_hydrology.cu's enum order), then the deposition rates
IN_FIELDS = (
    "frac_sno_eff", "frac_sno", "h2osno", "snow_depth", "int_snow",
    "qflx_sub_snow", "qflx_evap_grnd", "qflx_dew_snow", "qflx_dew_grnd",
    "qflx_rain_grnd", "qflx_snomelt", "qflx_snow_melt", "n_melt",
    "qflx_snwcp_ice", "qflx_snow_grnd",
    *("aero_" + k for k in AERO_DEP_KEYS))
# the layered inputs, [ncol, L] with a row stride; L is NLEVTOT for the
# first five, NLEVTOT + 1 for zi, NLEVSNO or more for the rest
LAYER_FIELDS = (
    "h2osoi_liq", "h2osoi_ice", "t_soisno", "dz", "z", "zi", "frac_iceold",
    "swe_old", "snw_rds", "qflx_snofrz_lyr",
    *("mss_" + k for k in AERO_SPECIES))
# SnowBlockOut's [ncol] floating fields, in the kernel's order
OUT_FIELDS = (
    "h2osno", "snow_depth", "frac_sno", "frac_sno_eff", "int_snow",
    "qflx_snow_melt", "qflx_top_soil", "qflx_sl_top_soil",
    "qflx_snow2topsoi", "mflx_snowlyr_col", "mflx_neg_snow")
# the Python-level constants of the block (the kernel's Consts, in order)
CONSTS = (c.TFRZ, c.DENICE, c.DENH2O, c.CPICE, c.CPWAT, c.HFUS, c.ELM_PI,
          c.SNW_RDS_MIN, c.SNW_RDS_MAX)
_CONSTS = (ctypes.c_double * len(CONSTS))(*CONSTS)
_NSNO = c.NLEVSNO
# columns a block, a column's shared-memory slots, and the slot stride's
# padding (csrc/snow_hydrology.cu's kB, kSlots and kLd - kB)
THREADS, SLOTS, _PAD = 128, 50, 13


def shared_bytes(dtype) -> int:
    """Dynamic shared memory of one K5 block in ``dtype``: the slots of its
    columns, then a byte a column for each snow position's ``imelt``."""
    item = torch.empty((), dtype=dtype).element_size()
    return SLOTS * (THREADS + _PAD) * item + _NSNO * THREADS


def land_masks(land: c.LandType):
    """The block's two land-unit masks, each a Python bool or an [ncol]
    bool tensor: where combine merges a removed layer's mass down (soil,
    crop, urban) and where the melt compaction takes ELM's fractional-area
    form (soil and crop)."""
    soil_crop = c.ltype_mask(land, c.ISTSOIL, c.ISTCROP)
    soil_like = c.lor(soil_crop, land.urbpoi)
    return soil_like, (soil_crop if c.SUBGRIDFLAG == 1 else False)


class KernelInputs:
    """The arguments of one launch, laid out as the kernel reads them:
    ``fields`` (IN_FIELDS order), each [n] or 0-d, with ``strides`` (0 for
    a 0-d tensor); ``layers`` (LAYER_FIELDS order), each [n, L] with unit
    element stride, with ``row_strides``; ``snl``, ``do_capsnow`` and
    ``imelt`` int64; the masks uint8 ([n] or 0-d); the aging tables; and
    the scalars."""

    def __init__(self, elm, dtype, n, nlevtot, fields, layers, snl,
                 do_capsnow, imelt, soil_like, soil_crop, tables, dtime):
        self.elm, self.dtype, self.n, self.nlevtot = elm, dtype, n, nlevtot
        self.fields, self.layers = fields, layers
        self.strides = [_stride(t) for t in fields]
        self.row_strides = [t.stride(0) for t in layers]
        self.snl, self.do_capsnow, self.imelt = snl, do_capsnow, imelt
        self.soil_like, self.soil_crop = soil_like, soil_crop
        self.tables, self.dtime = tables, dtime

    def outputs(self):
        """Fresh outputs: snl, OUT_FIELDS, and the layered ones (t, ice,
        liq, dz, z, zi, snw_rds, the masses, the concentrations)."""
        n, L, dev, dt = self.n, self.nlevtot, self.snl.device, self.dtype

        def empty(*shape):
            return torch.empty(shape, dtype=dt, device=dev)
        lay = [empty(n, L) for _ in range(5)] + [empty(n, L + 1)]
        lay += [empty(n, _NSNO) for _ in range(1 + 2 * len(AERO_SPECIES))]
        return (torch.empty(n, dtype=torch.int64, device=dev),
                [empty(n) for _ in OUT_FIELDS], lay)

    def pointers(self, snl_out, outs, lay_out):
        """The launch function's arguments after ``elm`` (see the source's
        entry points), without the stream."""
        tau, kappa, drdt0 = self.tables
        return (self.n, _ptrs(self.fields),
                (_I64 * len(self.fields))(*self.strides),
                _ptrs(self.layers),
                (_I64 * len(self.layers))(*self.row_strides),
                self.snl.data_ptr(), self.do_capsnow.data_ptr(),
                _stride(self.do_capsnow), self.imelt.data_ptr(),
                self.imelt.stride(0), self.soil_like.data_ptr(),
                _stride(self.soil_like), self.soil_crop.data_ptr(),
                _stride(self.soil_crop), tau.data_ptr(), kappa.data_ptr(),
                drdt0.data_ptr(), *tau.shape, self.nlevtot, self.dtime,
                _CONSTS, snl_out.data_ptr(), _ptrs(outs), _ptrs(lay_out))

    def result(self, snl_out, outs, lay_out):
        """The outputs as ``SnowBlockOut``."""
        from elmkernels_torch.physics.snow_hydrology import SnowBlockOut
        t, ice, liq, dz, z, zi, rds = lay_out[:7]
        ns = len(AERO_SPECIES)
        mss = dict(zip(AERO_SPECIES, lay_out[7:7 + ns]))
        cnc = dict(zip(AERO_SPECIES, lay_out[7 + ns:]))
        return SnowBlockOut(snl_out, t, ice, liq, dz, z, zi, rds, mss, cnc,
                            **dict(zip(OUT_FIELDS, outs)))


def _stride(t: torch.Tensor) -> int:
    return t.stride(0) if t.dim() else 0


def _ptrs(ts):
    return (_P * len(ts))(*[t.data_ptr() for t in ts])


def kernel_inputs(args: dict) -> KernelInputs:
    """``snow_hydrology_block``'s arguments (by name) checked and laid out
    as the kernel reads them, without copies: every floating input in one
    type on one device, [ncol] or 0-d, or [ncol, L] with unit element
    stride; the integer inputs int64.  Only a layered input whose elements
    are not adjacent, and an integer input of another type, are copied."""
    name = "snow_hydrology"
    t_soisno = args["t_soisno"]
    dtype, dev = t_soisno.dtype, t_soisno.device
    if dtype not in _FUNCS:
        raise TypeError(f"{name} takes float64 or float32, not {dtype}")
    if t_soisno.ndim != 2 or t_soisno.shape[1] <= _NSNO:
        raise ValueError(f"{name}: t_soisno must be [ncol, nlevtot]")
    n, nlevtot = t_soisno.shape
    dtime = args["dtime"]
    if isinstance(dtime, torch.Tensor):
        raise TypeError(f"{name} takes dtime as a Python number (the plain "
                        f"block divides by it as one)")

    def check(k, t):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {k} must be a tensor")
        if t.dtype is not dtype or t.device != dev:
            raise ValueError(f"{name}: {k} must be a {dtype} tensor on {dev}"
                             f", not {t.dtype} on {t.device}")
        return t

    aero = args["aero_in"]
    given = dict(args, **{"aero_" + k: aero[k] for k in AERO_DEP_KEYS})
    fields = []
    for k in IN_FIELDS:
        t = check(k, given[k])
        if t.dim() and t.shape != (n,):
            raise ValueError(f"{name}: {k} must be [{n}] or a scalar, not "
                             f"{list(t.shape)}")
        fields.append(t)
    mss = args["mss"]
    given.update({"mss_" + k: mss[k] for k in AERO_SPECIES})
    widths = dict(h2osoi_liq=nlevtot, h2osoi_ice=nlevtot, dz=nlevtot,
                  z=nlevtot, zi=nlevtot + 1, t_soisno=nlevtot)
    layers = []
    for k in LAYER_FIELDS:
        t = check(k, given[k])
        width = widths.get(k)
        if (t.ndim != 2 or t.shape[0] != n
                or (t.shape[1] != width if width else t.shape[1] < _NSNO)):
            want = width or f">= {_NSNO}"
            raise ValueError(f"{name}: {k} must be [{n}, {want}], not "
                             f"{list(t.shape)}")
        layers.append(t if t.stride(1) == 1 else t.contiguous())

    def integer(k, t, shapes):
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{name}: {k} must be an integer tensor on "
                             f"{dev}")
        if t.is_floating_point() or t.shape not in shapes:
            raise ValueError(f"{name}: {k} must be an integer tensor of "
                             f"shape {shapes[0]}, not {list(t.shape)}")
        return t.to(torch.int64)

    snl = integer("snl", args["snl"], [(n,)]).contiguous()
    do_capsnow = integer("do_capsnow", args["do_capsnow"], [(n,), ()])
    imelt = integer("imelt", args["imelt"], [(n, nlevtot)])
    if imelt.stride(1) != 1:
        imelt = imelt.contiguous()
    masks = []
    for k, m in zip(("soil_like", "soil_crop"), land_masks(args["land"])):
        if isinstance(m, bool):
            masks.append(const(int(m), t_soisno, torch.uint8))
        elif m.shape != (n,) or m.device != dev:
            raise ValueError(f"{name}: the land type must be one per domain "
                             f"or [{n}] on {dev}")
        else:
            masks.append(m.to(torch.uint8))
    tables = [check(k, args[k]).contiguous() for k in
              ("snowage_tau", "snowage_kappa", "snowage_drdt0")]
    if tables[0].ndim != 3 or any(t.shape != tables[0].shape
                                  for t in tables):
        raise ValueError(f"{name}: the aging tables must be one [n_t, "
                         f"n_tgrd, n_rhos] shape")
    return KernelInputs(bool(args.get("elm_correct_snow_aging")), dtype, n,
                        nlevtot, fields, layers, snl, do_capsnow, imelt,
                        *masks, tables, float(dtime))


def snow_hydrology(land, dtime, do_capsnow, snl, frac_sno_eff, frac_sno,
                   h2osno, snow_depth, int_snow, qflx_sub_snow,
                   qflx_evap_grnd, qflx_dew_snow, qflx_dew_grnd,
                   qflx_rain_grnd, qflx_snomelt, qflx_snow_melt, h2osoi_liq,
                   h2osoi_ice, t_soisno, dz, z, zi, mss, aero_in, n_melt,
                   imelt, swe_old, frac_iceold, snw_rds, qflx_snwcp_ice,
                   qflx_snow_grnd, qflx_snofrz_lyr, snowage_tau,
                   snowage_kappa, snowage_drdt0,
                   elm_correct_snow_aging: bool = False):
    """``snow_hydrology_block`` on the card in one launch: returns its
    ``SnowBlockOut`` exactly as ``snow_hydrology_block_plain`` computes
    it.  Every floating input is a float64 or float32 tensor (one type) on
    one CUDA device: [ncol] or a scalar, or [ncol, L] layers."""
    args = dict(locals())
    if not t_soisno.is_cuda:
        raise ValueError("snow_hydrology takes CUDA tensors")
    from elmkernels_torch.physics.snow_hydrology import _tensors
    tangents.refuse("snow_hydrology",
                    "elmkernels_torch.physics.snow_hydrology."
                    "snow_hydrology_block", list(_tensors(args)),
                    instead="which runs the plain block for such a call")
    k = kernel_inputs(args)
    outs = k.outputs()
    stream = torch.cuda.current_stream(t_soisno.device).cuda_stream
    err = _entry(k.dtype)(int(k.elm), *k.pointers(*outs), stream)
    build.check(err, "snow_hydrology")
    snow_hydrology.launches += 1
    return k.result(*outs)


snow_hydrology.launches = 0

_entries: dict = {}


def _entry(dtype):
    """K5's launch function for ``dtype``, its ctypes signature set once."""
    fn = _entries.get(dtype)
    if fn is None:
        fn = getattr(build.load("snow_hydrology"), _FUNCS[dtype])
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _entries[dtype] = fn
    return fn


def layout(dtype=torch.float64, elm: bool = False) -> dict:
    """What K5's launch uses on the current device in ``dtype`` with
    ELM's aging or the pinned radius: threads a block, registers a
    thread, local (spilled) bytes a thread, resident blocks an SM and
    dynamic shared memory bytes a block.  Needs a card."""
    lib = build.load("snow_hydrology")
    out = (ctypes.c_int * 5)()
    build.check(lib.snow_hydrology_layout(
        ctypes.c_int(dtype == torch.float64), ctypes.c_int(int(elm)), out),
        "snow_hydrology_layout")
    keys = ("threads", "registers", "local_bytes", "blocks_per_sm",
            "shared_bytes")
    return dict(zip(keys, out))
