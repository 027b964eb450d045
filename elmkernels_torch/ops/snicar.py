"""Wrapper of K3, SNICAR's adding-doubling sweep as one CUDA kernel
(csrc/snow_snicar.cu).

It replaces ``snicar_ad_rt_both_plain`` of
``elmkernels_torch/physics/snow_snicar.py`` (the JAX package's
``_snicar_core`` with both beams' ``_radiation_factor``, whose two
``lax.scan``\\ s over the snow layers the plain path runs as Python loops of
full-width [10, 5, ncol] operations) for tensors on the card: one thread a
column and beam, in one launch.  ``physics.snow_snicar.snicar_ad_rt_both``
routes to it.

:func:`snicar` takes ``snicar_ad_rt_both``'s arguments (without ``land``,
which the sweep does not read) and returns its (direct, diffuse)
``SnicarOut`` pair; ``snicar.launches`` counts its launches.  It refuses a
tensor that carries a tangent, and any type it has no instantiation for:
the dispatcher sends differentiated calls to the plain path, and nothing
falls back.  The inputs are read where they lie: [ncol] and [ncol, L]
tensors with any row stride, the tables as they are; with ``sweep_dtype``
float32 and float64 inputs (the step's ``mixed_radiation``), the kernel
rounds each value on load, as the plain path's cast does.

:func:`swept` reads a device counter that each launch adds its swept
(active) columns to; nothing in the step reads it.  :func:`layout` reads
the launch's registers, spills, shared memory and resident blocks.
"""

from __future__ import annotations

import ctypes
import math

import torch

from elmkernels_torch import constants as c
from elmkernels_torch.ops import build, tangents

f32, f64 = torch.float32, torch.float64
# the launch function of each (input, sweep, weight) type
_FUNCS = {(f64, f32, f64): "snicar_f64_f32_f64",
          (f32, f32, f64): "snicar_f32_f32_f64",
          (f64, f64, f64): "snicar_f64_f64_f64",
          (f32, f32, f32): "snicar_f32_f32_f32"}
_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
# the launch functions' parameters (csrc/snow_snicar.cu's entry points):
# n, the inputs and their strides, snl and its stride, the tables, the
# constants, the outputs, the swept-column counter and the stream
ARGTYPES = [_I64, _P, _P, _P, _I64, _P, _P, _P, _P, _P]

# the kernel's floating inputs, by snicar_ad_rt_both's argument names
IN_FIELDS = ("coszen", "h2osno", "h2osoi_liq", "h2osoi_ice", "snw_rds",
             "albsoi", "mss_cnc_aer")
_NSNO, _NAER = c.NLEVSNO, c.SNO_NBR_AER


def _consts() -> tuple:
    """The plain path's Python-level numbers, computed in double as it
    computes them (the kernel's Consts, in order)."""
    from elmkernels_torch.physics import snow_snicar as sn
    gmuw = tuple(p * w for p, w in zip(sn._DIFGAUSPT, sn._DIFGAUSWT))
    swt = 0.0
    for muw in gmuw:
        swt += muw
    wgt = (sn._FLX_WGT_DRC, sn._FLX_WGT_DFS)
    return (sn.MIN_SNW, sn._TRMIN, sn._PUNY, math.exp(-sn._ARGMAX),
            sn._MU_MIN, sn._MU_75, float(round(c.SNW_RDS_MIN)),
            *sn._DIFGAUSPT, *(p * p for p in sn._DIFGAUSPT), *gmuw, swt,
            *wgt[0], *wgt[1], *(sum(w[1:5]) for w in wgt),
            *sn._SZA_C1, *sn._SZA_C0)


CONSTS = _consts()
_CONSTS = (ctypes.c_double * len(CONSTS))(*CONSTS)


class KernelInputs:
    """The arguments of one launch, laid out as the kernel reads them:
    ``fields`` (IN_FIELDS order) with ``strides`` (a row's for the layered
    ones), ``snl`` int64, the tables, and the three types."""

    def __init__(self, n, fields, snl, tables, types):
        self.n, self.fields, self.snl, self.tables = n, fields, snl, tables
        self.strides = [t.stride(0) for t in fields]
        self.types = types

    def outputs(self):
        """Fresh outputs in the weights' type: albout [n, 2] and flx_abs
        [n, 6, 2] of the direct, then the diffuse beam."""
        n, dev, w = self.n, self.snl.device, self.types[2]
        return [torch.empty(shape, dtype=w, device=dev)
                for _ in range(2) for shape in ((n, 2), (n, _NSNO + 1, 2))]

    def pointers(self, outs, swept):
        """The launch function's arguments, without the stream."""
        return (self.n, _ptrs(self.fields),
                (_I64 * len(self.fields))(*self.strides),
                self.snl.data_ptr(), self.snl.stride(0),
                _ptrs(self.tables), _CONSTS, _ptrs(outs), swept.data_ptr())

    @staticmethod
    def result(outs):
        from elmkernels_torch.physics.snow_snicar import SnicarOut
        return SnicarOut(outs[0], outs[1]), SnicarOut(outs[2], outs[3])


def _ptrs(ts):
    return (_P * len(ts))(*[t.data_ptr() for t in ts])


def kernel_inputs(args: dict) -> KernelInputs:
    """``snicar_ad_rt_both``'s arguments (by name) checked and laid out as
    the kernel reads them: every floating input and table in one type I on
    one device; the sweep in ``sweep_dtype`` (default I), the weights and
    outputs in ``weight_dtype``, a combination the kernel is built for.  An
    input whose elements along a row are not adjacent, a non-contiguous
    aerosol or table array, and an ``snl`` of another integer type are
    copied; nothing else is."""
    name = "snicar"
    coszen = args["coszen"]
    dtype, dev = coszen.dtype, coszen.device
    sweep = args.get("sweep_dtype") or dtype
    types = (dtype, sweep, args.get("weight_dtype", f64))
    if types not in _FUNCS:
        raise TypeError(f"{name} has no instantiation for inputs, sweep and "
                        f"weights of types {types}")
    if coszen.ndim != 1:
        raise ValueError(f"{name}: coszen must be [ncol]")
    n = coszen.shape[0]

    def check(k, t):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {k} must be a tensor")
        if t.dtype is not dtype or t.device != dev:
            raise ValueError(f"{name}: {k} must be a {dtype} tensor on {dev}"
                             f", not {t.dtype} on {t.device}")
        return t

    shapes = dict(coszen=(n,), h2osno=(n,), albsoi=(n, 2),
                  mss_cnc_aer=(n, _NSNO, _NAER))
    fields = []
    for k in IN_FIELDS:
        t = check(k, args[k])
        want = shapes.get(k)
        if want is None:   # a layered input: [n, >= 5]
            if t.ndim != 2 or t.shape[0] != n or t.shape[1] < _NSNO:
                raise ValueError(f"{name}: {k} must be [{n}, >= {_NSNO}], "
                                 f"not {list(t.shape)}")
        elif tuple(t.shape) != want:
            raise ValueError(f"{name}: {k} must be {list(want)}, not "
                             f"{list(t.shape)}")
        if k == "mss_cnc_aer" or (t.ndim == 2 and t.stride(1) != 1):
            t = t.contiguous()
        fields.append(t)
    snl = args["snl"]
    if (not isinstance(snl, torch.Tensor) or snl.is_floating_point()
            or snl.shape != (n,) or snl.device != dev):
        raise ValueError(f"{name}: snl must be an integer [{n}] tensor on "
                         f"{dev}")
    tables = []
    for k, t in args["tables"]._asdict().items():
        t = check(k, t)
        want = ((c.NUMRAD_SNW, 1471) if "_snw_" in k else
                (8, 10, c.NUMRAD_SNW) if k == "bcenh" else
                (10, c.NUMRAD_SNW) if k.endswith(("bc1", "bc2")) else
                (c.NUMRAD_SNW,))
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: the table {k} must be {list(want)}, "
                             f"not {list(t.shape)}")
        tables.append(t.contiguous())
    return KernelInputs(n, fields, snl.to(torch.int64), tables, types)


def snicar(coszen, h2osno, snl, h2osoi_liq, h2osoi_ice, snw_rds, albsoi,
           mss_cnc_aer, tables, weight_dtype=torch.float64,
           sweep_dtype=None):
    """``snicar_ad_rt_both`` on the card in one launch: returns its
    (direct, diffuse) ``SnicarOut`` pair exactly as
    ``snicar_ad_rt_both_plain`` computes it."""
    args = dict(locals())
    if not coszen.is_cuda:
        raise ValueError("snicar takes CUDA tensors")
    tangents.refuse("snicar", "elmkernels_torch.physics.snow_snicar."
                    "snicar_ad_rt_both", _tensors(args),
                    instead="which runs the plain sweep for such a call")
    k = kernel_inputs(args)
    outs = k.outputs()
    stream = torch.cuda.current_stream(coszen.device).cuda_stream
    err = _entry(k.types)(*k.pointers(outs, _counter(coszen.device)), stream)
    build.check(err, "snicar")
    snicar.launches += 1
    return k.result(outs)


snicar.launches = 0


def _tensors(args: dict) -> list:
    out = []
    for v in args.values():
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, tuple):
            out += [t for t in v if isinstance(t, torch.Tensor)]
    return out


_entries: dict = {}
_counters: dict = {}


def _entry(types):
    """K3's launch function for (input, sweep, weight) ``types``, its
    ctypes signature set once."""
    fn = _entries.get(types)
    if fn is None:
        fn = getattr(build.load("snow_snicar"), _FUNCS[types])
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _entries[types] = fn
    return fn


def _counter(device) -> torch.Tensor:
    """The swept-column counter of ``device`` (int64 [1], read as an
    unsigned 64-bit count by the kernel), made at the device's first
    launch, which must not be captured (a graph would zero it at each
    replay)."""
    dev = torch.device(device)
    t = _counters.get(dev)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("K3's swept-column counter is made by its "
                               "first launch on a device, which must run "
                               "outside a CUDA graph capture")
        t = _counters[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    return t


def _counter_of(device):
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device is None else torch.device(device))
    return _counters.get(dev)


def swept(device=None) -> int:
    """Columns K3 has swept on ``device`` (the current one by default) since
    its first launch there or the last :func:`reset_swept`: a host read,
    for tools, never inside the step."""
    t = _counter_of(device)
    return 0 if t is None else int(t.item())


def reset_swept(device=None) -> None:
    """Zero the swept-column counter of ``device`` (outside a capture)."""
    t = _counter_of(device)
    if t is not None:
        t.zero_()


def layout(types=(f64, f32, f64)) -> dict:
    """What K3's launch uses on the current device for (input, sweep,
    weight) ``types``: threads a block, registers a thread, local (spilled)
    bytes a thread, resident blocks an SM and dynamic shared memory bytes a
    block.  Needs a card."""
    lib = build.load("snow_snicar")
    out = (ctypes.c_int * 5)()
    build.check(getattr(lib, _FUNCS[types] + "_layout")(out),
                "snicar_layout")
    keys = ("threads", "registers", "local_bytes", "blocks_per_sm",
            "shared_bytes")
    return dict(zip(keys, out))
