"""K3, SNICAR's adding-doubling sweep as one CUDA kernel
(``csrc/snow_snicar.cu``), checked on the CPU: the source compiled as plain
C++ by the host compiler (its device code is inline functions; the kernel
and its launch sit under ``__CUDACC__``), driven column by column through
the same argument layout as on the card (``ops.snicar.kernel_inputs``),
against the port's plain sweep (``snicar_ad_rt_both_plain``) on seeded
inputs (``ops.testing.snicar_problem``: 0-5 layers, layerless packs, snow
below ``MIN_SNW``, thin snow, night, zero layers and clamped fluxes), in
the kernel's four instantiations (inputs, sweep, weights: f64/f64/f64,
f64/f32/f64 as the step's ``mixed_radiation`` calls it, f32/f32/f64 and
f32/f32/f32);
and the wrapper's layout and checks, the branches the problem reaches (the
host build counts them) and the routing of
``physics.snow_snicar.snicar_ad_rt_both``.

Bit for bit.  PyTorch's CPU ``exp``, ``sqrt`` and ``log10`` round
differently from the C library's, so the plain sweep runs here with those
three replaced by the C library's (``libm``), the functions the host build
calls; its sums are PyTorch's CPU orders, which the host build copies
(``sum8``, ``nir_add``).  On the card the kernel is held bit for bit
against the plain sweep as it stands (``chip_smoke.py``'s K3 phase).
Skips where no ``g++`` is installed.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from elmkernels_torch import constants as tc
from elmkernels_torch.data import params, synthetic
from elmkernels_torch.ops import snicar, testing
from elmkernels_torch.physics import snow_snicar as sn

torch.set_num_threads(1)

SOURCE = (pathlib.Path(__file__).resolve().parent.parent / "elmkernels_torch"
          / "csrc" / "snow_snicar.cu")
N = 1500
LAND = tc.LandType(ltype=1, ctype=1, vtype=12)
ARGS = ("coszen", "h2osno", "snl", "h2osoi_liq", "h2osoi_ice", "snw_rds",
        "albsoi", "mss_cnc_aer")
f32, f64 = torch.float32, torch.float64
# (inputs, sweep, weights)
TYPES = [(f64, f64, f64), (f64, f32, f64), (f32, f32, f64), (f32, f32, f32)]

# K3's column routine over every column in turn in each instantiation, the
# branches it takes (K3_NOTE), the kernel's sizes, and the C library's exp,
# sqrt and log10 over arrays, for the plain sweep
HARNESS = r"""
static long long g_notes[2];
#define K3_NOTE(what) (++g_notes[(what)])
#include "SOURCE"
#define ENTRY(NAME, I, T, W)                                                \
  extern "C" void NAME(long long n, const void* const* in,                 \
                       const long long* stride, const void* snl,           \
                       long long snl_stride, const void* const* tab,       \
                       const double* consts, void* const* out,             \
                       void* swept) {                                      \
    const Args<I, W> A = make_args<I, W>(n, in, stride, snl, snl_stride,   \
                                         tab, consts, out, swept);         \
    for (long long i = 0; i < n; ++i) run_column<I, T, W>(A, i);           \
  }
ENTRY(snicar_f64_f64_f64, double, double, double)
ENTRY(snicar_f64_f32_f64, double, float, double)
ENTRY(snicar_f32_f32_f64, float, float, double)
ENTRY(snicar_f32_f32_f32, float, float, float)
extern "C" void notes(long long* out) {
  out[0] = g_notes[0];
  out[1] = g_notes[1];
  g_notes[0] = g_notes[1] = 0;
}
extern "C" void layout(int* out) {
  const int v[] = {kConsts, kTables, kStage, kTSlots, kWSlots, kCols,
                   smem_bytes<float, double>(), smem_bytes<float, float>(),
                   smem_bytes<double, double>()};
  for (int k = 0; k < 9; ++k) out[k] = v[k];
}
#define MAP(NAME, T, F)                                                     \
  extern "C" void NAME(const T* x, T* y, long long n) {                    \
    for (long long i = 0; i < n; ++i) y[i] = F(x[i]);                      \
  }
MAP(c_expf, float, expf)
MAP(c_exp, double, exp)
MAP(c_sqrtf, float, sqrtf)
MAP(c_sqrt, double, sqrt)
MAP(c_log10f, float, log10f)
MAP(c_log10, double, log10)
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("snicar_kernel")
    (d / "harness.cpp").write_text(HARNESS.replace("SOURCE", str(SOURCE)))
    # no vectorizer: GCC 12's at -O2 folds the float round trip of the two
    # soil albedos (double to float to double, adjacent values) away
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off",
                    "-fno-tree-vectorize", "-shared", "-fPIC", "-o",
                    str(d / "libharness.so"), str(d / "harness.cpp")],
                   check=True, timeout=300)
    lib = ctypes.CDLL(str(d / "libharness.so"))
    for name in snicar._FUNCS.values():
        getattr(lib, name).argtypes = snicar.ARGTYPES[:-1]  # no stream
        getattr(lib, name).restype = None
    for name in ("c_expf", "c_exp", "c_sqrtf", "c_sqrt", "c_log10f",
                 "c_log10"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_longlong]
    return lib


@pytest.fixture
def libm_math(host_lib, monkeypatch):
    """torch.exp, torch.sqrt and torch.log10 as the C library computes
    them, elementwise, for the plain sweep."""
    def mapped(fname):
        def f(x):
            x = x.contiguous()
            y = torch.empty_like(x)
            getattr(host_lib, fname + ("f" if x.dtype == f32 else ""))(
                x.data_ptr(), y.data_ptr(), x.numel())
            return y
        return f
    for name in ("exp", "sqrt", "log10"):
        monkeypatch.setattr(torch, name, mapped("c_" + name))


def _tables(dtype):
    slots = params.snicar_slots(synthetic.snicar_tables(), "synthetic")
    return sn.SnicarTables(**{k: torch.tensor(v, dtype=dtype)
                              for k, v in slots.items()})


def problem(n, seed, dtype=f64):
    """``snicar_problem``'s inputs as tensors of ``dtype`` (``snl`` int64,
    as the model's state holds it) and the synthetic tables."""
    a = testing.snicar_problem(n, seed)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    t = {k: (v.to(dtype) if v.is_floating_point() else v.to(torch.int64))
         for k, v in t.items()}
    return dict(t, tables=_tables(dtype))


def host_sweep(lib, args: dict, weight_dtype=f64, sweep_dtype=None):
    """K3's host build on ``snicar_ad_rt_both``'s arguments."""
    k = snicar.kernel_inputs(dict(args, weight_dtype=weight_dtype,
                                  sweep_dtype=sweep_dtype))
    outs = k.outputs()
    swept = torch.zeros(1, dtype=torch.int64)
    getattr(lib, snicar._FUNCS[k.types])(*k.pointers(outs, swept))
    return k.result(outs)


def plain(args: dict, weight_dtype=f64, sweep_dtype=None):
    return sn.snicar_ad_rt_both_plain(LAND, *(args[k] for k in ARGS),
                                      args["tables"],
                                      weight_dtype=weight_dtype,
                                      sweep_dtype=sweep_dtype)


def assert_same(got, want):
    """Bit for bit, in type and shape, NaNs in the same places."""
    for g, w in zip(got, want):
        for f in w._fields:
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert torch.equal(torch.isnan(a), torch.isnan(b)), f
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), f


@pytest.mark.parametrize("types", TYPES, ids=lambda t: "/".join(
    str(x).replace("torch.float", "f") for x in t))
@pytest.mark.parametrize("n", [0, 1, 37, N])
def test_host_build_matches_the_plain_sweep(host_lib, libm_math, types, n):
    inp, sweep, wdt = types
    args = problem(n, 5 + n, inp)
    sweep_dtype = sweep if sweep != inp else None
    got = host_sweep(host_lib, args, wdt, sweep_dtype)
    assert_same(got, plain(args, wdt, sweep_dtype))


def test_problem_reaches_every_branch(host_lib):
    """``snicar_problem`` holds columns with 0-5 layers, night, thin snow
    and snow below ``MIN_SNW``; in float64 and float32 the sweep meets a
    zero layer (``trntdr <= TRMIN``) and a ``PUNY`` clamp that changes a
    flux (a nonzero value below it), and each beam's albedo reads values of
    every kind (snow, thin snow's soil albedo, 0)."""
    a = testing.snicar_problem(N, 5 + N)
    snl, cz, h = a["snl"], a["coszen"], a["h2osno"]
    assert set(snl.tolist()) == set(range(6))
    assert (cz <= 0).any() and ((cz > 0) & (h > 0) & (h < sn.MIN_SNW)).any()
    assert ((cz > 0) & (snl == 0) & (h > sn.MIN_SNW)).any()
    out = (ctypes.c_longlong * 2)()
    host_lib.notes(out)
    for types in TYPES:
        args = problem(N, 5 + N, types[0])
        sweep = types[1] if types[1] != types[0] else None
        drc, dfs = host_sweep(host_lib, args, types[2], sweep)
        host_lib.notes(out)
        zero_layers, puny = list(out)
        assert zero_layers > 0 and puny > 0, (types, list(out))
        thin = torch.as_tensor((cz > 0) & (h > 0) & (h < sn.MIN_SNW))
        for o in (drc, dfs):
            assert torch.equal(o.albout[thin], args["albsoi"][thin]
                               .to(types[1]).to(types[2]))
            assert bool((o.albout[torch.as_tensor(cz <= 0)] == 0).all())
            assert bool((o.flx_abs > 0).any())


def test_layout_matches_the_wrapper(host_lib):
    """The kernel's sizes are the wrapper's (its constants and tables), and
    the wrapper hands the inputs over without copies where their rows are
    adjacent (a view of a wider layer array with its row stride), with
    fresh outputs in the weights' type."""
    out = (ctypes.c_int * 9)()
    host_lib.layout(out)
    assert out[0] == len(snicar.CONSTS) and out[1] == len(sn.SnicarTables
                                                          ._fields)
    assert out[6] <= 4 * 56 * 1024 // 4 * 4 and out[8] <= 113 * 1024
    args = problem(64, 3)
    k = snicar.kernel_inputs(dict(args, weight_dtype=f64))
    for name, t in zip(snicar.IN_FIELDS, k.fields):
        assert t.data_ptr() == args[name].data_ptr(), name
    assert k.snl.data_ptr() == args["snl"].data_ptr()
    wide = torch.cat([args["snw_rds"], args["snw_rds"]], 1)[:, :5]
    k2 = snicar.kernel_inputs(dict(args, snw_rds=wide, weight_dtype=f64))
    assert k2.fields[4].data_ptr() == wide.data_ptr()
    assert k2.strides[4] == 10
    assert_same(host_sweep(host_lib, dict(args, snw_rds=wide)),
                host_sweep(host_lib, args))
    assert all(o.dtype == f64 for o in k.outputs())


def test_consts_are_the_plain_paths():
    """The numbers handed to the kernel are the plain path's own, computed
    as it computes them."""
    K = snicar.CONSTS
    assert K[:7] == (sn.MIN_SNW, sn._TRMIN, sn._PUNY, np.exp(-sn._ARGMAX),
                     sn._MU_MIN, sn._MU_75, 55.0)
    assert K[7:15] == sn._DIFGAUSPT
    swt = 0.0
    for p, w in zip(sn._DIFGAUSPT, sn._DIFGAUSWT):
        swt += p * w
    assert K[31] == swt
    assert K[42:44] == (sum(sn._FLX_WGT_DRC[1:5]), sum(sn._FLX_WGT_DFS[1:5]))


def test_sweep_dtype_is_the_cast(libm_math):
    """``sweep_dtype`` casts as the step did before the sweep took it: the
    plain sweep on float64 inputs with ``sweep_dtype=float32`` is the
    plain sweep on the inputs cast to float32, bit for bit."""
    args = problem(200, 9)
    cast = {k: (v.to(f32) if isinstance(v, torch.Tensor)
                and v.is_floating_point() else v) for k, v in args.items()}
    cast["tables"] = _tables(f32)
    assert_same(plain(args, f64, f32), plain(cast, f64))


def test_wrapper_refuses_cpu_tensors_and_other_types():
    args = problem(8, 1)
    with pytest.raises(ValueError, match="CUDA"):
        snicar.snicar(*(args[k] for k in ARGS), args["tables"])
    with pytest.raises(TypeError, match="instantiation"):
        snicar.kernel_inputs(dict(args, weight_dtype=f32))
    a32 = problem(8, 1, f32)
    with pytest.raises(TypeError, match="instantiation"):
        snicar.kernel_inputs(dict(a32, weight_dtype=f64, sweep_dtype=f64))
    with pytest.raises(ValueError, match="albsoi"):
        snicar.kernel_inputs(dict(args, albsoi=args["albsoi"][:, :1]))


def test_routing(monkeypatch):
    """``snicar_ad_rt_both`` routes by rule: CUDA tensors that carry no
    tangent to K3, CPU tensors and differentiated calls (``torch.func.jvp``)
    to the plain sweep.  The device test is stubbed so that CPU tensors
    count as the card's; K3 is replaced by a spy."""
    args = problem(24, 4)
    call = dict(land=LAND, **args)
    want = plain(args)
    assert not sn.uses_kernel(call)         # CPU tensors: the plain sweep
    assert_same(sn.snicar_ad_rt_both(**call), want)
    monkeypatch.setattr(sn, "_on_card", lambda t: True)
    calls = []

    def spy(**kw):
        calls.append(kw)
        return sn.snicar_ad_rt_both_plain(LAND, **kw)
    monkeypatch.setattr(snicar, "snicar", spy)
    assert_same(sn.snicar_ad_rt_both(**call), want)
    assert len(calls) == 1 and "land" not in calls[0]

    def run(coszen):
        return sn.snicar_ad_rt_both(**dict(call, coszen=coszen))[0].albout
    alb, dalb = torch.func.jvp(run, (args["coszen"],),
                               (torch.ones_like(args["coszen"]),))
    assert len(calls) == 1                  # the tangent took the plain sweep
    assert torch.equal(alb, want[0].albout)
    assert bool((dalb != 0).any())
    # a differentiated table routes the same way
    tabs = args["tables"]._replace(
        ss_alb_snw_drc=args["tables"].ss_alb_snw_drc.clone()
        .requires_grad_())
    assert not sn.uses_kernel(dict(call, tables=tabs))
    assert sn.uses_kernel(call)
