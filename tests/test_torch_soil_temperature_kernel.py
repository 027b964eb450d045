"""K7, the soil temperature module as one CUDA kernel
(``csrc/soil_temperature.cu``), checked on the CPU: the source compiled as
plain C++ by the host compiler (its device code is inline functions; the
kernel and its launch sit under ``__CUDACC__``), driven column by column
through the same argument layout as on the card
(``ops.soil_temperature.kernel_inputs``), against

- the JAX package's chain of the module's functions (the surface heat
  fluxes to ``update_t_grnd``, chained as its ``driver/step.py`` chains
  them) and the port's plain chain (``soil_temperature_block_plain``), on
  the inputs the port's step gives the module in one winter step with snow
  layers and one summer noon step (the state carried from the JAX model);
- the port's plain chain on seeded inputs
  (``ops.testing.soil_temperature_problem``: 0-5 snow layers, every branch
  of the module) at 0, 1, 37 and 1,500 columns, float64 and float32, with a
  per-column land type and a 0-d one (soil, where every soil layer may hold
  supercooled water; ice sheet, where none does);

and the wrapper's layout (no copies: a 0-d input goes with a stride of 0),
the block staging's index arithmetic (every block's threads run each
staging pass in turn: each element lands in its slot or output once), the
routing of ``physics.soil_temperature.soil_temperature_block`` and the
wrapper's refusal of tangents.

Tolerance.  float64: the golden tolerance (``torch_parity.RTOL``/``ATOL``,
rtol 1e-10 with a 1e-12 floor), with ``imelt`` equal everywhere.  Bit for
bit is for the card: PyTorch's CPU ``pow`` rounds differently from the
host's C library, and its CPU sums add in another order.  float32:
``imelt`` equal on at least 99.5 % of the columns (a last-bit difference
can move a layer across freezing), and on those columns every output
within 1e-5 of the largest magnitude of its field.  Skips where no
``g++`` is installed.
"""

import ctypes
import functools
import inspect
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import torch_parity as tp
from elmkernels_torch import constants as tc
from elmkernels_torch.ops import soil_temperature as k7
from elmkernels_torch.ops import testing
from elmkernels_torch.physics import soil_temperature as tst
from test_torch_physics import EXACT, NCOL, _date

torch.set_num_threads(1)

SOURCE = (pathlib.Path(__file__).resolve().parent.parent / "elmkernels_torch"
          / "csrc" / "soil_temperature.cu")
N = 1500

_PARAMS = r"""
#define PARAMS                                                              \
  long long n, const void* const* in, const long long* in_stride,          \
      const void* const* lay, const long long* lay_stride,                 \
      const void* snl, const void* fveg, long long fveg_stride,            \
      const void* scmask, long long scmask_stride, double dtime,           \
      const double* consts, void* const* out, void* const* lay_out,        \
      void* imelt
#define ARGS(T)                                                             \
  make_args<T>(n, in, in_stride, lay, lay_stride, snl, fveg, fveg_stride,  \
               scmask, scmask_stride, dtime, consts, out, lay_out, imelt)
"""

# K7's column routine over every column in turn, on doubles and floats, and
# the kernel's layout sizes, for holding them against the wrapper's
HARNESS = r"""
#include "SOURCE"
""" + _PARAMS + r"""
#define ENTRY(NAME, T)                                                      \
  extern "C" void NAME(PARAMS) {                                           \
    const Args<T> A = ARGS(T);                                             \
    for (long long i = 0; i < n; ++i) run_column<T>(A, i);                 \
  }
ENTRY(soil_host_f64, double)
ENTRY(soil_host_f32, float)
extern "C" void layout(int* out) {
  const int v[] = {kIn, kLay, kOut, kLayOut, kConsts, kB, kSlots,
                   smem_bytes<double>(), smem_bytes<float>()};
  for (int k = 0; k < 9; ++k) out[k] = v[k];
}
"""

# K7's block staging on the host: a block's kB threads run each staging
# pass in turn (the passes are separated by barriers on the card), every
# output store counted (K7_STORE); the slots after the two load phases,
# then the stores of the layered outputs from slots and imelt bytes that
# hold (column * 1000 + slot) and (column + layer) % 3
TILE_HARNESS = r"""
#include <cmath>
#include <unordered_map>
#include <vector>
static std::unordered_map<const void*, int> g_writes;
template <typename P, typename V>
inline void count_store(P* p, V v) {
  *p = v;
  ++g_writes[static_cast<const void*>(p)];
}
#define K7_STORE(ptr, v) count_store((ptr), (v))
#include "SOURCE"
""" + _PARAMS + r"""
template <typename T>
void stage_all(const Args<T>& A, T* first, T* second) {
  std::vector<T> slots(kSlots * kLd);
  std::vector<unsigned char> melt(kLev * kB);
  for (long long i0 = 0; i0 < A.n; i0 += kB) {
    const int rows = A.n - i0 < kB ? static_cast<int>(A.n - i0) : kB;
    auto tile = [&](int tid) {
      return Tile<T>{A, i0, rows, tid, kB, slots.data(), melt.data(),
                     kLd, kB};
    };
    std::fill(slots.begin(), slots.end(), T(NAN));
    for (int t = 0; t < kB; ++t) {
      tile(t).stage(lT, sT);
      tile(t).stage(lZ, sZ);
      tile(t).stage(lTk, sTk);
      tile(t).stage(lCv, sF);
    }
    for (int r = 0; r < rows; ++r)
      for (int s = 0; s < kSlots; ++s)
        first[(i0 + r) * kSlots + s] = slots[s * kLd + r];
    for (int t = 0; t < kB; ++t) {
      tile(t).stage(lIce, sIce);
      tile(t).stage(lLiq, sLiq);
    }
    for (int r = 0; r < rows; ++r)
      for (int s = 0; s < kSlots; ++s)
        second[(i0 + r) * kSlots + s] = slots[s * kLd + r];
    for (int r = 0; r < kB; ++r) {
      for (int s = 0; s < kSlots; ++s)
        slots[s * kLd + r] = T((i0 + r) * 1000 + s);
      for (int l = 0; l < kLev; ++l)
        melt[l * kB + r] = static_cast<unsigned char>((i0 + r + l) % 3);
    }
    for (int t = 0; t < kB; ++t) {
      tile(t).store(qFact, sF, kLev);
      tile(t).store(qT, sT, kLev);
      tile(t).store(qIce, sIce, kLev);
      tile(t).store(qLiq, sLiq, kLev);
      tile(t).store(qSnofrz, sX, kSno);
      tile(t).store_imelt();
    }
  }
}
extern "C" void stage_f64(PARAMS, void* first, void* second) {
  stage_all<double>(ARGS(double), static_cast<double*>(first),
                    static_cast<double*>(second));
}
extern "C" void stage_f32(PARAMS, void* first, void* second) {
  stage_all<float>(ARGS(float), static_cast<float*>(first),
                   static_cast<float*>(second));
}
extern "C" void run_f64(PARAMS) {
  const Args<double> A = ARGS(double);
  for (long long i = 0; i < n; ++i) run_column<double>(A, i);
}
extern "C" void reset_writes() { g_writes.clear(); }
extern "C" void write_counts(const void* base, long long nelem, int elem,
                             int* out) {
  for (long long j = 0; j < nelem; ++j) {
    auto it = g_writes.find(static_cast<const char*>(base) + j * elem);
    out[j] = it == g_writes.end() ? 0 : it->second;
  }
}
extern "C" void tile_layout(int* out) {
  const int v[] = {kB, kSlots, sT, sZ, sTk, sF, sA, sB, sX, sIce, sLiq};
  for (int k = 0; k < 11; ++k) out[k] = v[k];
}
"""


def _compile(d: pathlib.Path, harness: str) -> ctypes.CDLL:
    """``harness`` (with K7's source for SOURCE) built by ``g++`` in
    directory ``d`` and loaded; skips where no ``g++`` is installed."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    (d / "harness.cpp").write_text(harness.replace("SOURCE", str(SOURCE)))
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(d / "libharness.so"),
                    str(d / "harness.cpp")], check=True, timeout=300)
    return ctypes.CDLL(str(d / "libharness.so"))


def build_host_lib(d: pathlib.Path):
    """K7's host build (HARNESS) in directory ``d``, loaded; skips where no
    ``g++`` is installed."""
    lib = _compile(d, HARNESS)
    for name in ("soil_host_f64", "soil_host_f32"):
        getattr(lib, name).argtypes = k7.ARGTYPES[:-1]  # no stream
        getattr(lib, name).restype = None
    lib.layout.restype = None
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory.mktemp("soil_kernel"))


def host_module(lib, args: dict) -> tst.SoilTemperatureOut:
    """K7's host build on ``soil_temperature_block``'s arguments."""
    k = k7.kernel_inputs(args)
    outs = k.outputs()
    name = "soil_host_f64" if k.dtype == torch.float64 else "soil_host_f32"
    getattr(lib, name)(*k.pointers(*outs))
    return k.result(*outs)


def _assert_same(got, want):
    """Bit for bit: every field, NaNs in the same places."""
    g, w = got._asdict(), want._asdict()
    for f in w:
        a, b = g[f], w[f]
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.is_floating_point():
            assert torch.equal(torch.isnan(a), torch.isnan(b)), f
            a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        assert torch.equal(a, b), f


def _assert_f64_close(got, want, path):
    assert torch.equal(got.imelt, want.imelt), path
    tp.assert_close({k: tp.as_numpy(v) for k, v in want._asdict().items()},
                    {k: tp.as_numpy(v) for k, v in got._asdict().items()},
                    path=path)


def _assert_f32_close(got, want):
    """The module docstring's float32 tolerance."""
    same = (got.imelt == want.imelt).all(dim=1)
    assert int(same.sum()) >= 0.995 * same.numel()
    g, w = got._asdict(), want._asdict()
    for f in w:
        a, b = g[f][same], w[f][same]
        if not a.is_floating_point():
            assert torch.equal(a, b), f
            continue
        assert a.dtype == b.dtype == torch.float32, f
        assert torch.equal(torch.isnan(a), torch.isnan(b)), f
        fin = torch.isfinite(b)
        if not bool(fin.any()):
            continue
        err = float((a[fin] - b[fin]).abs().max())
        assert err <= 1e-5 * float(b[fin].abs().max()), (f, err)


@functools.lru_cache(maxsize=None)
def _plain(n, dtype, land="column", seed=7):
    """A seeded problem and the plain chain's result on it (shared by the
    tests; neither is modified)."""
    args = testing.soil_temperature_problem(n, seed, dtype, land)
    return args, tst.soil_temperature_block_plain(**args)


def _scalars(args: dict) -> dict:
    """The arguments with some [ncol] inputs as 0-d tensors (the first
    column's value): the kernel reads them with a stride of 0."""
    return dict(args, **{k: args[k][0].clone()
                         for k in ("emg", "htvp", "dlrad")},
                frac_veg_nosno=args["frac_veg_nosno"][0].clone())


def _expanded(args: dict) -> dict:
    n = args["snl"].shape[0]
    return dict(args, **{k: v.expand(n) for k, v in args.items()
                         if isinstance(v, torch.Tensor) and v.dim() == 0})


def test_layout_matches_the_wrapper(host_lib):
    """The kernel's sizes are the wrapper's (the fields; a block of
    ``THREADS`` columns with ``SLOTS`` shared slots a column and
    ``shared_bytes`` a block), and the wrapper hands the inputs over
    without copies: a 0-d input as itself with a stride of 0, each [ncol]
    input and each layered one as itself with its stride; the outputs are
    fresh tensors, no input is written."""
    out = (ctypes.c_int * 9)()
    host_lib.layout(out)
    assert list(out) == [len(k7.IN_FIELDS), len(k7.LAYER_FIELDS),
                         len(k7.OUT_FIELDS), len(k7.LAYER_OUT),
                         len(k7.CONSTS), k7.THREADS, k7.SLOTS,
                         k7.shared_bytes(torch.float64),
                         k7.shared_bytes(torch.float32)]
    assert (set(k7.OUT_FIELDS) | set(k7.LAYER_OUT) | {"imelt"}
            == set(tst.SoilTemperatureOut._fields))
    args = _scalars(testing.soil_temperature_problem(64, 2))
    k = k7.kernel_inputs(args)
    for name, t, stride in zip(k7.IN_FIELDS, k.fields, k.strides):
        assert t.data_ptr() == args[name].data_ptr(), name
        assert stride == (0 if args[name].ndim == 0 else 1), name
    for name, t, stride in zip(k7.LAYER_FIELDS, k.layers, k.row_strides):
        assert t.data_ptr() == args[name].data_ptr(), name
        assert stride == args[name].stride(0), name
    assert k.snl.data_ptr() == args["snl"].data_ptr()
    assert k.fveg.data_ptr() == args["frac_veg_nosno"].data_ptr()
    # a view of a wider layer array reads as the same values
    wide = torch.cat([args["watsat"], args["watsat"]], 1)[:, :tc.NLEVGRND]
    assert wide.stride(0) == 2 * tc.NLEVGRND
    got = host_module(host_lib, dict(args, watsat=wide))
    _assert_same(got, host_module(host_lib, args))
    before = {k: v.clone() for k, v in args.items()
              if isinstance(v, torch.Tensor)}
    host_module(host_lib, args)
    for name, v in before.items():
        assert torch.equal(v, args[name]), name


@pytest.fixture(scope="module")
def tile_lib(tmp_path_factory):
    lib = _compile(tmp_path_factory.mktemp("soil_tiles"), TILE_HARNESS)
    for name in ("stage_f64", "stage_f32"):
        getattr(lib, name).argtypes = k7.ARGTYPES[:-1] + [ctypes.c_void_p] * 2
        getattr(lib, name).restype = None
    lib.run_f64.argtypes = k7.ARGTYPES[:-1]
    lib.write_counts.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_int, ctypes.c_void_p]
    for name in ("run_f64", "reset_writes", "write_counts", "tile_layout"):
        getattr(lib, name).restype = None
    return lib


def _write_counts(lib, t: torch.Tensor) -> torch.Tensor:
    counts = torch.empty(t.shape, dtype=torch.int32)
    lib.write_counts(t.data_ptr(), t.numel(), t.element_size(),
                     counts.data_ptr())
    return counts


@pytest.mark.parametrize("n", [1, k7.THREADS - 1, k7.THREADS + 1, N])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tile_mapping(tile_lib, dtype, n):
    """K7's block staging (csrc/soil_temperature.cu: Tile's stage, store
    and store_imelt), each pass run by every thread of each block of
    ``THREADS`` columns in turn, at widths that are not a multiple of the
    block (1, B - 1, B + 1, 1,500): t, z, tk and cv land in their
    columns' slots, then ice and liq in z's and tk's; each element of each
    layered output and of imelt is stored exactly once and from its own
    slot.  Then the whole host build stores every element of every output
    exactly once."""
    lay = (ctypes.c_int * 11)()
    tile_lib.tile_layout(lay)
    B, nslots, sT, sZ, sTk, sF, sA, sB, sX, sIce, sLiq = lay
    assert B == k7.THREADS and nslots == k7.SLOTS
    args = testing.soil_temperature_problem(n, 5, dtype)
    k = k7.kernel_inputs(args)
    outs, lay_out, imelt = k.outputs()
    for t in (*outs, *lay_out, imelt):
        t.fill_(-1)
    first = torch.empty(n, nslots, dtype=dtype)
    second = torch.empty(n, nslots, dtype=dtype)
    tile_lib.reset_writes()
    getattr(tile_lib, "stage_f64" if dtype == torch.float64
            else "stage_f32")(*k.pointers(outs, lay_out, imelt),
                              first.data_ptr(), second.data_ptr())
    L = tc.NLEVTOT
    for name, s0 in (("t_soisno", sT), ("z", sZ), ("tk", sTk), ("cv", sF)):
        assert torch.equal(first[:, s0:s0 + L], args[name]), name
    for name, s0 in (("t_soisno", sT), ("h2osoi_ice", sIce),
                     ("h2osoi_liq", sLiq), ("cv", sF)):
        assert torch.equal(second[:, s0:s0 + L], args[name]), name
    col = torch.arange(n, dtype=torch.float64)[:, None] * 1000

    def code(s0, w):
        return (col + s0 + torch.arange(w)).to(dtype)
    for got, s0, w in zip(lay_out, (sF, sT, sIce, sLiq, sX),
                          k7.LAYER_OUT.values()):
        assert torch.equal(got, code(s0, w))
    assert torch.equal(imelt, (torch.arange(n)[:, None]
                               + torch.arange(L)) % 3)
    for j, got in enumerate((*lay_out, imelt)):
        assert bool((_write_counts(tile_lib, got) == 1).all()), j
    # the whole module, column by column, stores each output once
    if dtype == torch.float64:
        tile_lib.reset_writes()
        tile_lib.run_f64(*k.pointers(outs, lay_out, imelt))
        for j, got in enumerate((*outs, *lay_out, imelt)):
            assert bool((_write_counts(tile_lib, got) == 1).all()), j


@pytest.mark.parametrize("n", [0, 1, 37, N])
def test_host_build_matches_plain_f64(host_lib, n):
    args, want = _plain(n, torch.float64)
    got = host_module(host_lib, args)
    _assert_f64_close(got, want, f"n={n} host K7 vs plain")
    assert got.imelt.shape == (n, tc.NLEVTOT)


@pytest.mark.parametrize("variant", ["soil", "ice", "scalars"])
def test_host_build_matches_plain_variants(host_lib, variant):
    """A 0-d land mask (one soil land type: every soil layer may hold
    supercooled water; one ice-sheet type: none), and 0-d inputs read with a
    stride of 0 (the plain chain takes them expanded)."""
    if variant == "scalars":
        args, _ = _plain(N, torch.float64)
        args = _scalars(args)
        want = tst.soil_temperature_block_plain(**_expanded(args))
        _assert_same(host_module(host_lib, args),
                     host_module(host_lib, _expanded(args)))
    else:
        args, want = _plain(N, torch.float64, variant)
    _assert_f64_close(host_module(host_lib, args), want,
                      f"{variant} host K7 vs plain")


@pytest.mark.parametrize("n", [0, 1, 37, N])
def test_host_build_matches_plain_f32(host_lib, n):
    args, want = _plain(n, torch.float32)
    got = host_module(host_lib, args)
    assert got.t_grnd.dtype == torch.float32
    _assert_f32_close(got, want)


def test_problem_reaches_every_branch(monkeypatch):
    """What ``soil_temperature_problem`` promises, read off the plain
    chain: every layer count; surface water and none, frozen in part and
    in full; layers that melt and freeze, in snow and soil; thin packs
    melted on bare soil; phase changes the round-off guard cancels; frozen
    wet soil layers that do not freeze further (their water supercooled);
    per-column land types of both masks."""
    calls = {}
    for name in ("phase_change_h2osfc", "phase_change_soisno"):
        f = getattr(tst, name)

        def spy(*a, f=f, name=name):
            calls[name] = a
            return f(*a)
        monkeypatch.setattr(tst, name, spy)
    args, _ = _plain(N, torch.float64)
    out = tst.soil_temperature_block_plain(**args)
    snl = args["snl"]
    assert set(snl.tolist()) == set(range(tc.NLEVSNO + 1))
    pc1 = calls["phase_change_h2osfc"]
    fh, t_h2osfc = pc1[3], pc1[7]
    frz = (fh > 0) & (t_h2osfc <= tc.TFRZ)
    assert bool((fh == 0).any())
    assert bool((frz & (out.h2osfc > 0)).any())       # in part
    assert bool((frz & (out.h2osfc == 0)).any())      # in full
    im = out.imelt
    for kind in (1, 2):
        assert bool((im[:, :tc.NLEVSNO] == kind).any())
        assert bool((im[:, tc.NLEVSNO:] == kind).any())
    assert bool(((snl == 0) & (out.qflx_snow_melt > 0)).any())
    (_, _, _, _, _, _, _, _, _, _, _, _, _, ice, liq,
     t) = calls["phase_change_soisno"]
    lev = torch.arange(tc.NLEVTOT)[None, :]
    active = lev >= (tc.NLEVSNO - snl)[:, None]
    changed = active & (((ice > 0) & (t > tc.TFRZ))
                        | ((liq > 0) & (t < tc.TFRZ)))
    assert bool((changed & (im == 0) & (lev < tc.NLEVSNO)).any())  # guard
    wet_frozen = (lev >= tc.NLEVSNO) & (liq > 0) & (t < tc.TFRZ)
    assert bool((wet_frozen & (im == 0)).any())
    assert bool((wet_frozen & (im == 2)).any())
    mask = tc.ltype_mask(args["land"], tc.ISTSOIL, tc.ISTCROP)
    assert bool(mask.any()) and bool((~mask).any())


# ---- against the JAX package's chain ---------------------------------------


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The module's arguments in a winter step with snow layers and a
    summer noon step of the port's step (4 columns, the exact flags), the
    state carried from the JAX model's run to that date: [(phase,
    {argument: value})]."""
    from elmkernels_tpu.utils.dates import Date as JDate
    files = tp.write_files(tmp_path_factory.mktemp("soil_kernel_jax"))
    out = []
    for phase, month, steps in (("winter", 1, 700), ("summer", 7, 24)):
        jm = tp.jax_model(files, NCOL, **EXACT)
        jm.run(JDate.from_ymd(1985, month, 1), steps)
        tm = tp.torch_model(files, NCOL, **EXACT)
        tp.carry_model(jm, tm)
        calls = []
        block = tst.soil_temperature_block

        def spy(*a, **kw):
            calls.append(dict(inspect.signature(block).bind(*a, **kw)
                              .arguments))
            return block(*a, **kw)
        tst.soil_temperature_block = spy
        try:
            tm.advance(_date(month, steps))
        finally:
            tst.soil_temperature_block = block
        out.append((phase, calls[0]))
    assert int(out[0][1]["snl"].max()) > 0
    return out


def _jax_chain(a: dict) -> dict:
    """The JAX package's module: its functions chained as its
    ``driver/step.py`` chains them, on the CPU under ``jax.disable_jit``,
    as numpy arrays by ``SoilTemperatureOut``'s fields."""
    import jax
    import jax.numpy as jnp
    from elmkernels_tpu import constants as jc
    from elmkernels_tpu.physics import soil_temperature as stp
    from elmkernels_tpu.physics.math_utils import take_layer
    land = a["land"]
    jland = jc.LandType(ltype=land.ltype, ctype=land.ctype,
                        vtype=land.vtype, urbpoi=land.urbpoi,
                        lakpoi=land.lakpoi)
    v = {k: jnp.asarray(t.numpy()) for k, t in a.items()
         if isinstance(t, torch.Tensor)}
    dtime, nsno = a["dtime"], jc.NLEVSNO
    with jax.disable_jit():
        snl, t_soisno = v["snl"], v["t_soisno"]
        snotop = nsno - snl
        sabg_chk = stp.check_absorbed_solar(v["frac_sno_eff"], v["sabg_snow"],
                                            v["sabg_soil"])

        def hs(solar, temp, sh, ev):
            return stp.calc_surface_heat_flux(
                v["frac_veg_nosno"], v["dlrad"], v["emg"], v["forc_lwrad"],
                v["htvp"], solar, temp, v[sh], v[ev])
        hs_soil = hs(v["sabg_soil"], t_soisno[:, nsno], "eflx_sh_soil",
                     "qflx_ev_soil")
        hs_h2osfc = hs(v["sabg_soil"], v["t_h2osfc"], "eflx_sh_h2osfc",
                       "qflx_ev_h2osfc")
        hs_top = hs(take_layer(v["sabg_lyr"], snotop),
                    take_layer(t_soisno, snotop), "eflx_sh_snow",
                    "qflx_ev_snow")
        dhsdT = stp.calc_dhsdT(v["cgrnd"], v["emg"], v["t_grnd"])
        fn = stp.calc_diffusive_heat_flux(snl, v["tk"], t_soisno, v["z"])
        fact = stp.calc_heat_flux_matrix_factor(snl, dtime, v["cv"], v["dz"],
                                                v["z"], v["zi"])
        lhs, rhs = stp._assemble_system(
            snl, dtime, dhsdT, v["frac_sno_eff"], v["frac_h2osfc"],
            v["dz_h2osfc"], v["c_h2osfc"], v["tk_h2osfc"], v["z"], fact,
            v["tk"], hs_top, hs_soil, hs_h2osfc, t_soisno, v["t_h2osfc"], fn,
            v["sabg_lyr"])
        upd = stp.update_temperature(snl, v["frac_h2osfc"],
                                     stp.pdma_solve(lhs, rhs), t_soisno)
        pc1 = stp.phase_change_h2osfc(
            snl, dtime, v["frac_sno"], v["frac_h2osfc"], dhsdT, v["c_h2osfc"],
            fact[:, nsno - 1], upd.t_h2osfc, v["h2osfc"], v["h2osno"],
            v["int_snow"], v["snow_depth"], v["h2osoi_ice"][:, nsno - 1],
            upd.t_soisno[:, nsno - 1])
        ice_a = v["h2osoi_ice"].at[:, nsno - 1].set(pc1.h2osoi_ice_sl1)
        t_a = upd.t_soisno.at[:, nsno - 1].set(pc1.t_soisno_sl1)
        pc2 = stp.phase_change_soisno(
            jland, snl, dtime, dhsdT, v["frac_h2osfc"], v["frac_sno_eff"],
            fact, v["watsat"], v["sucsat"], v["bsw"], v["dz"], pc1.h2osno,
            pc1.snow_depth, ice_a, v["h2osoi_liq"], t_a)
        t_grnd = stp.update_t_grnd(snl, v["frac_h2osfc"], v["frac_sno_eff"],
                                   pc1.t_h2osfc, pc2.t_soisno)
        out = dict(
            sabg_chk=sabg_chk, dhsdT=dhsdT, fact=fact, t_soisno=pc2.t_soisno,
            h2osoi_ice=pc2.h2osoi_ice, h2osoi_liq=pc2.h2osoi_liq,
            t_h2osfc=pc1.t_h2osfc, t_grnd=t_grnd, h2osfc=pc1.h2osfc,
            int_snow=pc1.int_snow, h2osno=pc2.h2osno,
            snow_depth=pc2.snow_depth, xmf_h2osfc=pc1.xmf_h2osfc,
            qflx_h2osfc_to_ice=pc1.qflx_h2osfc_to_ice,
            eflx_h2osfc_to_snow=pc1.eflx_h2osfc_to_snow, xmf=pc2.xmf,
            qflx_snomelt=pc2.qflx_snomelt,
            qflx_snow_melt=pc2.qflx_snow_melt, imelt=pc2.imelt,
            qflx_snofrz_lyr=pc2.qflx_snofrz_lyr)
    return {k: np.asarray(x) for k, x in out.items()}


def test_host_build_matches_jax_on_the_recorded_step(host_lib, recorded):
    """The module's inputs in the port's winter and summer steps through
    K7's host build: equal to the JAX package's chain and to the port's
    plain chain at the golden tolerance, with equal ``imelt``."""
    for phase, a in recorded:
        got = host_module(host_lib, a)
        want = _jax_chain(a)
        np.testing.assert_array_equal(got.imelt.numpy(), want["imelt"])
        tp.assert_close(want, {k: tp.as_numpy(x)
                               for k, x in got._asdict().items()},
                        path=f"{phase} host K7 vs JAX")
        _assert_f64_close(got, tst.soil_temperature_block_plain(**a),
                          f"{phase} host K7 vs plain")


def test_routing(monkeypatch):
    """``soil_temperature_block`` routes by rule: CUDA tensors that carry
    no tangent to K7, CPU tensors and differentiated calls
    (``torch.func.jvp``) to the plain chain.  The device test is stubbed
    so that CPU tensors count as the card's; K7 is replaced by a spy."""
    args, want = _plain(16, torch.float64)
    assert not tst.uses_kernel(args)     # CPU tensors: the plain chain
    monkeypatch.setattr(tst, "_on_card", lambda t: True)
    calls = []

    def spy(**kw):
        calls.append(kw)
        return tst.soil_temperature_block_plain(**kw)
    monkeypatch.setattr(k7, "soil_temperature", spy)
    _assert_same(tst.soil_temperature_block(**args), want)
    assert len(calls) == 1

    def run(t_grnd):
        return tst.soil_temperature_block(**dict(args, t_grnd=t_grnd)).t_grnd
    tg, dtg = torch.func.jvp(run, (args["t_grnd"],),
                             (torch.ones_like(args["t_grnd"]),))
    assert len(calls) == 1               # the tangent went to the plain chain
    assert torch.equal(tg, want.t_grnd)
    assert bool((dtg != 0).any())
    tk = args["tk"].clone().requires_grad_()
    assert not tst.uses_kernel(dict(args, tk=tk))
    assert tst.uses_kernel(args)


def test_wrapper_refuses_tangents_and_cpu_tensors():
    args, _ = _plain(4, torch.float64)
    with pytest.raises(RuntimeError, match="soil_temperature_block"):
        k7.soil_temperature(**dict(
            args, cgrnd=args["cgrnd"].clone().requires_grad_()))
    with pytest.raises(ValueError, match="CUDA"):
        k7.soil_temperature(**args)
