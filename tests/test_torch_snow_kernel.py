"""K5, the snow-hydrology block as one CUDA kernel
(``csrc/snow_hydrology.cu``), checked on the CPU: the source compiled as
plain C++ by the host compiler (its device code is inline functions; the
kernel and its launch sit under ``__CUDACC__``), driven column by column
through the same argument layout as on the card
(``ops.snow.kernel_inputs``), against

- the JAX package's ten functions of the block (``snow_water`` to
  ``snow_aging``/``snow_aging_pinned``, chained as its ``driver/step.py``
  chains them), on the inputs the JAX step gives them in one summer noon
  step and one winter step with snow layers (recorded under
  ``jax.disable_jit``, as ``test_torch_physics.py`` records them), in both
  aging modes;
- the port's plain block (``snow_hydrology_block_plain``) on seeded inputs
  (``ops.testing.snow_problem``: 0-5 layers, every branch of the block) at
  0, 1, 31, 33 and 4,000 columns, in both aging modes, float64 and
  float32, with per-column and 0-d deposition rates and an urban domain;

and the wrapper's layout (no copies: a 0-d rate goes with a stride of 0),
the block staging's index arithmetic (every block's threads run each
staging pass in turn: each element lands in its slot or output once), and
the routing of ``physics.snow_hydrology.snow_hydrology_block``.

Tolerance.  float64: the golden tolerance (``torch_parity.RTOL``/``ATOL``,
rtol 1e-10 with a 1e-12 floor), with ``snl`` equal on every column.  Bit
for bit is for the card: PyTorch's CPU ``exp``, ``acos`` and ``pow``
round differently from the host's C library, and its CPU sums add in
another order.  float32: ``snl`` equal on at least 99.5 % of the columns
(a last-bit difference can move a layer across a threshold of combine or
divide), and on those columns every output within 1e-5 of the largest
magnitude of its field (measured on the 4,000 seeded columns: 1.8e-7 at
most, ``snl`` equal on every column).  Skips where no ``g++``
is installed.
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
from elmkernels_torch.data.state import AERO_SPECIES
from elmkernels_torch.ops import snow, testing
from elmkernels_torch.physics import snow_hydrology as tsh
from test_torch_physics import EXACT, NCOL, _date, _port_value

torch.set_num_threads(1)

SOURCE = (pathlib.Path(__file__).resolve().parent.parent / "elmkernels_torch"
          / "csrc" / "snow_hydrology.cu")
N = 4000

# K5's column routine over every column in turn, on doubles and floats, and
# the kernel's layout sizes, for holding them against the wrapper's
HARNESS = r"""
#include "SOURCE"
#define PARAMS                                                              \
  long long n, const void* const* in, const long long* in_stride,          \
      const void* const* lay, const long long* lay_stride,                 \
      const void* snl, const void* do_capsnow, long long capsnow_stride,   \
      const void* imelt, long long imelt_stride, const void* soil_like,    \
      long long soil_like_stride, const void* soil_crop,                   \
      long long soil_crop_stride, const void* tau, const void* kappa,      \
      const void* drdt0, int n_t, int n_tgrd, int n_rhos, int nlevtot,     \
      double dtime, const double* consts, void* snl_out, void* const* out, \
      void* const* lay_out
#define ENTRY(NAME, T)                                                      \
  extern "C" void NAME(int elm, PARAMS) {                                  \
    const Args<T> A = make_args<T>(                                        \
        n, in, in_stride, lay, lay_stride, snl, do_capsnow,                \
        capsnow_stride, imelt, imelt_stride, soil_like, soil_like_stride,  \
        soil_crop, soil_crop_stride, tau, kappa, drdt0, n_t, n_tgrd,       \
        n_rhos, nlevtot, dtime, consts, snl_out, out, lay_out);            \
    for (long long i = 0; i < n; ++i) {                                    \
      if (elm) run_column<T, true>(A, i);                                  \
      else run_column<T, false>(A, i);                                     \
    }                                                                      \
  }
ENTRY(snow_host_f64, double)
ENTRY(snow_host_f32, float)
extern "C" void layout(int* out) {
  out[0] = kIn;
  out[1] = kLay;
  out[2] = kOut;
  out[3] = kLayOut;
  out[4] = kConsts;
  out[5] = kB;
  out[6] = kSlots;
  out[7] = smem_bytes<double>();
  out[8] = smem_bytes<float>();
}
"""

# K5's block staging on the host: a block's kB threads run each staging
# pass in turn (the passes are separated by barriers on the card), every
# output store counted (K5_STORE); the slots after each pass, then the
# stores of the outputs from slots that hold (column * 100 + slot)
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
#define K5_STORE(ptr, v) count_store((ptr), (v))
#include "SOURCE"
#define PARAMS                                                              \
  long long n, const void* const* in, const long long* in_stride,          \
      const void* const* lay, const long long* lay_stride,                 \
      const void* snl, const void* do_capsnow, long long capsnow_stride,   \
      const void* imelt, long long imelt_stride, const void* soil_like,    \
      long long soil_like_stride, const void* soil_crop,                   \
      long long soil_crop_stride, const void* tau, const void* kappa,      \
      const void* drdt0, int n_t, int n_tgrd, int n_rhos, int nlevtot,     \
      double dtime, const double* consts, void* snl_out, void* const* out, \
      void* const* lay_out
#define ARGS(T)                                                             \
  make_args<T>(n, in, in_stride, lay, lay_stride, snl, do_capsnow,         \
               capsnow_stride, imelt, imelt_stride, soil_like,             \
               soil_like_stride, soil_crop, soil_crop_stride, tau, kappa,  \
               drdt0, n_t, n_tgrd, n_rhos, nlevtot, dtime, consts,         \
               snl_out, out, lay_out)
template <typename T>
void stage_all(const Args<T>& A, T* hot, T* cold, unsigned char* melt_out) {
  std::vector<T> slots(kSlots * kLd);
  std::vector<unsigned char> melt(kSno * kB);
  for (long long i0 = 0; i0 < A.n; i0 += kB) {
    const int rows = A.n - i0 < kB ? static_cast<int>(A.n - i0) : kB;
    auto tile = [&](int tid) {
      return Tile<T>{A, i0, rows, tid, kB, slots.data(), melt.data(),
                     kLd, kB};
    };
    std::fill(slots.begin(), slots.end(), T(NAN));
    for (int t = 0; t < kB; ++t) stage_hot(tile(t));
    for (int r = 0; r < rows; ++r)
      for (int s = 0; s < kSlots; ++s)
        hot[(i0 + r) * kSlots + s] = slots[s * kLd + r];
    for (int t = 0; t < kB; ++t) stage_cold(tile(t));
    for (int r = 0; r < rows; ++r) {
      for (int s = 0; s < kSlots; ++s)
        cold[(i0 + r) * kSlots + s] = slots[s * kLd + r];
      for (int p = 0; p < kSno; ++p)
        melt_out[(i0 + r) * kSno + p] = melt[p * kB + r];
    }
    for (int r = 0; r < kB; ++r)
      for (int s = 0; s < kSlots; ++s)
        slots[s * kLd + r] = T((i0 + r) * 100 + s);
    for (int t = 0; t < kB; ++t) store_masses(tile(t), qMss);
    for (int t = 0; t < kB; ++t) store_masses(tile(t), qCnc);
    for (int t = 0; t < kB; ++t) store_layers(tile(t));
  }
}
extern "C" void stage_f64(PARAMS, void* hot, void* cold,
                          unsigned char* melt) {
  stage_all<double>(ARGS(double), static_cast<double*>(hot),
                    static_cast<double*>(cold), melt);
}
extern "C" void stage_f32(PARAMS, void* hot, void* cold,
                          unsigned char* melt) {
  stage_all<float>(ARGS(float), static_cast<float*>(hot),
                   static_cast<float*>(cold), melt);
}
extern "C" void run_f64(int elm, PARAMS) {
  const Args<double> A = ARGS(double);
  for (long long i = 0; i < n; ++i) {
    if (elm) run_column<double, true>(A, i);
    else run_column<double, false>(A, i);
  }
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
  const int v[] = {kB, kSlots, hIce, hLiq, cMss, cRds, cT, cDz, cZi5, cIce5,
                   cLiq5, rIce, rLiq, rZ, rZi};
  for (int k = 0; k < 15; ++k) out[k] = v[k];
}
"""


def _compile(d: pathlib.Path, harness: str) -> ctypes.CDLL:
    """``harness`` (with K5's source for SOURCE) built by ``g++`` in
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
    """K5's host build (HARNESS) in directory ``d``, loaded; skips where no
    ``g++`` is installed."""
    lib = _compile(d, HARNESS)
    for name in ("snow_host_f64", "snow_host_f32"):
        getattr(lib, name).argtypes = snow.ARGTYPES[:-1]  # no stream
        getattr(lib, name).restype = None
    lib.layout.restype = None
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_lib(tmp_path_factory.mktemp("snow_kernel"))


def host_block(lib, args: dict) -> tsh.SnowBlockOut:
    """K5's host build on ``snow_hydrology_block``'s arguments."""
    k = snow.kernel_inputs(args)
    outs = k.outputs()
    name = "snow_host_f64" if k.dtype == torch.float64 else "snow_host_f32"
    getattr(lib, name)(int(k.elm), *k.pointers(*outs))
    return k.result(*outs)


def _expanded(args: dict) -> dict:
    """The arguments with 0-d deposition rates expanded to [ncol], as the
    plain block takes them."""
    n = args["snl"].shape[0]
    aero = {k: v.expand(n) for k, v in args["aero_in"].items()}
    return dict(args, aero_in=aero)


def _as_dict(out: tsh.SnowBlockOut) -> dict:
    d = out._asdict()
    for k in ("mss", "cnc"):
        d.update({f"{k}_{s}": v for s, v in d.pop(k).items()})
    return d


def _assert_same(got, want):
    """Bit for bit: every field, NaNs in the same places."""
    g, w = _as_dict(got), _as_dict(want)
    for f in w:
        a, b = g[f], w[f]
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.is_floating_point():
            assert torch.equal(torch.isnan(a), torch.isnan(b)), f
            a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        assert torch.equal(a, b), f


def _assert_f64_close(got, want, path):
    assert torch.equal(got.snl, want.snl), path
    tp.assert_close({k: tp.as_numpy(v) for k, v in _as_dict(want).items()},
                    {k: tp.as_numpy(v) for k, v in _as_dict(got).items()},
                    path=path)


def _assert_f32_close(got, want):
    """The module docstring's float32 tolerance."""
    same = got.snl == want.snl
    assert int(same.sum()) >= 0.995 * same.numel()
    g, w = _as_dict(got), _as_dict(want)
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


def test_layout_matches_the_wrapper(host_lib):
    """The kernel's sizes are the wrapper's (the fields; a block of
    ``snow.THREADS`` columns with ``snow.SLOTS`` shared slots a column and
    ``snow.shared_bytes`` a block), and the wrapper hands the inputs over
    without copies: a 0-d deposition rate as itself with a
    stride of 0, each [ncol] input and each layered one as itself with its
    stride; the outputs are fresh tensors."""
    out = (ctypes.c_int * 9)()
    host_lib.layout(out)
    assert list(out) == [len(snow.IN_FIELDS), len(snow.LAYER_FIELDS),
                         len(snow.OUT_FIELDS), 7 + 2 * len(AERO_SPECIES),
                         len(snow.CONSTS), snow.THREADS, snow.SLOTS,
                         snow.shared_bytes(torch.float64),
                         snow.shared_bytes(torch.float32)]
    assert set(snow.OUT_FIELDS) | {
        "snl", "t_soisno", "h2osoi_ice", "h2osoi_liq", "dz", "z", "zi",
        "snw_rds", "mss", "cnc"} == set(tsh.SnowBlockOut._fields)
    args = testing.snow_problem(64, 2, aero_scalar=True)
    k = snow.kernel_inputs(args)
    for name, t, stride in zip(snow.IN_FIELDS, k.fields, k.strides):
        v = (args["aero_in"][name[5:]] if name.startswith("aero_")
             else args[name])
        assert t.data_ptr() == v.data_ptr(), name
        assert stride == (0 if v.ndim == 0 else v.stride(0)), name
    layered = dict(args, **{"mss_" + s: v for s, v in args["mss"].items()})
    for name, t, stride in zip(snow.LAYER_FIELDS, k.layers, k.row_strides):
        assert t.data_ptr() == layered[name].data_ptr(), name
        assert stride == layered[name].stride(0), name
    assert k.snl.data_ptr() == args["snl"].data_ptr()
    assert k.imelt.data_ptr() == args["imelt"].data_ptr()
    # a view of a wider layer array reads as the same values
    wide = torch.cat([args["swe_old"], args["swe_old"]], 1)[:, :5]
    assert wide.stride(0) == 10
    got = host_block(host_lib, dict(args, swe_old=wide))
    _assert_same(got, host_block(host_lib, args))
    # no input is written
    before = {k: v.clone() for k, v in layered.items()
              if isinstance(v, torch.Tensor)}
    host_block(host_lib, args)
    for name, v in before.items():
        assert torch.equal(v, layered[name]), name


@pytest.fixture(scope="module")
def tile_lib(tmp_path_factory):
    lib = _compile(tmp_path_factory.mktemp("snow_tiles"), TILE_HARNESS)
    for name in ("stage_f64", "stage_f32"):
        getattr(lib, name).argtypes = snow.ARGTYPES[1:-1] + [ctypes.c_void_p] * 3
        getattr(lib, name).restype = None
    lib.run_f64.argtypes = snow.ARGTYPES[:-1]
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


@pytest.mark.parametrize("views", [False, True], ids=["rows", "views"])
@pytest.mark.parametrize("n", [1, snow.THREADS - 1, snow.THREADS + 1, N])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tile_mapping(tile_lib, dtype, n, views):
    """K5's block staging (csrc/snow_hydrology.cu: stage_hot, stage_cold,
    store_masses, store_layers), each pass run by every
    thread of each block of ``snow.THREADS`` columns in turn, at widths
    that are not a multiple of the block (1, B - 1, B + 1, 4,000), with
    the layered inputs as fresh rows and as views of arrays twice as wide
    (a row stride larger than the width): every snow position lands in its
    column's slot; the soil rows (t, ice, liq, dz from position 6, z and
    zi from 5) equal the inputs, the liquid as (x + 0) + 0; each output
    element is stored exactly once and from its own slot.  Then the whole
    host build stores every element of every output exactly once."""
    lay = (ctypes.c_int * 15)()
    tile_lib.tile_layout(lay)
    (B, nslots, hIce, hLiq, cMss, cRds, cT, cDz, cZi5, cIce5, cLiq5, rIce,
     rLiq, rZ, rZi) = lay
    assert B == snow.THREADS
    args = testing.snow_problem(n, 5, dtype, True)
    if views:
        args = testing.snow_layers_as_views(args)
    k = snow.kernel_inputs(args)
    assert all(t.stride(0) == (2 if views else 1) * t.shape[1]
               for t in k.layers)
    snl_out, outs, lay_out = k.outputs()
    for t in (snl_out, *outs, *lay_out):
        t.fill_(-1)
    hot = torch.empty(n, nslots, dtype=dtype)
    cold = torch.empty(n, nslots, dtype=dtype)
    melt = torch.empty(n, tc.NLEVSNO, dtype=torch.uint8)
    tile_lib.reset_writes()
    getattr(tile_lib, "stage_f64" if dtype == torch.float64
            else "stage_f32")(*k.pointers(snl_out, outs, lay_out),
                              hot.data_ptr(), cold.data_ptr(),
                              melt.data_ptr())
    a, ns, L = args, tc.NLEVSNO, tc.NLEVTOT
    # the slots: the snow layers' ice and liq for the registers; the
    # temperatures and thicknesses (0-5), zi[5] and the top soil row's ice
    # and liq stay through the second phase
    for name, s0 in (("h2osoi_ice", hIce), ("h2osoi_liq", hLiq)):
        assert torch.equal(hot[:, s0:s0 + ns], a[name][:, :ns]), name
    for got in (hot, cold):
        for name, s0 in (("t_soisno", cT), ("dz", cDz)):
            assert torch.equal(got[:, s0:s0 + ns + 1], a[name][:, :ns + 1])
        for name, s0 in (("zi", cZi5), ("h2osoi_ice", cIce5),
                         ("h2osoi_liq", cLiq5)):
            assert torch.equal(got[:, s0], a[name][:, ns]), name
    for j, sp in enumerate(AERO_SPECIES):
        s0 = cMss + j * ns
        assert torch.equal(cold[:, s0:s0 + ns], a["mss"][sp][:, :ns]), sp
    assert torch.equal(cold[:, cRds:cRds + ns], a["snw_rds"][:, :ns])
    assert torch.equal(melt, (a["imelt"][:, :ns] == 1).to(torch.uint8))
    # the outputs: the soil rows from the inputs, the rest from the slots
    col = torch.arange(n, dtype=torch.float64)[:, None] * 100

    def code(s0, w):
        return (col + s0 + torch.arange(w)).to(dtype)
    t, ice, liq, dz, z, zi, rds = lay_out[:7]
    for got, name, s0 in ((t, "t_soisno", cT), (ice, "h2osoi_ice", rIce),
                          (liq, "h2osoi_liq", rLiq), (dz, "dz", cDz)):
        soil = a[name][:, ns + 1:]
        if name == "h2osoi_liq":
            soil = (soil + 0.0) + 0.0
        assert torch.equal(got[:, ns + 1:], soil), name
        assert torch.equal(got[:, :ns + 1], code(s0, ns + 1)), name
    assert torch.equal(z[:, ns:], a["z"][:, ns:])
    assert torch.equal(zi[:, ns:], a["zi"][:, ns:])
    assert torch.equal(z[:, :ns], code(rZ, ns))
    assert torch.equal(zi[:, :ns], code(rZi, ns))
    assert torch.equal(rds, code(cRds, ns))
    nsp = len(AERO_SPECIES)
    for j in range(nsp):
        assert torch.equal(lay_out[7 + j], code(cMss + j * ns, ns))
        assert torch.equal(lay_out[7 + nsp + j], code(cMss + j * ns, ns))
    for j, got in enumerate(lay_out):
        assert bool((_write_counts(tile_lib, got) == 1).all()), j
    # the whole block, column by column, stores each output once
    if dtype == torch.float64:
        tile_lib.reset_writes()
        tile_lib.run_f64(1, *k.pointers(snl_out, outs, lay_out))
        for j, got in enumerate((snl_out, *outs, *lay_out)):
            assert bool((_write_counts(tile_lib, got) == 1).all()), j


# ---- against the JAX package's functions -----------------------------------

# the JAX functions whose calls hold the block's inputs, by module
_RECORDED = {"snow_hydrology": ("snow_water", "compute_aerosol_deposition",
                                "snow_compaction", "combine_layers",
                                "update_aerosol_mass_and_concen"),
             "canopy_hydrology": ("ground_flux",),
             "soil_temperature": ("phase_change_soisno",)}


@pytest.fixture(scope="module")
def jax_blocks(tmp_path_factory):
    """The block's arguments in a winter step with snow layers and a summer
    noon step of the JAX model (4 columns, the exact flags), as numpy:
    [(phase, JAX LandType, {argument: value})]."""
    import importlib
    import jax
    from test_torch_physics import _to_numpy
    files = tp.write_files(tmp_path_factory.mktemp("snow_kernel_jax"))
    from elmkernels_tpu.utils.dates import Date as JDate
    winter = tp.jax_model(files, NCOL, **EXACT)
    winter.run(JDate.from_ymd(1985, 1, 1), 700)
    assert int(np.asarray(winter.state.snl).max()) > 0
    summer = tp.jax_model(files, NCOL, **EXACT)
    summer.run(JDate.from_ymd(1985, 7, 1), 24)
    blocks = []
    for phase, model, date in (("winter", winter, _date(1, 700)),
                               ("summer", summer, _date(7, 24))):
        calls, patched = {}, []
        for mod_name, names in _RECORDED.items():
            mod = importlib.import_module(f"elmkernels_tpu.physics."
                                          f"{mod_name}")
            for name in names:
                f = getattr(mod, name)

                def wrapped(*a, f=f, name=name, **kw):
                    out = f(*a, **kw)
                    bound = inspect.signature(f).bind(*a, **kw).arguments
                    calls.setdefault(name, (dict(bound), out))
                    return out
                patched.append((mod, name, f))
                setattr(mod, name, wrapped)
        try:
            with jax.disable_jit():
                model.advance(date)
        finally:
            for mod, name, f in patched:
                setattr(mod, name, f)
        calls = _to_numpy(calls)
        sw, _ = calls["snow_water"]
        dep, _ = calls["compute_aerosol_deposition"]
        comp, _ = calls["snow_compaction"]
        cb, _ = calls["combine_layers"]
        upd, _ = calls["update_aerosol_mass_and_concen"]
        _, gf = calls["ground_flux"]
        _, pc2 = calls["phase_change_soisno"]
        st = cb["st"]
        p = model.params
        args = dict(
            dtime=sw["dtime"], do_capsnow=sw["do_capsnow"], snl=sw["snl"],
            frac_sno_eff=sw["frac_sno_eff"], frac_sno=sw["frac_sno"],
            h2osno=sw["h2osno"], snow_depth=cb["snow_depth"],
            int_snow=sw["int_snow"], qflx_sub_snow=sw["qflx_sub_snow"],
            qflx_evap_grnd=sw["qflx_evap_grnd"],
            qflx_dew_snow=sw["qflx_dew_snow"],
            qflx_dew_grnd=sw["qflx_dew_grnd"],
            qflx_rain_grnd=sw["qflx_rain_grnd"],
            qflx_snomelt=sw["qflx_snomelt"],
            qflx_snow_melt=sw["qflx_snow_melt"],
            h2osoi_liq=sw["h2osoi_liq"], h2osoi_ice=sw["h2osoi_ice"],
            t_soisno=comp["t_soisno"], dz=sw["dz"], z=st.z, zi=st.zi,
            mss=sw["mss"], aero_in=dep["aero_in"], n_melt=comp["n_melt"],
            imelt=comp["imelt"], swe_old=comp["swe_old"],
            frac_iceold=comp["frac_iceold"], snw_rds=st.rds,
            qflx_snwcp_ice=upd["qflx_snwcp_ice"],
            qflx_snow_grnd=np.asarray(gf.qflx_snow_grnd),
            qflx_snofrz_lyr=np.asarray(pc2.qflx_snofrz_lyr),
            snowage_tau=np.asarray(p.snowage_tau),
            snowage_kappa=np.asarray(p.snowage_kappa),
            snowage_drdt0=np.asarray(p.snowage_drdt0))
        # the recorded inputs are the step's: the layer state compaction
        # and combine saw is the one snow_water was given
        np.testing.assert_array_equal(comp["snl"], args["snl"])
        blocks.append((phase, sw["land"], args))
    return blocks


def _jax_block(land, a: dict, elm: bool) -> tsh.SnowBlockOut:
    """The JAX package's block: its ten functions chained as its
    ``driver/step.py`` chains them, on the CPU under ``jax.disable_jit``,
    as the port's ``SnowBlockOut`` of numpy arrays."""
    import jax
    import jax.numpy as jnp
    from elmkernels_tpu.physics import snow_hydrology as sh
    with jax.disable_jit():
        a = jax.tree_util.tree_map(jnp.asarray, a)
        snl, dtime, fse = a["snl"], float(a["dtime"]), a["frac_sno_eff"]
        sw = sh.snow_water(
            land, a["do_capsnow"], snl, dtime, fse, a["h2osno"],
            a["qflx_sub_snow"], a["qflx_evap_grnd"], a["qflx_dew_snow"],
            a["qflx_dew_grnd"], a["qflx_rain_grnd"], a["qflx_snomelt"],
            a["qflx_snow_melt"], a["int_snow"], a["frac_sno"],
            a["h2osoi_liq"], a["h2osoi_ice"], a["mss"], a["dz"])
        mss = sh.compute_aerosol_deposition(dtime, snl, a["aero_in"], sw.mss)
        bcphi, bcpho = sh.aerosol_phase_change(
            snl, dtime, a["qflx_sub_snow"], sw.h2osoi_liq, sw.h2osoi_ice,
            mss["bcphi"], mss["bcpho"])
        mss = dict(mss, bcphi=bcphi, bcpho=bcpho)
        dz = sh.snow_compaction(land, snl, dtime, sw.int_snow, a["n_melt"],
                                sw.frac_sno, a["imelt"], a["swe_old"],
                                sw.h2osoi_liq, sw.h2osoi_ice, a["t_soisno"],
                                a["frac_iceold"], sw.dz)
        st = sh.SnowState(snl, a["t_soisno"], sw.h2osoi_ice, sw.h2osoi_liq,
                          a["snw_rds"], mss, dz, a["z"], a["zi"])
        cb = sh.combine_layers(land, dtime, st, a["h2osno"],
                               a["snow_depth"], fse, sw.frac_sno,
                               sw.int_snow)
        nolyr = snl == 0
        cb = cb._replace(
            h2osno=jnp.where(nolyr, a["h2osno"], cb.h2osno),
            snow_depth=jnp.where(nolyr, a["snow_depth"], cb.snow_depth),
            frac_sno=jnp.where(nolyr, sw.frac_sno, cb.frac_sno),
            frac_sno_eff=jnp.where(nolyr, fse, cb.frac_sno_eff),
            int_snow=jnp.where(nolyr, sw.int_snow, cb.int_snow),
            qflx_sl_top_soil=jnp.where(nolyr, 0.0, cb.qflx_sl_top_soil),
            qflx_snow2topsoi=jnp.where(nolyr, 0.0, cb.qflx_snow2topsoi),
            mflx_snowlyr_col=jnp.where(nolyr, 0.0, cb.mflx_snowlyr_col))
        st = sh.divide_layers(cb.frac_sno, cb.state)
        st = sh.prune_snow_layers(st)
        mss2, cnc = sh.update_aerosol_mass_and_concen(
            dtime, st.snl, a["do_capsnow"], a["qflx_snwcp_ice"], st.ice,
            st.liq, st.mss)
        if elm:
            rds = sh.snow_aging(
                a["do_capsnow"], st.snl, cb.frac_sno, dtime,
                a["qflx_snwcp_ice"], a["qflx_snow_grnd"], cb.h2osno, st.dz,
                st.liq, st.ice, st.t, a["qflx_snofrz_lyr"],
                a["snowage_tau"], a["snowage_kappa"], a["snowage_drdt0"],
                st.rds, elm_correct_clamp=True)
        else:
            rds = sh.snow_aging_pinned(st.snl, cb.h2osno, st.rds)
        out = tsh.SnowBlockOut(
            st.snl, st.t, st.ice, st.liq, st.dz, st.z, st.zi, rds, mss2, cnc,
            cb.h2osno, cb.snow_depth, cb.frac_sno, cb.frac_sno_eff,
            cb.int_snow, sw.qflx_snow_melt, sw.qflx_top_soil,
            cb.qflx_sl_top_soil, cb.qflx_snow2topsoi, cb.mflx_snowlyr_col,
            sw.mflx_neg_snow)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("elm", [False, True], ids=["pinned", "elm"])
def test_host_build_matches_jax_on_the_recorded_step(host_lib, jax_blocks,
                                                     elm):
    """The block's inputs in the JAX step through K5's host build: equal to
    the JAX package's ten functions and to the port's plain block at the
    golden tolerance, with equal layer counts, in both aging modes (the
    recorded runs age with the pinned radius; ELM's aging runs on the same
    inputs)."""
    for phase, jland, a in jax_blocks:
        want = _jax_block(jland, a, elm)
        args = _port_value(dict(a, land=jland), False)
        args["elm_correct_snow_aging"] = elm
        got = host_block(host_lib, args)
        tp.assert_close({k: np.asarray(v) for k, v in
                         _as_dict(want).items()},
                        {k: tp.as_numpy(v) for k, v in _as_dict(got).items()},
                        path=f"{phase} host K5 vs JAX")
        plain = tsh.snow_hydrology_block_plain(**args)
        _assert_f64_close(got, plain, f"{phase} host K5 vs plain")
    winter = jax_blocks[0][2]
    assert int(np.asarray(winter["snl"]).max()) > 0  # live layers


@functools.lru_cache(maxsize=None)
def _plain(n, dtype, elm, aero_scalar=False, urbpoi=False, seed=7):
    """A seeded problem and the plain block's result on it (shared by the
    tests; neither is modified)."""
    args = testing.snow_problem(n, seed, dtype, elm, aero_scalar, urbpoi)
    return args, tsh.snow_hydrology_block_plain(**_expanded(args))


@pytest.mark.parametrize("elm", [False, True], ids=["pinned", "elm"])
@pytest.mark.parametrize("n", [0, 1, 31, 33, N])
def test_host_build_matches_plain_f64(host_lib, n, elm):
    args, want = _plain(n, torch.float64, elm)
    got = host_block(host_lib, args)
    _assert_f64_close(got, want, f"n={n} host K5 vs plain")
    assert got.snl.shape == (n,) and got.zi.shape == (n, tc.NLEVTOT + 1)


@pytest.mark.parametrize("variant", ["aero_scalar", "urbpoi"])
@pytest.mark.parametrize("elm", [False, True], ids=["pinned", "elm"])
def test_host_build_matches_plain_variants(host_lib, variant, elm):
    """0-d deposition rates (read with a stride of 0; the plain block takes
    them expanded) and an urban domain, where every column is soil-like."""
    args, want = _plain(N, torch.float64, elm, **{variant: True})
    got = host_block(host_lib, args)
    _assert_f64_close(got, want, f"{variant} host K5 vs plain")
    if variant == "aero_scalar":
        _assert_same(got, host_block(host_lib, _expanded(args)))


@pytest.mark.parametrize("elm", [False, True], ids=["pinned", "elm"])
def test_host_build_matches_plain_f32(host_lib, elm):
    args, want = _plain(N, torch.float32, elm)
    got = host_block(host_lib, args)
    assert got.h2osno.dtype == torch.float32
    _assert_f32_close(got, want)


def test_problem_reaches_every_branch():
    """What ``snow_problem`` promises, read off the plain block's result:
    every layer count before and after, packs that lose layers (merged or
    dissolved) and that gain them (divided, up to 5), layerless packs,
    negative liquid exported, a bottom layer merged into the soil and a
    dissolved pack's liquid handed to it, capped snow, ELM aging that
    moves the radius inside [SNW_RDS_MIN, SNW_RDS_MAX]."""
    args, out = _plain(N, torch.float64, True)
    snl0, snl1 = args["snl"], out.snl
    assert set(snl0.tolist()) == set(snl1.tolist()) == set(range(6))
    assert bool((snl1 < snl0).any()) and bool((snl1 > snl0).any())
    assert bool(((snl0 > 1) & (snl1 == 0)).any())
    assert bool(((snl0 == 0) & (args["h2osno"] > 0)).any())
    assert bool((out.mflx_neg_snow != 0).any())
    assert bool((out.qflx_sl_top_soil != 0).any())
    assert bool((out.qflx_snow2topsoi != 0).any())
    assert bool((args["do_capsnow"] != 0).any())
    live = out.snw_rds[snl1 > 0]
    assert bool(((live > tc.SNW_RDS_MIN) & (live < tc.SNW_RDS_MAX)).any())
    lt = args["land"].ltype
    for t in (tc.ISTSOIL, tc.ISTCROP, tc.ISTICE, tc.ISTWET, tc.ISTURB_MIN):
        assert bool((lt == t).any())


def test_routing(monkeypatch):
    """``snow_hydrology_block`` routes by rule: CUDA tensors that carry no
    tangent to K5, CPU tensors and differentiated calls
    (``torch.func.jvp``) to the plain block.  The device test is stubbed
    so that CPU tensors count as the card's; K5 is replaced by a spy."""
    args, want = _plain(16, torch.float64, False)
    assert not tsh.uses_kernel(args)     # CPU tensors: the plain block
    monkeypatch.setattr(tsh, "_on_card", lambda t: True)
    calls = []

    def spy(**kw):
        calls.append(kw)
        return tsh.snow_hydrology_block_plain(**kw)
    monkeypatch.setattr(snow, "snow_hydrology", spy)
    out = tsh.snow_hydrology_block(**args)
    assert len(calls) == 1
    _assert_same(out, want)

    def run(h2osno):
        return tsh.snow_hydrology_block(**dict(args, h2osno=h2osno)).h2osno
    h, dh = torch.func.jvp(run, (args["h2osno"],),
                           (torch.ones_like(args["h2osno"]),))
    assert len(calls) == 1               # the tangent went to the plain block
    assert torch.equal(h, want.h2osno)
    assert bool((dh != 0).any())
    # a differentiated species mass routes the same way
    mss = dict(args["mss"], dst1=args["mss"]["dst1"].clone()
               .requires_grad_())
    assert not tsh.uses_kernel(dict(args, mss=mss))
    assert tsh.uses_kernel(args)


def test_wrapper_refuses_cpu_tensors():
    args, _ = _plain(4, torch.float64, False)
    with pytest.raises(ValueError, match="CUDA"):
        snow.snow_hydrology(**args)
