"""K2, the canopy stability loop as one CUDA kernel
(``csrc/canopy_stability.cu``), checked on the CPU: the source compiled as
plain C++ by the host compiler (its device code is inline functions; the
kernel and its launch sit under ``__CUDACC__``), driven column by column
through the same argument layout as on the card
(``ops.canopy.kernel_inputs``), against

- the JAX package's ``canopy_fluxes.stability_iteration`` on the inputs the
  JAX step gives it (one summer noon and one winter step with snow layers,
  recorded under ``jax.disable_jit`` as ``test_torch_physics.py`` records
  them), and the port's plain loop on the same inputs;
- the port's plain loop on seeded inputs (``ops.testing.canopy_problem``)
  in the three photosynthesis modes, float64 and float32, cold and warm
  started;

and K2's schedule: its resumable per-column machine (``column_begin``,
``pass_head``, ``leaf_step``, ``pass_tail``) driven on a simulated 32-lane
warp whose lanes take columns in a seeded random order as theirs stop and
advance in a seeded random interleaving, bit for bit against the same
machine run one column at a time, and against the plain loop, at 2,000 and
4,000 columns and at 0, 1, 31 and 33; the wrapper's layout (no copies: a
0-d trait goes with a stride of 0); and the routing of
``physics.canopy_fluxes.stability_iteration``.

Tolerance.  float64: the golden tolerance (``torch_parity.RTOL``/``ATOL``,
rtol 1e-10 with a 1e-12 floor), with equal iteration counts (``itlef``,
``psn_iters``).  Bit for bit is for the card: PyTorch's CPU ``exp``,
``log`` and ``pow`` round differently from the host's C library.  In
float32 that last-bit difference moves a few columns' iteration counts, so
the float32 cases require equal counts on at least 98 % of the vegetated
columns and, on those, every output within 5e-3 of the largest magnitude of
its field (measured: 1.4e-3 at most).  Skips where no ``g++`` is installed.
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
from elmkernels_torch.ops import canopy, testing
from elmkernels_torch.physics import canopy_fluxes as tcf
from elmkernels_torch.physics import photosynthesis as tpsn
from test_torch_physics import EXACT, NCOL, _date, _port_arguments, \
    _port_value

torch.set_num_threads(1)

SOURCE = (pathlib.Path(__file__).resolve().parent.parent / "elmkernels_torch"
          / "csrc" / "canopy_stability.cu")
MODES = {"c3": 0, "c4": 1, "mixed": 2}
N, N32 = 2000, 4000

# K2's machine (column_begin, pass_head, leaf_step, pass_tail) on doubles
# and on floats: one column at a time, each to its end, in lane 0 of a
# warp's slots; and on a simulated 32-lane warp whose lanes take the
# columns of `order` as theirs stop and advance by one phase (a pass's
# head, one ci evaluation, its tail) or wait, by a seeded coin, at each
# tick.  And the kernel's layout sizes, for holding them against the
# wrapper's.
HARNESS = r"""
#include "SOURCE"
template <typename T, int M>
static void in_order(const Args<T>& A) {
  static Lanes<T> L;
  const Lane<T> S{L, 0};
  for (long long i = 0; i < A.n; ++i) {
    const Column<T> C{A, i};
    if (!column_begin<T, M>(C, S)) continue;
    do {
      Solve<T> sv;
      pass_head<T, M>(C, S, sv);
      while (sv.leaf < 2) leaf_step<T, M>(C, S, sv);
    } while (!pass_tail<T, M>(C, S));
  }
}
template <typename T, int M>
static void warp(const Args<T>& A, const long long* order, unsigned seed) {
  static Lanes<T> L;
  Solve<T> sv[kLanes];
  long long col[kLanes];
  int phase[kLanes] = {};  // 0 no column, 1 head next, 2 evaluating, 3 tail
  long long next = 0;
  unsigned r = seed | 1u;
  for (;;) {
    bool any = false;
    for (int l = 0; l < kLanes; ++l) {
      const Lane<T> S{L, l};
      while (phase[l] == 0 && next < A.n) {
        col[l] = order[next++];
        if (column_begin<T, M>(Column<T>{A, col[l]}, S)) phase[l] = 1;
      }
      if (phase[l] == 0) continue;
      any = true;
      r ^= r << 13;
      r ^= r >> 17;
      r ^= r << 5;
      if (r & 1u) continue;
      const Column<T> C{A, col[l]};
      if (phase[l] == 1) {
        pass_head<T, M>(C, S, sv[l]);
        phase[l] = sv[l].leaf < 2 ? 2 : 3;
      } else if (phase[l] == 2) {
        leaf_step<T, M>(C, S, sv[l]);
        if (sv[l].leaf == 2) phase[l] = 3;
      } else {
        phase[l] = pass_tail<T, M>(C, S) ? 0 : 1;
      }
    }
    if (!any) break;
  }
}
#define PARAMS                                                              \
  long long n, const void* const* in, const long long* in_stride,          \
      const void* const* traits, const long long* trait_stride,            \
      const void *t_soisno, int nlevtot, int nlevsno, const void *snl,     \
      const void *soybean, long long soybean_stride, const void *ci_prev,  \
      int warm_start, double dtime, const double *consts,                  \
      void *const *out, void *itlef, void *ci, void *psn_iters
#define ARGS(T)                                                             \
  make_args<T>(n, in, in_stride, traits, trait_stride, t_soisno, nlevtot,  \
               nlevsno, snl, soybean, soybean_stride, ci_prev, warm_start, \
               dtime, consts, out, itlef, ci, psn_iters)
#define ENTRY(NAME, T)                                                      \
  extern "C" void NAME(int mode, PARAMS) {                                 \
    const Args<T> A = ARGS(T);                                             \
    if (mode == kC3) in_order<T, kC3>(A);                                  \
    if (mode == kC4) in_order<T, kC4>(A);                                  \
    if (mode == kMixed) in_order<T, kMixed>(A);                            \
  }                                                                        \
  extern "C" void NAME##_warp(int mode, const long long* order,            \
                              unsigned seed, PARAMS) {                     \
    const Args<T> A = ARGS(T);                                             \
    if (mode == kC3) warp<T, kC3>(A, order, seed);                         \
    if (mode == kC4) warp<T, kC4>(A, order, seed);                         \
    if (mode == kMixed) warp<T, kMixed>(A, order, seed);                   \
  }
ENTRY(canopy_host_f64, double)
ENTRY(canopy_host_f32, float)
extern "C" void layout(int* out) {
  out[0] = kIn;
  out[1] = kTraits;
  out[2] = kOut;
  out[3] = kConsts;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("canopy_kernel")
    (d / "harness.cpp").write_text(HARNESS.replace("SOURCE", str(SOURCE)))
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(d / "libharness.so"),
                    str(d / "harness.cpp")], check=True, timeout=300)
    lib = ctypes.CDLL(str(d / "libharness.so"))
    # the launch functions' parameters without the counters and the stream
    params = canopy.ARGTYPES[:-2]
    for name in ("canopy_host_f64", "canopy_host_f32"):
        getattr(lib, name).argtypes = params
        getattr(lib, name + "_warp").argtypes = [
            params[0], ctypes.c_void_p, ctypes.c_uint, *params[1:]]
        getattr(lib, name).restype = getattr(lib, name + "_warp").restype = \
            None
    lib.layout.restype = None
    return lib


def _host(lib, args: dict, order=None, seed=0) -> tcf.StabilityOut:
    """K2's host build on ``stability_iteration``'s arguments: one column
    at a time, or, given ``order`` (a permutation of the columns), on the
    simulated warp."""
    k = canopy.kernel_inputs(args)
    outs = k.outputs()
    name = ("canopy_host_f64" if k.dtype == torch.float64
            else "canopy_host_f32")
    if order is None:
        getattr(lib, name)(MODES[k.mode], *k.pointers(*outs))
    else:
        order = torch.as_tensor(order, dtype=torch.int64).contiguous()
        getattr(lib, name + "_warp")(MODES[k.mode], order.data_ptr(), seed,
                                     *k.pointers(*outs))
    return k.result(*outs)


def _assert_counts_equal(got, want):
    assert torch.equal(got.itlef, want.itlef)
    assert got.itlef.dtype == want.itlef.dtype
    assert torch.equal(got.psn_iters, want.psn_iters)


def test_layout_matches_the_wrapper(host_lib):
    """The kernel's sizes are the wrapper's, and the wrapper hands the
    inputs over without copies: a 0-d trait as itself with a stride of 0,
    layer 0 of a canopy-layer input as a view with the row's stride (read
    as the same values as a one-layer copy), a [ncol] input as itself."""
    out = (ctypes.c_int * 4)()
    host_lib.layout(out)
    assert list(out) == [len(canopy.IN_FIELDS),
                         len(tpsn.PFTPsnParams._fields),
                         len(canopy.OUT_FIELDS), len(canopy.CONSTS)]
    assert set(canopy.OUT_FIELDS) | {"itlef", "ci", "psn_iters"} == set(
        tcf.StabilityOut._fields)
    args = _problem("c3", torch.float64, True, n=64)
    # three canopy layers, of which the loop reads the first
    for name in canopy._LAYERED:
        v = args[name]
        args[name] = torch.cat([v, v * 0.5, v * 0.25], 1)
    k = canopy.kernel_inputs(args)
    nin = len(canopy.IN_FIELDS)
    assert len(k.strides) == nin + len(k.traits)
    for t, v, stride in zip(k.traits, args["p"], k.strides[nin:]):
        assert v.ndim == 0 and t.data_ptr() == v.data_ptr() and stride == 0
    for name, t, stride in zip(canopy.IN_FIELDS, k.fields, k.strides):
        if name == "fveg":
            continue
        v = args[name]
        assert t.data_ptr() == v.data_ptr(), name
        assert stride == v.stride(0), name
        if name in canopy._LAYERED:
            assert v.shape[1] == 3 and stride == 3, name
    assert k.soybean.data_ptr() == args["soybean"].data_ptr()
    assert k.ci_prev.data_ptr() == args["ci_prev"].data_ptr()
    one_layer = {name: args[name][:, :1].contiguous()
                 for name in canopy._LAYERED}
    _assert_same(_host(host_lib, args),
                 _host(host_lib, dict(args, **one_layer)))


@pytest.fixture(scope="module")
def jax_calls(tmp_path_factory):
    """The JAX package's ``stability_iteration`` calls of a winter step
    with snow layers and a summer noon step (4 columns, the exact flags):
    [(phase, args, kwargs, result)] as numpy."""
    import jax
    from elmkernels_tpu.physics import canopy_fluxes as jcf
    from test_torch_physics import _to_numpy
    from elmkernels_tpu.utils.dates import Date as JDate
    files = tp.write_files(tmp_path_factory.mktemp("canopy_kernel_jax"))
    calls, orig = [], jcf.stability_iteration

    def recording(phase):
        def wrapped(*args, **kwargs):
            out = orig(*args, **kwargs)
            calls.append((phase, _to_numpy(args), _to_numpy(kwargs),
                          _to_numpy(out)))
            return out
        return wrapped

    winter = tp.jax_model(files, NCOL, **EXACT)
    winter.run(JDate.from_ymd(1985, 1, 1), 700)
    assert int(np.asarray(winter.state.snl).max()) > 0
    summer = tp.jax_model(files, NCOL, **EXACT)
    summer.run(JDate.from_ymd(1985, 7, 1), 24)
    try:
        for phase, model, date in (("winter", winter, _date(1, 700)),
                                   ("summer", summer, _date(7, 24))):
            jcf.stability_iteration = recording(phase)
            with jax.disable_jit():
                model.advance(date)
    finally:
        jcf.stability_iteration = orig
    assert [c[0] for c in calls] == ["winter", "summer"]
    return calls


def test_host_build_matches_jax_on_the_recorded_step(host_lib, jax_calls):
    """The JAX step's own ``stability_iteration`` calls through K2's host
    build: equal to JAX's results and to the port's plain loop at the
    golden tolerance, with equal iteration counts and ci carry."""
    from elmkernels_tpu.physics import canopy_fluxes as jcf
    for phase, args, kwargs, want in jax_calls:
        a, kw = _port_arguments(jcf.stability_iteration,
                                tcf.stability_iteration, args, kwargs, phase)
        bound = dict(inspect.signature(tcf.stability_iteration).bind(
            *_port_value(a, False), **_port_value(kw, False)).arguments)
        got = _host(host_lib, bound)
        tp.assert_close(want, got, path=f"{phase} host K2 vs JAX")
        plain = tcf.stability_iteration_plain(**bound)
        tp.assert_close(tp.nt_numpy(plain), tp.nt_numpy(got),
                        path=f"{phase} host K2 vs plain")
        _assert_counts_equal(got, plain)
        np.testing.assert_array_equal(np.asarray(want.itlef),
                                      got.itlef.numpy())
    summer = jax_calls[1][3]
    assert int(np.asarray(summer.itlef).max()) > 2  # the loop ran


def _problem(mode, dtype, warm, seed=5, n=N):
    return testing.canopy_problem(n, seed, mode, dtype, warm)


@functools.lru_cache(maxsize=None)
def _plain(mode, dtype, warm, n):
    """A seeded problem and the plain loop's result on it (shared by the
    tests; neither is modified)."""
    args = _problem(mode, dtype, warm, n=n)
    return args, tcf.stability_iteration_plain(**args)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_host_build_matches_plain_f64(host_lib, mode, warm):
    args, want = _plain(mode, torch.float64, warm, N)
    got = _host(host_lib, args)
    _assert_counts_equal(got, want)
    tp.assert_close(tp.nt_numpy(want), tp.nt_numpy(got),
                    path=f"{mode} host K2 vs plain")
    # what the problem promises: bare columns, the cap, night leaves,
    # secant searches that overflow, leaves that converge
    veg = args["frac_veg_nosno"] != 0
    assert bool((got.itlef[~veg] == 0).all()) and bool((~veg).any())
    assert bool((got.itlef == 41).any())
    assert bool((got.itlef[veg] < 41).any())
    night = args["parsun_z"][:, 0] <= 0.0
    assert bool((got.psn_iters[:N][night] == 0).all())
    assert int(got.psn_iters.max()) > 40
    assert bool((args["soybean"] & veg).any())


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_host_build_matches_plain_f32(host_lib, mode, warm):
    args, want = _plain(mode, torch.float32, warm, N32)
    _assert_f32_close(_host(host_lib, args), want, args)


def _assert_f32_close(got, want, args):
    """The module docstring's float32 tolerance: equal counts on at least
    98 % of the vegetated columns and on every bare one; on those columns
    every output and the ci carry within 5e-3 of the largest magnitude of
    its field, NaNs in the same places."""
    n = args["t_grnd"].shape[0]
    veg = args["frac_veg_nosno"] != 0
    same = ((got.itlef == want.itlef) & (got.psn_iters[:n] ==
                                         want.psn_iters[:n])
            & (got.psn_iters[n:] == want.psn_iters[n:]))
    assert int((same & veg).sum()) >= 0.98 * int(veg.sum())
    assert bool(same[~veg].all())
    for f in canopy.OUT_FIELDS:
        a, b = getattr(got, f)[same], getattr(want, f)[same]
        assert a.dtype == b.dtype == torch.float32, f
        assert torch.equal(torch.isnan(a), torch.isnan(b)), f
        fin = torch.isfinite(b)
        err = float((a[fin] - b[fin]).abs().max())
        assert err <= 5e-3 * float(b[fin].abs().max()), (f, err)
    ci_same = torch.cat([same, same])
    a, b = got.ci[ci_same], want.ci[ci_same]
    fin = torch.isfinite(b)
    assert float((a[fin] - b[fin]).abs().max()) <= 5e-3 * float(
        b[fin].abs().max())


def _assert_same(got, want):
    """Bit for bit: every field, NaNs in the same places."""
    for f in got._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.is_floating_point():
            assert torch.equal(torch.isnan(a), torch.isnan(b)), f
            a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        assert torch.equal(a, b), f


def _assert_plain(got, want, args):
    """Against the plain loop: rtol 1e-10 with equal counts in float64,
    the float32 tolerance in float32."""
    if got.t_veg.dtype == torch.float64:
        _assert_counts_equal(got, want)
        tp.assert_close(tp.nt_numpy(want), tp.nt_numpy(got),
                        path="host K2 vs plain")
    else:
        _assert_f32_close(got, want, args)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_refilling_warp_matches_plain(host_lib, mode, dtype, warm):
    """K2's schedule on the host: 32 lanes take the columns in a seeded
    random order as each lane's column stops, and advance in a seeded
    random interleaving (a pass's head, one ci evaluation, its tail);
    every column equals the one-column-at-a-time run bit for bit, and the
    plain loop at the stated tolerance.  The problem mixes columns at the
    41-pass cap with columns done in 4 passes (the fewest: the latent heat
    test starts at the third pass), bare and soybean ones."""
    n = N if dtype == torch.float64 else N32
    args, want = _plain(mode, dtype, warm, n)
    order = np.random.default_rng(37).permutation(n)
    got = _host(host_lib, args, order, seed=41)
    _assert_same(got, _host(host_lib, args))
    _assert_plain(got, want, args)
    veg = args["frac_veg_nosno"] != 0
    assert bool((got.itlef == 41).any())
    assert bool((got.itlef[veg] == 4).any())
    assert bool((~veg).any()) and bool((args["soybean"] & veg).any())


def _take(args, idx):
    """``stability_iteration``'s arguments for the columns ``idx`` of a
    problem: each [ncol] (or [ncol, k]) tensor and per-column trait
    indexed, the ci carry's two halves indexed."""
    n = args["t_grnd"].shape[0]
    idx = torch.as_tensor(idx, dtype=torch.int64)

    def take(v):
        if isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == n:
            return v[idx]
        return v
    out = {k: take(v) for k, v in args.items()}
    out["p"] = type(args["p"])(*(take(t) for t in args["p"]))
    if args.get("ci_prev") is not None:
        ci = args["ci_prev"]
        out["ci_prev"] = torch.cat([ci[:n][idx], ci[n:][idx]])
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("n", [0, 1, 31, 33])
def test_refilling_warp_edges(host_lib, n, mode, dtype):
    """Batches of fewer than a warp's 32 columns, or not a multiple of
    32, cold and warm started: the first columns a capped one, one done in
    4 passes, a bare one and a soybean one, then the problem's next.  The
    simulated warp equals the one-column-at-a-time run bit for bit, and
    both equal the same columns of the whole problem's run (the columns
    are independent); in float64 they equal the plain loop on the batch
    at rtol 1e-10 with equal counts."""
    nfull = N if dtype == torch.float64 else N32
    for warm in (False, True):
        args, _ = _plain(mode, dtype, warm, nfull)
        full = _host(host_lib, args)
        veg = args["frac_veg_nosno"] != 0
        kinds = (full.itlef == 41, veg & (full.itlef == 4), ~veg,
                 args["soybean"] & veg)
        first = [int(torch.nonzero(k)[0]) for k in kinds]
        idx = (first + [i for i in range(nfull) if i not in first])[:n]
        sub = _take(args, idx)
        got = _host(host_lib, sub, np.random.default_rng(n).permutation(n),
                    seed=43 + n)
        alone = _host(host_lib, sub)
        _assert_same(got, alone)
        assert got.itlef.shape == (n,) and got.ci.shape == (2 * n,)
        _assert_same(got, _take_out(full, idx))
        if dtype == torch.float64 and n:
            _assert_counts_equal(got, tcf.stability_iteration_plain(**sub))
            tp.assert_close(tp.nt_numpy(tcf.stability_iteration_plain(
                **sub)), tp.nt_numpy(got), path=f"n={n} host K2 vs plain")


def _take_out(out, idx):
    """The columns ``idx`` of a ``StabilityOut``."""
    n = out.t_veg.shape[0]
    idx = torch.as_tensor(idx, dtype=torch.int64)
    vals = {f: getattr(out, f)[idx] for f in out._fields
            if f not in ("ci", "psn_iters")}
    return type(out)(**vals, ci=torch.cat([out.ci[:n][idx],
                                           out.ci[n:][idx]]),
                     psn_iters=torch.cat([out.psn_iters[:n][idx],
                                          out.psn_iters[n:][idx]]))


def test_routing(monkeypatch):
    """``stability_iteration`` routes by rule: CUDA tensors that carry no
    tangent to K2, CPU tensors and differentiated calls (``torch.func.jvp``)
    to the plain loop.  The device test is stubbed so that CPU tensors
    count as the card's; K2 is replaced by a spy."""
    args = _problem("c3", torch.float64, False, n=16)
    assert not tcf.uses_kernel(args)     # CPU tensors: the plain loop
    monkeypatch.setattr(tcf, "_on_card", lambda t: True)
    calls = []

    def spy(**kw):
        calls.append(kw)
        return tcf.stability_iteration_plain(**kw)
    monkeypatch.setattr(canopy, "canopy_stability", spy)
    out = tcf.stability_iteration(**args)
    assert len(calls) == 1
    assert torch.equal(out.t_veg,
                       tcf.stability_iteration_plain(**args).t_veg)

    def run(t_veg):
        return tcf.stability_iteration(**dict(args, t_veg=t_veg)).t_veg
    t_veg, dt_veg = torch.func.jvp(run, (args["t_veg"],),
                                   (torch.ones_like(args["t_veg"]),))
    assert len(calls) == 1               # the tangent went to the plain loop
    assert torch.equal(t_veg, out.t_veg)
    assert bool(torch.isfinite(dt_veg).all())
    assert bool((dt_veg != 0).any())
    # a differentiated trait routes the same way
    p = args["p"]._replace(dleaf=args["p"].dleaf.clone().requires_grad_())
    assert not tcf.uses_kernel(dict(args, p=p))
    assert tcf.uses_kernel(args)


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        canopy.canopy_stability(**_problem("c3", torch.float64, False,
                                           n=4))
