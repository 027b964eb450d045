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

and the routing of ``physics.canopy_fluxes.stability_iteration``.

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
N = 2000

# every column through canopy_column, on doubles and on floats; and the
# kernel's layout sizes, for holding them against the wrapper's
HARNESS = r"""
#include "SOURCE"
template <typename T>
static void run(int mode, long long n, const void* const* in,
                const void* const* traits, const void* t_soisno, int nlevtot,
                int nlevsno, const void* snl, const void* soybean,
                const void* ci_prev, int warm_start, double dtime,
                const double* consts, void* const* out, void* itlef,
                void* ci, void* psn_iters) {
  const Args<T> A = make_args<T>(n, in, traits, t_soisno, nlevtot, nlevsno,
                                 snl, soybean, ci_prev, warm_start, dtime,
                                 consts, out, itlef, ci, psn_iters);
  for (long long i = 0; i < n; ++i) {
    if (mode == kC3) canopy_column<T, kC3>(A, i);
    if (mode == kC4) canopy_column<T, kC4>(A, i);
    if (mode == kMixed) canopy_column<T, kMixed>(A, i);
  }
}
#define ENTRY(NAME, T)                                                      \
  extern "C" void NAME(int mode, long long n, const void* const* in,       \
                       const void* const* traits, const void* t_soisno,    \
                       int nlevtot, int nlevsno, const void* snl,          \
                       const void* soybean, const void* ci_prev,           \
                       int warm_start, double dtime, const double* consts, \
                       void* const* out, void* itlef, void* ci,            \
                       void* psn_iters) {                                  \
    run<T>(mode, n, in, traits, t_soisno, nlevtot, nlevsno, snl, soybean,  \
           ci_prev, warm_start, dtime, consts, out, itlef, ci, psn_iters); \
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
    lib.canopy_host_f64.restype = lib.canopy_host_f32.restype = None
    lib.layout.restype = None
    return lib


def _host(lib, args: dict) -> tcf.StabilityOut:
    """K2's host build on ``stability_iteration``'s arguments."""
    k = canopy.kernel_inputs(args)
    outs = k.outputs()
    fn = (lib.canopy_host_f64 if k.dtype == torch.float64
          else lib.canopy_host_f32)
    fn(ctypes.c_int(MODES[k.mode]), *k.pointers(*outs))
    return k.result(*outs)


def _assert_counts_equal(got, want):
    assert torch.equal(got.itlef, want.itlef)
    assert got.itlef.dtype == want.itlef.dtype
    assert torch.equal(got.psn_iters, want.psn_iters)


def test_layout_matches_the_wrapper(host_lib):
    out = (ctypes.c_int * 4)()
    host_lib.layout(out)
    assert list(out) == [len(canopy.IN_FIELDS),
                         len(tpsn.PFTPsnParams._fields),
                         len(canopy.OUT_FIELDS), len(canopy.CONSTS)]
    assert set(canopy.OUT_FIELDS) | {"itlef", "ci", "psn_iters"} == set(
        tcf.StabilityOut._fields)


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


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_host_build_matches_plain_f64(host_lib, mode, warm):
    args = _problem(mode, torch.float64, warm)
    got = _host(host_lib, args)
    want = tcf.stability_iteration_plain(**args)
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
    args = _problem(mode, torch.float32, warm, n=4000)
    got = _host(host_lib, args)
    want = tcf.stability_iteration_plain(**args)
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
