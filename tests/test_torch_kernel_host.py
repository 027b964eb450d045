"""The ci solve kernels' arithmetic on the CPU: ``csrc/ci_hybrid_solve.cu``
compiled as plain C++ by the host compiler (its device code is inline
functions; the kernels and launches sit under ``__CUDACC__``), each leaf
solved by the same ``solve_leaf`` template as on the card, against the
plain PyTorch versions, bit for bit with equal iteration counts: K1 in
float64 and K1-T (the solve on value/tangent pairs) against
``torch.func.jvp`` of ``hybrid_solve_plain``.

PyTorch's float64 ``sqrt`` on the CPU is not correctly rounded (the card's
and the host compiler's are), so the plain side here takes numpy's
``sqrt``.  Skips where no ``g++`` is installed.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from elmkernels_torch.ops import testing
from elmkernels_torch.physics import photosynthesis as tpsn

torch.set_num_threads(1)

SOURCE = (pathlib.Path(__file__).resolve().parent.parent / "elmkernels_torch"
          / "csrc" / "ci_hybrid_solve.cu")
N = 4000
MODES = {"c3": 0, "c4": 1, "mixed": 2}

# one leaf at a time through solve_leaf: on doubles (K1) and on duals (K1-T)
HARNESS = r"""
#include "SOURCE"
template <int M>
static void plain(long long n, const double* const* env, const double* x0,
                  const unsigned char* en, double** out, int* iters) {
  for (long long i = 0; i < n; ++i) {
    double f[kEnv];
    for (int k = 0; k < kEnv; ++k) f[k] = env[k][i];
    const Env<double> e = {f[0], f[1], f[2], f[3], f[4], f[5], f[6],
                           f[7], f[8], f[9], f[10], f[11], f[12], f[13],
                           f[14], f[15], f[16], f[17], f[18]};
    Out<double> o;
    int it;
    const double x = solve_leaf<double, M>(e, x0[i], en[i] != 0, o, it);
    const double r[7] = {x, o.gs, o.ac, o.aj, o.ap, o.ag, o.an};
    for (int k = 0; k < 7; ++k) out[k][i] = r[k];
    iters[i] = it;
  }
}
template <int M>
static void dual(long long n, const double* const* env,
                 const double* const* env_t, const double* x0,
                 const double* x0_t, const unsigned char* en, double** out,
                 double** out_t, int* iters) {
  using D = Dual<double>;
  for (long long i = 0; i < n; ++i) {
    D f[kEnv];
    for (int k = 0; k < kEnv; ++k) f[k] = D(env[k][i], env_t[k][i]);
    const Env<D> e = {f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7],
                      f[8], f[9], f[10], f[11], f[12], f[13], f[14], f[15],
                      f[16], f[17], f[18]};
    Out<D> o;
    int it;
    const D x = solve_leaf<D, M>(e, D(x0[i], x0_t[i]), en[i] != 0, o, it);
    const D r[7] = {x, o.gs, o.ac, o.aj, o.ap, o.ag, o.an};
    for (int k = 0; k < 7; ++k) {
      out[k][i] = r[k].v;
      out_t[k][i] = r[k].d;
    }
    iters[i] = it;
  }
}
extern "C" void solve_plain(int mode, long long n, const double* const* env,
                            const double* x0, const unsigned char* en,
                            double** out, int* iters) {
  if (mode == 0) plain<0>(n, env, x0, en, out, iters);
  if (mode == 1) plain<1>(n, env, x0, en, out, iters);
  if (mode == 2) plain<2>(n, env, x0, en, out, iters);
}
extern "C" void solve_dual(int mode, long long n, const double* const* env,
                           const double* const* env_t, const double* x0,
                           const double* x0_t, const unsigned char* en,
                           double** out, double** out_t, int* iters) {
  if (mode == 0) dual<0>(n, env, env_t, x0, x0_t, en, out, out_t, iters);
  if (mode == 1) dual<1>(n, env, env_t, x0, x0_t, en, out, out_t, iters);
  if (mode == 2) dual<2>(n, env, env_t, x0, x0_t, en, out, out_t, iters);
}
"""


class _Sqrt(torch.autograd.Function):
    """numpy's correctly rounded sqrt, with torch's forward-mode rule
    (dx / (2 sqrt(x)))."""

    @staticmethod
    def forward(x):
        with np.errstate(invalid="ignore"):
            return torch.from_numpy(np.sqrt(x.detach().numpy()))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(output)

    @staticmethod
    def jvp(ctx, dx):
        r, = ctx.saved_tensors
        return dx / (2 * r)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("host_kernel")
    (d / "harness.cpp").write_text(HARNESS.replace("SOURCE", str(SOURCE)))
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-o", str(d / "libharness.so"),
                    str(d / "harness.cpp")], check=True, timeout=300)
    lib = ctypes.CDLL(str(d / "libharness.so"))
    lib.solve_plain.restype = lib.solve_dual.restype = None
    return lib


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_host_build_matches_plain(host_lib, mode, monkeypatch):
    monkeypatch.setattr(torch, "sqrt", _Sqrt.apply)
    x0, env, en = testing.ci_problem_tensors(N, 29, mode, torch.float64,
                                             "cpu")
    dx0, denv = testing.ci_tangents(x0, env, 31)
    env, denv = [v.contiguous() for v in env], [v.contiguous() for v in denv]
    n = ctypes.c_longlong(N)
    P = ctypes.c_void_p

    def empty(k):
        return [torch.empty(N, dtype=torch.float64) for _ in range(k)]
    k1, k1_it = empty(7), torch.empty(N, dtype=torch.int32)
    host_lib.solve_plain(MODES[mode], n, _ptrs(env), P(x0.data_ptr()),
                         P(en.data_ptr()), _ptrs(k1), P(k1_it.data_ptr()))
    kt, kt_d, kt_it = empty(7), empty(7), torch.empty(N, dtype=torch.int32)
    host_lib.solve_dual(MODES[mode], n, _ptrs(env), _ptrs(denv),
                        P(x0.data_ptr()), P(dx0.data_ptr()), P(en.data_ptr()),
                        _ptrs(kt), _ptrs(kt_d), P(kt_it.data_ptr()))

    ci, out, it, dci, dout = tpsn.hybrid_solve_jvp_plain(
        x0, dx0, tpsn.CiEnv(*env), tpsn.CiEnv(*denv), mode, en)
    assert torch.equal(k1_it, it) and torch.equal(kt_it, it)
    for got in (k1, kt):
        for a, b in zip(got, (ci, *out)):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    for a, b in zip(kt_d, (dci, *dout)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert int(it.max()) > 10    # secant searches that ran long
