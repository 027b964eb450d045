"""The ci solve kernels' arithmetic on the CPU: ``csrc/ci_hybrid_solve.cu``
compiled as plain C++ by the host compiler (its device code is inline
functions; the kernels and launches sit under ``__CUDACC__``), against the
plain PyTorch versions, bit for bit with equal iteration counts: K1 in
float64 (each leaf by the same ``solve_leaf`` template as on the card) and
K1-T, the solve on value/tangent pairs run by the same resumable per-leaf
machine (``leaf_begin``/``leaf_eval``) as on the card, against
``torch.func.jvp`` of ``hybrid_solve_plain``: one leaf at a time, and on
a simulated 32-lane warp whose lanes take leaves in a seeded random order
as they free up and evaluate in a seeded random interleaving, as the
card's lanes refill.  The machine's evaluations by kind equal the plain
solve's committed ones (``testing.ci_eval_counts``).

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
// K1-T's per-leaf machine driven one leaf at a time (lane 0 of a warp's
// arrays), counting each leaf's evaluations by kind
static int kind_of(int state) {
  return state <= kStart1 ? 0 : state == kSecant ? 1 : state == kOver ? 2
                                                                      : 3;
}
using D = Dual<double>;
struct Lanes {
  D env[kEnv][kLanes];
  D rates[5][kLanes];
};
static void finish(long long i, D ci, D gs, const Lanes& L, int lane,
                   bool zero_rates, int it, double** out, double** out_t,
                   int* iters) {
  D r[7] = {ci, gs};
  for (int k = 0; k < 5; ++k) r[2 + k] = zero_rates ? D(0.0) : L.rates[k][lane];
  for (int k = 0; k < 7; ++k) {
    out[k][i] = r[k].v;
    out_t[k][i] = r[k].d;
  }
  iters[i] = it;
}
// lane `lane` takes leaf i: its env into the lane's column, the machine
// started; false (and the leaf's results written) if it needs no
// evaluation
static bool take(Lanes& L, int lane, Leaf<D>& st, long long i,
                 const double* const* env, const double* const* env_t,
                 const double* x0, const double* x0_t,
                 const unsigned char* en, double** out, double** out_t,
                 int* iters) {
  for (int k = 0; k < kEnv; ++k) L.env[k][lane] = D(env[k][i], env_t[k][i]);
  D xfin;
  if (leaf_begin(st, D(x0[i], x0_t[i]), en[i] != 0, xfin)) return true;
  finish(i, xfin, D(0.0), L, lane, true, 0, out, out_t, iters);
  return false;
}
// one evaluation of lane `lane`'s leaf i; false (and its results
// written) when the leaf is done
template <int M>
static bool step(Lanes& L, int lane, Leaf<D>& st, long long i, int* kinds,
                 long long n, double** out, double** out_t, int* iters) {
  ++kinds[kind_of(st.state) * n + i];
  D xfin;
  if (leaf_eval<D, M>(st, env_ref<D>(L.env, lane), L.rates, lane, xfin))
    return true;
  finish(i, xfin, st.gs, L, lane, false, st.it, out, out_t, iters);
  return false;
}
template <int M>
static void dual(long long n, const double* const* env,
                 const double* const* env_t, const double* x0,
                 const double* x0_t, const unsigned char* en, double** out,
                 double** out_t, int* iters, int* kinds) {
  static Lanes L;
  for (long long i = 0; i < n; ++i) {
    Leaf<D> st;
    if (!take(L, 0, st, i, env, env_t, x0, x0_t, en, out, out_t, iters))
      continue;
    while (step<M>(L, 0, st, i, kinds, n, out, out_t, iters)) {
    }
  }
}
// the same machine on a simulated 32-lane warp: a lane without a leaf
// takes the next one of `order`; at each tick every lane that holds a
// leaf evaluates or waits, by a seeded coin
template <int M>
static void warp(long long n, const double* const* env,
                 const double* const* env_t, const double* x0,
                 const double* x0_t, const unsigned char* en, double** out,
                 double** out_t, int* iters, int* kinds,
                 const long long* order, unsigned seed) {
  static Lanes L;
  Leaf<D> st[kLanes];
  long long leaf[kLanes];
  bool has[kLanes] = {};
  long long next = 0;
  unsigned r = seed | 1u;
  for (;;) {
    bool any = false;
    for (int l = 0; l < kLanes; ++l) {
      while (!has[l] && next < n) {
        leaf[l] = order[next++];
        has[l] = take(L, l, st[l], leaf[l], env, env_t, x0, x0_t, en, out,
                      out_t, iters);
      }
      if (!has[l]) continue;
      any = true;
      r ^= r << 13;
      r ^= r >> 17;
      r ^= r << 5;
      if (r & 1u) continue;
      has[l] = step<M>(L, l, st[l], leaf[l], kinds, n, out, out_t, iters);
    }
    if (!any) break;
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
                           double** out, double** out_t, int* iters,
                           int* kinds) {
  if (mode == 0) dual<0>(n, env, env_t, x0, x0_t, en, out, out_t, iters, kinds);
  if (mode == 1) dual<1>(n, env, env_t, x0, x0_t, en, out, out_t, iters, kinds);
  if (mode == 2) dual<2>(n, env, env_t, x0, x0_t, en, out, out_t, iters, kinds);
}
extern "C" void solve_warp(int mode, long long n, const double* const* env,
                           const double* const* env_t, const double* x0,
                           const double* x0_t, const unsigned char* en,
                           double** out, double** out_t, int* iters,
                           int* kinds, const long long* order, unsigned seed) {
  if (mode == 0)
    warp<0>(n, env, env_t, x0, x0_t, en, out, out_t, iters, kinds, order, seed);
  if (mode == 1)
    warp<1>(n, env, env_t, x0, x0_t, en, out, out_t, iters, kinds, order, seed);
  if (mode == 2)
    warp<2>(n, env, env_t, x0, x0_t, en, out, out_t, iters, kinds, order, seed);
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
    lib.solve_warp.restype = None
    return lib


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _inputs(mode, dry_share=0.25):
    x0, env, en = testing.ci_problem_tensors(N, 29, mode, torch.float64,
                                             "cpu", dry_share=dry_share)
    dx0, denv = testing.ci_tangents(x0, env, 31)
    return (x0, dx0, [v.contiguous() for v in env],
            [v.contiguous() for v in denv], en)


def _empty(k):
    return [torch.empty(N, dtype=torch.float64) for _ in range(k)]


def _dual_call(fn, mode, x0, dx0, env, denv, en, *extra):
    """K1-T's machine by ``fn`` (solve_dual or solve_warp): values,
    tangents, iterations and evaluations by kind ([4, N])."""
    P = ctypes.c_void_p
    kt, kt_d, kt_it = _empty(7), _empty(7), torch.empty(N, dtype=torch.int32)
    kinds = torch.zeros(4, N, dtype=torch.int32)
    fn(MODES[mode], ctypes.c_longlong(N), _ptrs(env), _ptrs(denv),
       P(x0.data_ptr()), P(dx0.data_ptr()), P(en.data_ptr()), _ptrs(kt),
       _ptrs(kt_d), P(kt_it.data_ptr()), P(kinds.data_ptr()), *extra)
    return kt, kt_d, kt_it, kinds


def _assert_jvp(mode, x0, dx0, env, denv, en, kt, kt_d, kt_it, kinds):
    ci, out, it, dci, dout = tpsn.hybrid_solve_jvp_plain(
        x0, dx0, tpsn.CiEnv(*env), tpsn.CiEnv(*denv), mode, en)
    assert torch.equal(kt_it, it)
    for a, b in zip((*kt, *kt_d), (ci, *out, dci, *dout)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    counts = testing.ci_eval_counts(x0, tpsn.CiEnv(*env), mode, en)
    for k, kind in enumerate(testing.EVAL_KINDS):
        assert torch.equal(kinds[k], counts[kind]), kind
    return it


@pytest.mark.parametrize("mode", sorted(MODES))
def test_host_build_matches_plain(host_lib, mode, monkeypatch):
    monkeypatch.setattr(torch, "sqrt", _Sqrt.apply)
    x0, dx0, env, denv, en = _inputs(mode)
    P = ctypes.c_void_p
    k1, k1_it = _empty(7), torch.empty(N, dtype=torch.int32)
    host_lib.solve_plain(MODES[mode], ctypes.c_longlong(N), _ptrs(env),
                         P(x0.data_ptr()), P(en.data_ptr()), _ptrs(k1),
                         P(k1_it.data_ptr()))
    ci, out, it = tpsn.hybrid_solve_plain(x0, tpsn.CiEnv(*env), mode, en)
    assert torch.equal(k1_it, it)
    for a, b in zip(k1, (ci, *out)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    it = _assert_jvp(mode, x0, dx0, env, denv, en,
                     *_dual_call(host_lib.solve_dual, mode, x0, dx0, env,
                                 denv, en))
    assert int(it.max()) > 10    # secant searches that ran long


@pytest.mark.parametrize("dry_share", [0.25, 1.0])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_host_build_refilling_warp_matches_plain(host_lib, mode, dry_share,
                                                 monkeypatch):
    """K1-T's schedule on the host: 32 lanes take the leaves in a seeded
    random order as each lane's leaf ends, and step in a seeded random
    interleaving; every leaf's values, tangents, count and evaluations
    equal the plain jvp's."""
    monkeypatch.setattr(torch, "sqrt", _Sqrt.apply)
    x0, dx0, env, denv, en = _inputs(mode, dry_share)
    order = torch.from_numpy(
        np.random.default_rng(37).permutation(N).astype(np.int64))
    res = _dual_call(host_lib.solve_warp, mode, x0, dx0, env, denv, en,
                     ctypes.c_void_p(order.data_ptr()), ctypes.c_uint(41))
    it = _assert_jvp(mode, x0, dx0, env, denv, en, *res)
    kinds = res[3]
    assert int(it.max()) > 10 and int(kinds[3].sum()) > 0
