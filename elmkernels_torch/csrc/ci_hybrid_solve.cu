// Per-leaf intracellular CO2 (ci) root solve: secant iteration, then Brent
// on leaves whose secant steps bracket a root; and its forward-mode
// (tangent-linear) version.
//
// Replaces: elmkernels_tpu/physics/photosynthesis.py:hybrid_solve (lines
// 238-413, with ci_func at 163), the masked-batch port of the reference's
// hybrid/brent (photosynthesis_impl.hh:395-620).  The JAX package once had
// this as the Pallas kernel ops/ci_solver.py:ci_hybrid_solve (f32 only,
// removed in commit 8dfd5dd because Mosaic has no f64).  The tangent
// version replaces jax.jvp through hybrid_solve's two masked while_loops
// (elmkernels_tpu/driver/sensitivity.py:77-91).
//
// One thread per leaf runs the sequence that leaf follows in the masked
// batch loop, to its own end: the evaluations at x0 and 0.99*x0, secant
// steps (at most 40, eps 1e-2, eps1 1e-4) in the conv/close/bracket/
// overflow order, the final evaluation at the minimum-|f| point on
// overflow, then at most 20 Brent steps starting at btol = tol.  On
// an < 0 the residual is 0 and gs_mol keeps its previous value.  Compiled
// for float and double; build with --fmad=false so the arithmetic is the
// plain version's, operation by operation (a re-fused ci solve drifted
// ~1e-4 after 40 secant iterations in the JAX package's history).
//
// The tangent version instantiates the same solve on Dual<double>, a
// (value, tangent) pair: comparisons and branches act on the value, so the
// tangent is carried through every secant and Brent iterate the primal
// takes (what jax.jvp of the while_loops gives, not the implicit-function
// derivative).  Each operation's tangent is written as PyTorch's
// forward-mode formula computes it (tools/autograd/derivatives.yaml: a/b
// -> (da - db*(a/b))/b, sqrt -> dx/(2*sqrt(x)), maximum -> db + s*(da-db)
// with s = 0.5 on a tie, clamp(x, min) -> x >= min ? dx : 0), and a Python
// number in the plain version is a plain scalar here (a tensor without
// tangent there), so that the kernel equals torch.func.jvp of the plain
// version to the last bit.
//
// Bound: operations.  A leaf reads 21 values and writes 8 (the tangent
// version 41 and 15), and runs up to ~62 residual evaluations of ~70 flops
// each (~3x that with tangents) with divisions and square roots; the
// kernel holds every iterate in registers and never returns to device
// memory between iterations, which is what the eager masked loop (one host
// sync and ~100 small launches per iteration) cannot do.

#include <math.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

namespace {

constexpr int kEnv = 19;
constexpr int kC3 = 0, kC4 = 1, kMixed = 2;

// ---- plain arithmetic ----------------------------------------------------

HD float tsqrt(float x) { return sqrtf(x); }
HD double tsqrt(double x) { return sqrt(x); }
HD float tabs(float x) { return fabsf(x); }
HD double tabs(double x) { return fabs(x); }
HD float val(float x) { return x; }
HD double val(double x) { return x; }

// NaN-propagating max/min (torch.maximum/jnp.maximum semantics)
template <typename T>
HD T nmax(T a, T b) {
  return (a > b || isnan(a)) ? a : b;
}
template <typename T>
HD T nmin(T a, T b) {
  return (a < b || isnan(a)) ? a : b;
}
// torch.clamp(x, min=c), torch.maximum, torch.minimum
HD float clamp_min(float x, float c) { return nmax(x, c); }
HD double clamp_min(double x, double c) { return nmax(x, c); }
HD float maximum(float a, float b) { return nmax(a, b); }
HD double maximum(double a, double b) { return nmax(a, b); }
HD float minimum(float a, float b) { return nmin(a, b); }
HD double minimum(double a, double b) { return nmin(a, b); }

// ---- dual numbers: (value, tangent) --------------------------------------

template <typename R>
struct Dual {
  R v, d;
  HD Dual() : v(0), d(0) {}
  HD Dual(R x) : v(x), d(0) {}  // a constant: no tangent
  HD Dual(R x, R dx) : v(x), d(dx) {}
};

template <typename R>
HD Dual<R> operator-(Dual<R> a) { return {-a.v, -a.d}; }
template <typename R>
HD Dual<R> operator+(Dual<R> a, Dual<R> b) { return {a.v + b.v, a.d + b.d}; }
template <typename R>
HD Dual<R> operator-(Dual<R> a, Dual<R> b) { return {a.v - b.v, a.d - b.d}; }
template <typename R>
HD Dual<R> operator*(Dual<R> a, Dual<R> b) {
  return {a.v * b.v, b.d * a.v + a.d * b.v};
}
template <typename R>
HD Dual<R> operator/(Dual<R> a, Dual<R> b) {
  const R r = a.v / b.v;
  return {r, (a.d - b.d * r) / b.v};
}
// with a plain scalar (a Python number, or a tensor without tangent)
template <typename R>
HD Dual<R> operator+(Dual<R> a, R s) { return {a.v + s, a.d}; }
template <typename R>
HD Dual<R> operator+(R s, Dual<R> a) { return {s + a.v, a.d}; }
template <typename R>
HD Dual<R> operator-(Dual<R> a, R s) { return {a.v - s, a.d}; }
template <typename R>
HD Dual<R> operator-(R s, Dual<R> a) { return {s - a.v, -a.d}; }
template <typename R>
HD Dual<R> operator*(Dual<R> a, R s) { return {a.v * s, a.d * s}; }
template <typename R>
HD Dual<R> operator*(R s, Dual<R> a) { return {s * a.v, a.d * s}; }
template <typename R>
HD Dual<R> operator/(Dual<R> a, R s) { return {a.v / s, a.d / s}; }
template <typename R>
HD Dual<R> operator/(R s, Dual<R> a) {
  const R r = s / a.v;
  return {r, -(a.d * r) / a.v};
}

#define DUAL_CMP(OP)                                                      \
  template <typename R>                                                   \
  HD bool operator OP(Dual<R> a, Dual<R> b) { return a.v OP b.v; }        \
  template <typename R>                                                   \
  HD bool operator OP(Dual<R> a, R s) { return a.v OP s; }                \
  template <typename R>                                                   \
  HD bool operator OP(R s, Dual<R> a) { return s OP a.v; }
DUAL_CMP(<)
DUAL_CMP(>)
DUAL_CMP(<=)
DUAL_CMP(>=)
DUAL_CMP(==)
DUAL_CMP(!=)
#undef DUAL_CMP

template <typename R>
HD R val(Dual<R> a) { return a.v; }
template <typename R>
HD Dual<R> tsqrt(Dual<R> a) {
  const R r = tsqrt(a.v);
  return {r, a.d / (R(2) * r)};
}
template <typename R>
HD Dual<R> tabs(Dual<R> a) {
  const R sg = R((a.v > R(0)) - (a.v < R(0)));  // torch.sgn: 0 at 0, NaN
  return {tabs(a.v), a.d * sg};
}
template <typename R>
HD Dual<R> clamp_min(Dual<R> a, R c) {
  return {nmax(a.v, c), (a.v >= c) ? a.d : R(0)};
}
template <typename R>
HD Dual<R> maximum(Dual<R> a, Dual<R> b) {
  const R s = (a.v == b.v) ? R(0.5) : R(a.v > b.v);
  return {nmax(a.v, b.v), b.d + s * (a.d - b.d)};
}
template <typename R>
HD Dual<R> minimum(Dual<R> a, Dual<R> b) {
  const R s = (a.v == b.v) ? R(0.5) : R(a.v < b.v);
  return {nmin(a.v, b.v), b.d + s * (a.d - b.d)};
}

// the plain scalar type of T: T itself, or a Dual's value type
template <typename T>
struct Real { using type = T; };
template <typename R>
struct Real<Dual<R>> { using type = R; };

// ---- the solve, on T = float, double or Dual<double> ----------------------

template <typename T>
struct Out {
  T gs, ac, aj, ap, ag, an;
};

template <typename T>
struct Env {
  T gb_mol, je, cair, oair, lmr_z, par_z, rh_can, vcmax_z, forc_pbot, cp,
      kc, ko, tpu_z, kp_z, bbb, qe, theta_cj, mbbopt, c3frac;
};

// A is T, or the plain scalar for a constant leading coefficient
template <typename A, typename T>
HD void quadratic_roots(A a, T b, T c, T& r1, T& r2) {
  using S = typename Real<T>::type;
  const T disc = tsqrt(b * b - S(4.0) * a * c);
  const T q = (b >= S(0)) ? S(-0.5) * (b + disc) : S(-0.5) * (b - disc);
  r1 = q / a;
  r2 = (q != S(0)) ? c / q : T(1.0e36);
}

// Residual f(ci) and the rates at ci; `o.gs` enters as the previous gs_mol.
template <typename T, int MODE>
HD T ci_func(T ci, Out<T>& o, const Env<T>& e) {
  using S = typename Real<T>::type;
  T ac, aj, ap;
  T ac3 = T(0), aj3 = T(0), ap3 = T(0), ac4 = T(0), aj4 = T(0), ap4 = T(0);
  if (MODE != kC4) {
    ac3 = e.vcmax_z * clamp_min(ci - e.cp, S(0)) /
          (ci + e.kc * (S(1.0) + e.oair / e.ko));
    aj3 = e.je * clamp_min(ci - e.cp, S(0)) / (S(4.0) * ci + S(8.0) * e.cp);
    ap3 = S(3.0) * e.tpu_z;
  }
  if (MODE != kC3) {
    ac4 = e.vcmax_z;
    aj4 = e.qe * e.par_z * S(4.6);
    ap4 = e.kp_z * clamp_min(ci, S(0)) / e.forc_pbot;
  }
  if (MODE == kC3) {
    ac = ac3; aj = aj3; ap = ap3;
  } else if (MODE == kC4) {
    ac = ac4; aj = aj4; ap = ap4;
  } else {
    const bool isc3 = e.c3frac >= S(0.5);
    ac = isc3 ? ac3 : ac4;
    aj = isc3 ? aj3 : aj4;
    ap = isc3 ? ap3 : ap4;
  }
  T r1, r2;
  quadratic_roots(e.theta_cj, -(ac + aj), ac * aj, r1, r2);
  const T ai = minimum(r1, r2);
  quadratic_roots(S(0.95), -(ai + ap), ai * ap, r1, r2);
  const T ag = minimum(r1, r2);
  const T an = ag - e.lmr_z;

  const bool neg = an < S(0);
  const T cs = clamp_min(e.cair - S(1.4) / e.gb_mol * an * e.forc_pbot,
                         S(1.e-6));
  quadratic_roots(cs, cs * (e.gb_mol - e.bbb) - e.mbbopt * an * e.forc_pbot,
                  -e.gb_mol * (cs * e.bbb +
                               e.mbbopt * an * e.forc_pbot * e.rh_can),
                  r1, r2);
  const T gs_new = maximum(r1, r2);
  const T gs = neg ? o.gs : gs_new;
  const T gs_safe = (gs != S(0)) ? gs : T(1.0);
  const T fval = neg ? T(0)
                     : ci - e.cair + an * e.forc_pbot *
                                         (S(1.4) * gs + S(1.6) * e.gb_mol) /
                                         (e.gb_mol * gs_safe);
  o.gs = gs; o.ac = ac; o.aj = aj; o.ap = ap; o.ag = ag; o.an = an;
  return fval;
}

// One leaf's whole solve: returns ci, leaves the rates in `out` and the
// secant iterations in `iters`.
template <typename T, int MODE>
HD T solve_leaf(const Env<T>& e, T xinit, bool en, Out<T>& out, int& iters) {
  using S = typename Real<T>::type;
  const S eps = S(1.0e-2), eps1 = S(1.0e-4);
  const int itmax = 40, itmax_b = 20;
  const S two_eps_b = S(2.0 * 1.0e-2);

  out = {T(0), T(0), T(0), T(0), T(0), T(0)};

  // the two starting evaluations
  Out<T> o = out;
  T x0 = xinit;
  T f0 = ci_func<T, MODE>(x0, o, e);
  if (en) out = o;
  bool done = !en || f0 == S(0);
  T xfin = xinit, minx = xinit, minf = f0;
  T x1 = xinit * S(0.99);
  o = out;
  T f1 = ci_func<T, MODE>(x1, o, e);
  if (!done) out = o;
  if (!done && f1 == S(0)) {
    xfin = x1;
    done = true;
  }
  if (!done && f1 < minf) {
    minx = x1;
    minf = f1;
  }

  // secant phase
  int it = 0;
  bool over = false, brent = false;
  T ba = T(0), bb = T(0), bfa = T(0), bfb = T(0), btol = T(0);
  while (!done && !brent) {
    ++it;
    const T den = f1 - f0;
    const T dx = -f1 * (x1 - x0) / (den != S(0) ? den : T(1.0));
    const T x = x1 + dx;
    const T tol = tabs(x) * eps;
    if (tabs(dx) < tol) {
      xfin = x;
      done = true;
      break;
    }
    x0 = x1;
    f0 = f1;
    x1 = x;
    o = out;
    f1 = ci_func<T, MODE>(x1, o, e);
    out = o;
    if (f1 < minf) {
      minx = x1;
      minf = f1;
    }
    if (tabs(f1) <= eps1) {
      xfin = x1;
      done = true;
      break;
    }
    if (val(f1) * val(f0) < S(0)) {
      brent = true;
      ba = x0; bb = x1; bfa = f0; bfb = f1; btol = tol;
      break;
    }
    if (it > itmax) {
      // reference: on iteration overflow, x0 keeps the post-shift value
      over = true;
      xfin = x0;
      done = true;
      break;
    }
  }
  if (over) {
    // final evaluation at the minimum-f point (reference line 615)
    o = out;
    ci_func<T, MODE>(minx, o, e);
    out = o;
  }

  // Brent phase for leaves that bracketed a root
  if (brent) {
    T a = ba, b = bb, fa = bfa, fb = bfb, c = bb, fc = bfb;
    T d = T(0), ed = T(0);
    bool bdone = false;
    for (int bit = 0; bit < itmax_b; ++bit) {
      if ((fb > S(0) && fc > S(0)) || (fb < S(0) && fc < S(0))) {
        c = a; fc = fa; d = b - a; ed = b - a;
      }
      if (tabs(val(fc)) < tabs(val(fb))) {
        a = b; b = c; c = a;
        fa = fb; fb = fc; fc = fa;
      }
      const T tol1 = two_eps_b * tabs(b) + S(0.5) * btol;
      const T xm = S(0.5) * (c - b);
      if (tabs(val(xm)) <= val(tol1) || fb == S(0)) {
        xfin = b;
        bdone = true;
        break;
      }
      const bool interp_ok =
          tabs(val(ed)) >= val(tol1) && tabs(val(fa)) > tabs(val(fb));
      const T sr = fb / (fa != S(0) ? fa : T(1.0));
      const bool aeqc = a == c;
      const T p1 = S(2.0) * xm * sr;
      const T q1 = S(1.0) - sr;
      const T fcs = (fc != S(0)) ? fc : T(1.0);
      const T q2 = fa / fcs;
      const T r2 = fb / fcs;
      const T p2 = sr * (S(2.0) * xm * q2 * (q2 - r2) -
                         (b - a) * (r2 - S(1.0)));
      const T q2b = (q2 - S(1.0)) * (r2 - S(1.0)) * (sr - S(1.0));
      T pp = aeqc ? p1 : p2;
      T qq = aeqc ? q1 : q2b;
      if (pp > S(0)) qq = -qq;
      pp = tabs(pp);
      // values only: the test selects, its tangent is never used
      const S vxm = val(xm), vqq = val(qq), vtol1 = val(tol1);
      const bool accept =
          interp_ok &&
          (S(2.0) * val(pp) < nmin(S(3.0) * vxm * vqq - tabs(vtol1 * vqq),
                                   tabs(val(ed) * vqq)));
      const T d_int = pp / (qq != S(0) ? qq : T(1.0));
      const T d_next = accept ? d_int : xm;
      const T e_next = accept ? d : xm;
      const T signed_tol = (xm >= S(0)) ? tol1 : -tol1;
      const T step = (tabs(val(d_next)) > val(tol1)) ? d_next : signed_tol;
      const T b_next = b + step;
      o = out;
      const T fbe = ci_func<T, MODE>(b_next, o, e);
      out = o;
      a = b; fa = fb;
      b = b_next; fb = fbe;
      d = d_next; ed = e_next;
      if (fbe == S(0)) {
        xfin = b_next;
        bdone = true;
        break;
      }
    }
    // leaves that exhausted Brent's ITMAX end at x = b (line 510)
    if (!bdone) xfin = b;
  }
  iters = it;
  return xfin;
}

#ifdef __CUDACC__

template <typename T>
struct Ptrs {
  const T* env[kEnv];
};

template <typename T>
__device__ __forceinline__ Env<T> load_env(const Ptrs<T>& P, long long i) {
  Env<T> e;
  e.gb_mol = P.env[0][i]; e.je = P.env[1][i]; e.cair = P.env[2][i];
  e.oair = P.env[3][i]; e.lmr_z = P.env[4][i]; e.par_z = P.env[5][i];
  e.rh_can = P.env[6][i]; e.vcmax_z = P.env[7][i]; e.forc_pbot = P.env[8][i];
  e.cp = P.env[9][i]; e.kc = P.env[10][i]; e.ko = P.env[11][i];
  e.tpu_z = P.env[12][i]; e.kp_z = P.env[13][i]; e.bbb = P.env[14][i];
  e.qe = P.env[15][i]; e.theta_cj = P.env[16][i]; e.mbbopt = P.env[17][i];
  e.c3frac = P.env[18][i];
  return e;
}

template <typename T, int MODE>
__global__ void ci_hybrid_kernel(long long n, Ptrs<T> P,
                                 const T* __restrict__ x0_in,
                                 const unsigned char* __restrict__ enabled,
                                 T* __restrict__ ci_out, T* __restrict__ gs_out,
                                 T* __restrict__ ac_out, T* __restrict__ aj_out,
                                 T* __restrict__ ap_out, T* __restrict__ ag_out,
                                 T* __restrict__ an_out,
                                 int* __restrict__ iters_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const Env<T> e = load_env(P, i);
  Out<T> out;
  int it;
  const T xfin = solve_leaf<T, MODE>(e, x0_in[i], enabled[i] != 0, out, it);
  ci_out[i] = xfin;
  gs_out[i] = out.gs; ac_out[i] = out.ac; aj_out[i] = out.aj;
  ap_out[i] = out.ap; ag_out[i] = out.ag; an_out[i] = out.an;
  iters_out[i] = it;
}

// the tangent version: values and tangents of the env fields, x0 and the
// seven results in separate arrays
struct OutPtrs {
  double* v[7];
  double* t[7];
};

template <int MODE>
__global__ void ci_hybrid_jvp_kernel(long long n, Ptrs<double> P,
                                     Ptrs<double> Pt,
                                     const double* __restrict__ x0_in,
                                     const double* __restrict__ x0_t,
                                     const unsigned char* __restrict__ enabled,
                                     OutPtrs O, int* __restrict__ iters_out) {
  using D = Dual<double>;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const Env<double> ev = load_env(P, i);
  const Env<double> et = load_env(Pt, i);
  const Env<D> e = {
      D(ev.gb_mol, et.gb_mol),       D(ev.je, et.je),
      D(ev.cair, et.cair),           D(ev.oair, et.oair),
      D(ev.lmr_z, et.lmr_z),         D(ev.par_z, et.par_z),
      D(ev.rh_can, et.rh_can),       D(ev.vcmax_z, et.vcmax_z),
      D(ev.forc_pbot, et.forc_pbot), D(ev.cp, et.cp),
      D(ev.kc, et.kc),               D(ev.ko, et.ko),
      D(ev.tpu_z, et.tpu_z),         D(ev.kp_z, et.kp_z),
      D(ev.bbb, et.bbb),             D(ev.qe, et.qe),
      D(ev.theta_cj, et.theta_cj),   D(ev.mbbopt, et.mbbopt),
      D(ev.c3frac, et.c3frac)};
  Out<D> o;
  int it;
  const D xfin = solve_leaf<D, MODE>(e, D(x0_in[i], x0_t[i]), enabled[i] != 0,
                                     o, it);
  const D r[7] = {xfin, o.gs, o.ac, o.aj, o.ap, o.ag, o.an};
  for (int k = 0; k < 7; ++k) {
    O.v[k][i] = r[k].v;
    O.t[k][i] = r[k].d;
  }
  iters_out[i] = it;
}

constexpr int kThreads = 128;

template <typename T>
Ptrs<T> ptrs(const void* const* env) {
  Ptrs<T> P;
  for (int k = 0; k < kEnv; ++k) P.env[k] = static_cast<const T*>(env[k]);
  return P;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

template <typename T>
int launch(int mode, long long n, const void* const* env, const void* x0,
           const void* enabled, void* const* out, void* stream) {
  if (n <= 0) return 0;
  const Ptrs<T> P = ptrs<T>(env);
  const unsigned blocks = blocks_for(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(x0);
  const unsigned char* en = static_cast<const unsigned char*>(enabled);
  T* o[7];
  for (int k = 0; k < 7; ++k) o[k] = static_cast<T*>(out[k]);
  int* iters = static_cast<int*>(out[7]);
  switch (mode) {
    case kC3:
      ci_hybrid_kernel<T, kC3><<<blocks, kThreads, 0, s>>>(
          n, P, x, en, o[0], o[1], o[2], o[3], o[4], o[5], o[6], iters);
      break;
    case kC4:
      ci_hybrid_kernel<T, kC4><<<blocks, kThreads, 0, s>>>(
          n, P, x, en, o[0], o[1], o[2], o[3], o[4], o[5], o[6], iters);
      break;
    case kMixed:
      ci_hybrid_kernel<T, kMixed><<<blocks, kThreads, 0, s>>>(
          n, P, x, en, o[0], o[1], o[2], o[3], o[4], o[5], o[6], iters);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// env: 19 device pointers in CiEnv field order; out: ci, gs_mol, ac, aj, ap,
// ag, an (T) and the secant iteration count (int32).  mode: 0 c3, 1 c4,
// 2 mixed.  Launches on `stream`; returns cudaGetLastError().
extern "C" int ci_hybrid_solve_f64(int mode, long long n,
                                   const void* const* env, const void* x0,
                                   const void* enabled, void* const* out,
                                   void* stream) {
  return launch<double>(mode, n, env, x0, enabled, out, stream);
}

extern "C" int ci_hybrid_solve_f32(int mode, long long n,
                                   const void* const* env, const void* x0,
                                   const void* enabled, void* const* out,
                                   void* stream) {
  return launch<float>(mode, n, env, x0, enabled, out, stream);
}

// The tangent version, float64 only.  env/env_t: 19 device pointers each
// (values and tangents, CiEnv order); out: the seven results and the
// iteration count as for ci_hybrid_solve_f64; out_t: the seven results'
// tangents.  mode as above.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int ci_hybrid_solve_jvp_f64(int mode, long long n,
                                       const void* const* env,
                                       const void* const* env_t,
                                       const void* x0, const void* x0_t,
                                       const void* enabled, void* const* out,
                                       void* const* out_t, void* stream) {
  if (n <= 0) return 0;
  const Ptrs<double> P = ptrs<double>(env), Pt = ptrs<double>(env_t);
  OutPtrs O;
  for (int k = 0; k < 7; ++k) {
    O.v[k] = static_cast<double*>(out[k]);
    O.t[k] = static_cast<double*>(out_t[k]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* x = static_cast<const double*>(x0);
  const double* xt = static_cast<const double*>(x0_t);
  const unsigned char* en = static_cast<const unsigned char*>(enabled);
  int* iters = static_cast<int*>(out[7]);
  const unsigned blocks = blocks_for(n);
  switch (mode) {
    case kC3:
      ci_hybrid_jvp_kernel<kC3><<<blocks, kThreads, 0, s>>>(
          n, P, Pt, x, xt, en, O, iters);
      break;
    case kC4:
      ci_hybrid_jvp_kernel<kC4><<<blocks, kThreads, 0, s>>>(
          n, P, Pt, x, xt, en, O, iters);
      break;
    case kMixed:
      ci_hybrid_jvp_kernel<kMixed><<<blocks, kThreads, 0, s>>>(
          n, P, Pt, x, xt, en, O, iters);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
