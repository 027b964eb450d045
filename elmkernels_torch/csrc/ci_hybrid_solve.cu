// Per-leaf intracellular CO2 (ci) root solve: secant iteration, then Brent
// on leaves whose secant steps bracket a root.
//
// Replaces: elmkernels_tpu/physics/photosynthesis.py:hybrid_solve (lines
// 238-413, with ci_func at 163), the masked-batch port of the reference's
// hybrid/brent (photosynthesis_impl.hh:395-620).  The JAX package once had
// this as the Pallas kernel ops/ci_solver.py:ci_hybrid_solve (f32 only,
// removed in commit 8dfd5dd because Mosaic has no f64).
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
// Bound: operations.  A leaf reads 21 values and writes 8, and runs up to
// ~62 residual evaluations of ~60 flops each with divisions and square
// roots; the kernel holds every iterate in registers and never returns to
// device memory between iterations, which is what the eager masked loop
// (one host sync and ~100 small launches per iteration) cannot do.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kEnv = 19;
constexpr int kC3 = 0, kC4 = 1, kMixed = 2;

template <typename T>
struct Ptrs {
  const T* env[kEnv];
};

template <typename T>
struct Out {
  T gs, ac, aj, ap, ag, an;
};

template <typename T>
struct Env {
  T gb_mol, je, cair, oair, lmr_z, par_z, rh_can, vcmax_z, forc_pbot, cp,
      kc, ko, tpu_z, kp_z, bbb, qe, theta_cj, mbbopt, c3frac;
};

__device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double tsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float tabs(float x) { return fabsf(x); }
__device__ __forceinline__ double tabs(double x) { return fabs(x); }

// NaN-propagating max/min (torch.maximum/jnp.maximum semantics)
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a > b || isnan(a)) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (a < b || isnan(a)) ? a : b;
}

template <typename T>
__device__ __forceinline__ void quadratic_roots(T a, T b, T c, T& r1, T& r2) {
  const T disc = tsqrt(b * b - T(4.0) * a * c);
  const T q = (b >= T(0)) ? T(-0.5) * (b + disc) : T(-0.5) * (b - disc);
  r1 = q / a;
  r2 = (q != T(0)) ? c / q : T(1.0e36);
}

// Residual f(ci) and the rates at ci; `o.gs` enters as the previous gs_mol.
template <typename T, int MODE>
__device__ T ci_func(T ci, Out<T>& o, const Env<T>& e) {
  T ac, aj, ap;
  T ac3 = 0, aj3 = 0, ap3 = 0, ac4 = 0, aj4 = 0, ap4 = 0;
  if (MODE != kC4) {
    ac3 = e.vcmax_z * nmax(ci - e.cp, T(0)) /
          (ci + e.kc * (T(1.0) + e.oair / e.ko));
    aj3 = e.je * nmax(ci - e.cp, T(0)) / (T(4.0) * ci + T(8.0) * e.cp);
    ap3 = T(3.0) * e.tpu_z;
  }
  if (MODE != kC3) {
    ac4 = e.vcmax_z;
    aj4 = e.qe * e.par_z * T(4.6);
    ap4 = e.kp_z * nmax(ci, T(0)) / e.forc_pbot;
  }
  if (MODE == kC3) {
    ac = ac3; aj = aj3; ap = ap3;
  } else if (MODE == kC4) {
    ac = ac4; aj = aj4; ap = ap4;
  } else {
    const bool isc3 = e.c3frac >= T(0.5);
    ac = isc3 ? ac3 : ac4;
    aj = isc3 ? aj3 : aj4;
    ap = isc3 ? ap3 : ap4;
  }
  T r1, r2;
  quadratic_roots(e.theta_cj, -(ac + aj), ac * aj, r1, r2);
  const T ai = nmin(r1, r2);
  quadratic_roots(T(0.95), -(ai + ap), ai * ap, r1, r2);
  const T ag = nmin(r1, r2);
  const T an = ag - e.lmr_z;

  const bool neg = an < T(0);
  const T cs = nmax(e.cair - T(1.4) / e.gb_mol * an * e.forc_pbot, T(1.e-6));
  quadratic_roots(cs, cs * (e.gb_mol - e.bbb) - e.mbbopt * an * e.forc_pbot,
                  -e.gb_mol * (cs * e.bbb +
                               e.mbbopt * an * e.forc_pbot * e.rh_can),
                  r1, r2);
  const T gs_new = nmax(r1, r2);
  const T gs = neg ? o.gs : gs_new;
  const T gs_safe = (gs != T(0)) ? gs : T(1.0);
  const T fval = neg ? T(0)
                     : ci - e.cair + an * e.forc_pbot *
                                         (T(1.4) * gs + T(1.6) * e.gb_mol) /
                                         (e.gb_mol * gs_safe);
  o.gs = gs; o.ac = ac; o.aj = aj; o.ap = ap; o.ag = ag; o.an = an;
  return fval;
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
  Env<T> e;
  e.gb_mol = P.env[0][i]; e.je = P.env[1][i]; e.cair = P.env[2][i];
  e.oair = P.env[3][i]; e.lmr_z = P.env[4][i]; e.par_z = P.env[5][i];
  e.rh_can = P.env[6][i]; e.vcmax_z = P.env[7][i]; e.forc_pbot = P.env[8][i];
  e.cp = P.env[9][i]; e.kc = P.env[10][i]; e.ko = P.env[11][i];
  e.tpu_z = P.env[12][i]; e.kp_z = P.env[13][i]; e.bbb = P.env[14][i];
  e.qe = P.env[15][i]; e.theta_cj = P.env[16][i]; e.mbbopt = P.env[17][i];
  e.c3frac = P.env[18][i];

  const T eps = T(1.0e-2), eps1 = T(1.0e-4);
  const int itmax = 40, itmax_b = 20;
  const T two_eps_b = T(2.0 * 1.0e-2);

  const T xinit = x0_in[i];
  const bool en = enabled[i] != 0;
  Out<T> out = {T(0), T(0), T(0), T(0), T(0), T(0)};

  // the two starting evaluations
  Out<T> o = out;
  T x0 = xinit;
  T f0 = ci_func<T, MODE>(x0, o, e);
  if (en) out = o;
  bool done = !en || f0 == T(0);
  T xfin = xinit, minx = xinit, minf = f0;
  T x1 = xinit * T(0.99);
  o = out;
  T f1 = ci_func<T, MODE>(x1, o, e);
  if (!done) out = o;
  if (!done && f1 == T(0)) {
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
  T ba = 0, bb = 0, bfa = 0, bfb = 0, btol = 0;
  while (!done && !brent) {
    ++it;
    const T den = f1 - f0;
    const T dx = -f1 * (x1 - x0) / (den != T(0) ? den : T(1.0));
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
    if (f1 * f0 < T(0)) {
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
    T d = 0, ed = 0;
    bool bdone = false;
    for (int bit = 0; bit < itmax_b; ++bit) {
      if ((fb > T(0) && fc > T(0)) || (fb < T(0) && fc < T(0))) {
        c = a; fc = fa; d = b - a; ed = b - a;
      }
      if (tabs(fc) < tabs(fb)) {
        a = b; b = c; c = a;
        fa = fb; fb = fc; fc = fa;
      }
      const T tol1 = two_eps_b * tabs(b) + T(0.5) * btol;
      const T xm = T(0.5) * (c - b);
      if (tabs(xm) <= tol1 || fb == T(0)) {
        xfin = b;
        bdone = true;
        break;
      }
      const bool interp_ok = tabs(ed) >= tol1 && tabs(fa) > tabs(fb);
      const T sr = fb / (fa != T(0) ? fa : T(1.0));
      const bool aeqc = a == c;
      const T p1 = T(2.0) * xm * sr;
      const T q1 = T(1.0) - sr;
      const T fcs = (fc != T(0)) ? fc : T(1.0);
      const T q2 = fa / fcs;
      const T r2 = fb / fcs;
      const T p2 = sr * (T(2.0) * xm * q2 * (q2 - r2) -
                         (b - a) * (r2 - T(1.0)));
      const T q2b = (q2 - T(1.0)) * (r2 - T(1.0)) * (sr - T(1.0));
      T pp = aeqc ? p1 : p2;
      T qq = aeqc ? q1 : q2b;
      if (pp > T(0)) qq = -qq;
      pp = tabs(pp);
      const bool accept =
          interp_ok && (T(2.0) * pp < nmin(T(3.0) * xm * qq - tabs(tol1 * qq),
                                           tabs(ed * qq)));
      const T d_int = pp / (qq != T(0) ? qq : T(1.0));
      const T d_next = accept ? d_int : xm;
      const T e_next = accept ? d : xm;
      const T signed_tol = (xm >= T(0)) ? tol1 : -tol1;
      const T step = (tabs(d_next) > tol1) ? d_next : signed_tol;
      const T b_next = b + step;
      o = out;
      const T fbe = ci_func<T, MODE>(b_next, o, e);
      out = o;
      a = b; fa = fb;
      b = b_next; fb = fbe;
      d = d_next; ed = e_next;
      if (fbe == T(0)) {
        xfin = b_next;
        bdone = true;
        break;
      }
    }
    // leaves that exhausted Brent's ITMAX end at x = b (line 510)
    if (!bdone) xfin = b;
  }

  ci_out[i] = xfin;
  gs_out[i] = out.gs; ac_out[i] = out.ac; aj_out[i] = out.aj;
  ap_out[i] = out.ap; ag_out[i] = out.ag; an_out[i] = out.an;
  iters_out[i] = it;
}

template <typename T>
int launch(int mode, long long n, const void* const* env, const void* x0,
           const void* enabled, void* const* out, void* stream) {
  if (n <= 0) return 0;
  Ptrs<T> P;
  for (int k = 0; k < kEnv; ++k) P.env[k] = static_cast<const T*>(env[k]);
  const int threads = 128;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* x = static_cast<const T*>(x0);
  const unsigned char* en = static_cast<const unsigned char*>(enabled);
  T* o[7];
  for (int k = 0; k < 7; ++k) o[k] = static_cast<T*>(out[k]);
  int* iters = static_cast<int*>(out[7]);
  switch (mode) {
    case kC3:
      ci_hybrid_kernel<T, kC3><<<blocks, threads, 0, s>>>(
          n, P, x, en, o[0], o[1], o[2], o[3], o[4], o[5], o[6], iters);
      break;
    case kC4:
      ci_hybrid_kernel<T, kC4><<<blocks, threads, 0, s>>>(
          n, P, x, en, o[0], o[1], o[2], o[3], o[4], o[5], o[6], iters);
      break;
    case kMixed:
      ci_hybrid_kernel<T, kMixed><<<blocks, threads, 0, s>>>(
          n, P, x, en, o[0], o[1], o[2], o[3], o[4], o[5], o[6], iters);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

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
