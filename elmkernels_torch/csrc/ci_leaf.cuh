// The per-leaf intracellular CO2 (ci) root solve shared by the kernels that
// run it: K1 and K1-T (ci_hybrid_solve.cu) and K2 (canopy_stability.cu),
// which inlines it in the canopy stability loop.  solve_leaf runs a leaf
// to its end (K1); leaf_begin/leaf_after, below, run the same sequence one
// evaluation at a time (K1-T, K2).
//
// solve_leaf runs the sequence one leaf follows in the masked batch loop
// of physics/photosynthesis.py:hybrid_solve_plain, to its own end: the
// evaluations at x0 and 0.99*x0, secant steps (at most 40, eps 1e-2, eps1
// 1e-4) in the conv/close/bracket/overflow order, the final evaluation at
// the minimum-|f| point on overflow, then at most 20 Brent steps starting
// at btol = tol.  On an < 0 the residual is 0 and gs_mol keeps its
// previous value.  T is float, double, or (in ci_hybrid_solve.cu) a dual
// number whose Real<> specialisation and operators that file declares.
// Build with --fmad=false so that the arithmetic is the plain version's,
// operation by operation.  The functions are HD: a host compiler builds
// them as plain C++ (the CPU tests do).

#pragma once

#include <math.h>
#include <stdint.h>

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

// the plain scalar type of T: T itself, or a Dual's value type
template <typename T>
struct Real { using type = T; };

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
// E is Env<T>, or EnvRef<T> for fields read where they are used.
template <typename T, int MODE, typename E>
HD T ci_func(T ci, Out<T>& o, const E& e) {
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

constexpr int kLanes = 32;

// A leaf's env read where it is used: references to its fields (in shared
// memory, or device memory, in K1-T and K2), so that ci_func loads each
// field at its use instead of holding all 19 (38 values with tangents) in
// registers.
template <typename T>
struct EnvRef {
  const T &gb_mol, &je, &cair, &oair, &lmr_z, &par_z, &rh_can, &vcmax_z,
      &forc_pbot, &cp, &kc, &ko, &tpu_z, &kp_z, &bbb, &qe, &theta_cj,
      &mbbopt, &c3frac;
};

// ---- the solve as a resumable per-leaf machine -----------------------------
//
// K1-T (on duals) and K2 (on float and double) run solve_leaf's sequence
// for a leaf one residual evaluation at a time, so that a lane can stop
// after any evaluation and take another leaf or column: the same
// operations in the same order, split at each evaluation.
// A leaf's state between evaluations is its iterates (Brent reuses the
// secant's registers: a = x0, fa = f0, b = x1, fb = f1, c = mx, fc = mf),
// Brent's step and tolerance, and the gs_mol of its last committed
// evaluation; the other rates of that evaluation are the caller's to keep
// (K1-T's leaf_eval stores them; K2 keeps an) and are not carried.  Only
// evaluations whose results solve_leaf keeps are made: none for a disabled
// leaf, no second starting one after f(x0) = 0.

enum { kStart0, kStart1, kSecant, kOver, kBrent };

template <typename T>
struct Leaf {
  T x0, f0, x1, f1, mx, mf, d, ed, tol, gs;
  int it, bit, state;
};

// The point of the leaf's next evaluation.
template <typename T>
HD T leaf_point(const Leaf<T>& s) {
  return s.state == kStart0 ? s.x0 : (s.state == kOver ? s.mx : s.x1);
}

// Starts a leaf: true if it needs evaluations, false if it is done with
// ci = xfin (a disabled leaf: x0, every rate and gs_mol 0, no iteration).
template <typename T>
HD bool leaf_begin(Leaf<T>& s, T xinit, bool en, T& xfin) {
  xfin = xinit;
  s = {xinit, T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0),
       0, 0, kStart0};
  return en;
}

// The secant loop's head: the next iterate, and true to evaluate it, or
// false on convergence (xfin set).
template <typename T>
HD bool secant_head(Leaf<T>& s, T& xfin) {
  using S = typename Real<T>::type;
  const S eps = S(1.0e-2);
  ++s.it;
  const T den = s.f1 - s.f0;
  const T dx = -s.f1 * (s.x1 - s.x0) / (den != S(0) ? den : T(1.0));
  const T x = s.x1 + dx;
  s.tol = tabs(x) * eps;
  if (tabs(dx) < s.tol) {
    xfin = x;
    return false;
  }
  s.x0 = s.x1;
  s.f0 = s.f1;
  s.x1 = x;
  s.state = kSecant;
  return true;
}

// Brent's head (btol = the bracketing secant step's tol): the next point
// b + step, and true to evaluate it, or false on convergence (xfin set).
template <typename T>
HD bool brent_head(Leaf<T>& s, T& xfin) {
  using S = typename Real<T>::type;
  const S two_eps_b = S(2.0 * 1.0e-2);
  T &a = s.x0, &fa = s.f0, &b = s.x1, &fb = s.f1, &c = s.mx, &fc = s.mf;
  if ((fb > S(0) && fc > S(0)) || (fb < S(0) && fc < S(0))) {
    c = a; fc = fa; s.d = b - a; s.ed = b - a;
  }
  if (tabs(val(fc)) < tabs(val(fb))) {
    a = b; b = c; c = a;
    fa = fb; fb = fc; fc = fa;
  }
  const T tol1 = two_eps_b * tabs(b) + S(0.5) * s.tol;
  const T xm = S(0.5) * (c - b);
  if (tabs(val(xm)) <= val(tol1) || fb == S(0)) {
    xfin = b;
    return false;
  }
  const bool interp_ok =
      tabs(val(s.ed)) >= val(tol1) && tabs(val(fa)) > tabs(val(fb));
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
  const S vxm = val(xm), vqq = val(qq), vtol1 = val(tol1);
  const bool accept =
      interp_ok &&
      (S(2.0) * val(pp) < nmin(S(3.0) * vxm * vqq - tabs(vtol1 * vqq),
                               tabs(val(s.ed) * vqq)));
  const T d_int = pp / (qq != S(0) ? qq : T(1.0));
  const T d_next = accept ? d_int : xm;
  const T e_next = accept ? s.d : xm;
  const T signed_tol = (xm >= S(0)) ? tol1 : -tol1;
  const T step = (tabs(val(d_next)) > val(tol1)) ? d_next : signed_tol;
  // a takes b's place and b moves to the point evaluated next (fb is its
  // residual, set after the evaluation)
  a = b;
  fa = fb;
  b = b + step;
  s.d = d_next;
  s.ed = e_next;
  s.state = kBrent;
  return true;
}

// Applies the residual f of the evaluation at leaf_point(s): true if the
// leaf evaluates again (at leaf_point(s)), false if it is done (xfin set).
template <typename T>
HD bool leaf_after(Leaf<T>& s, T f, T& xfin) {
  using S = typename Real<T>::type;
  const S eps1 = S(1.0e-4);
  const int itmax = 40, itmax_b = 20;
  switch (s.state) {
    case kStart0:
      s.f0 = f;
      if (f == S(0)) {
        xfin = s.x0;
        return false;
      }
      s.mx = s.x0;
      s.mf = f;
      s.x1 = s.x0 * S(0.99);
      s.state = kStart1;
      return true;
    case kStart1:
      s.f1 = f;
      if (f == S(0)) {
        xfin = s.x1;
        return false;
      }
      if (f < s.mf) {
        s.mx = s.x1;
        s.mf = f;
      }
      return secant_head(s, xfin);
    case kSecant:
      s.f1 = f;
      if (f < s.mf) {
        s.mx = s.x1;
        s.mf = f;
      }
      if (tabs(f) <= eps1) {
        xfin = s.x1;
        return false;
      }
      if (val(f) * val(s.f0) < S(0)) {
        // bracketed: Brent from a = x0, b = c = x1
        s.mx = s.x1;
        s.mf = f;
        s.d = T(0);
        s.ed = T(0);
        s.bit = 0;
        return brent_head(s, xfin);
      }
      if (s.it > itmax) {
        // reference: on iteration overflow, x0 keeps the post-shift value;
        // one more evaluation at the minimum-f point (line 615)
        s.state = kOver;
        return true;
      }
      return secant_head(s, xfin);
    case kOver:
      xfin = s.x0;
      return false;
    default:  // kBrent
      s.f1 = f;
      if (f == S(0)) {
        xfin = s.x1;
        return false;
      }
      // leaves that exhaust Brent's ITMAX end at x = b (line 510)
      if (++s.bit == itmax_b) {
        xfin = s.x1;
        return false;
      }
      return brent_head(s, xfin);
  }
}

}  // namespace
