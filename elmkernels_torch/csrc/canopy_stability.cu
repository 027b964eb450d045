// K2: the canopy stability loop, one thread per column, with the ci solve
// of both leaves inlined.
//
// Replaces: elmkernels_tpu/physics/canopy_fluxes.py:stability_iteration
// (line 199), whose masked lax.while_loop (line 506) the port ran as a
// Python while over the batch (physics/canopy_fluxes.py:
// stability_iteration_plain): about a thousand launches and one host wait
// an iteration, up to 41 iterations a step.  Reference:
// canopy_fluxes_impl.hh:185-452.
//
// Each thread runs its column's sequence of the masked loop to its own
// end: at most 41 passes (itlef from 0 while itlef <= 40), each the
// aerodynamic chain (friction velocity and resistances), photosynthesis of
// the sun and the shade leaf (per-leaf set-up, then solve_leaf from
// ci_leaf.cuh), the flux chain (damping of an oscillating latent heat,
// the leaf-temperature Newton step, the 1 K step limit), qsat, the
// Monin-Obukhov update with its sign-flip counter and the dual convergence
// test; then the outputs recomputed once from the entry state of the last
// pass.  A bare column (frac_veg_nosno == 0) never iterates: zeros and
// pass-throughs, as in the plain loop.
//
// The arithmetic is the plain loop's, operation by operation and in its
// order (build with --fmad=false), as PyTorch's elementwise kernels compute
// each operation on the card:
// - a Python number in the plain version is a double folded as Python
//   folds it, then rounded to T where it meets a tensor (`T(k)`);
// - tensor / number multiplies by the number's reciprocal, taken in double
//   and rounded to T, on the card (ATen's div_true_kernel_cuda), and
//   divides by the number rounded to T on the CPU (divs);
//   1.0 / tensor is the tensor's reciprocal; rdiv in the plain version is a
//   true division;
// - x ** 2.0 and x ** 3.0 are products, other powers pow, compiled apart
//   with contraction on as PyTorch's kernels are (canopy_pow.cu); clamp,
//   minimum and maximum propagate NaN (nmin, nmax);
// - a clamp's bound is rounded to T: clamp(min=1e-300) is a clamp at 0 in
//   float.
// The constants that Python computes with its own math library (the
// profile functions' values at the transition points) come from the caller
// (Consts), so both sides use the same bits.
//
// Design: one thread a column, no shared memory; the loop's ~56 per-column
// inputs and 27 traits are read from global memory where they are used.
// The same source built by a host compiler (the device code is HD inline
// functions; the kernel and its launch sit under __CUDACC__) is what the
// CPU tests run.
//
// What bounds it: by its bytes (~0.5 KB a column read and written once)
// on the model's paths, where most columns converge in a few passes; by
// its operations on the test problems.  It runs far from either: each
// column is a chain of dependent divisions, square roots and
// transcendentals; 250-255 registers a thread leave 8 warps an SM to hide
// their latency; and a warp runs as long as its slowest column (a tree
// column at the 41-pass cap, a leaf whose secant search runs out).  A
// simple kernel that is right comes first: refilling lanes as K1-T does,
// and staging the inputs, are left for later (PERF.md, K2's row).

#include "ci_leaf.cuh"

#ifdef __CUDACC__
// canopy_pow.cu: pow compiled with contracted multiply-adds, as PyTorch's
// kernels compute x ** p (see there)
extern __device__ double canopy_pow(double x, double p);
extern __device__ float canopy_powf(float x, float p);
#endif

namespace {

// ---- the per-column inputs, in ops/canopy.py's IN_FIELDS order -----------

enum {
  kFracSno, kHgtU, kHgtT, kHgtQ, kFwet, kFdry, kLaisun, kLaisha, kForcRho,
  kSnowDepth, kSoilbeta, kFracH2osfc, kTH2osfc, kSabv, kH2ocan, kHtop, kAir,
  kBir, kCir, kUr, kZldis, kDispla, kElai, kEsai, kTGrnd, kForcPbot, kForcQ,
  kForcTh, kZ0mg, kZ0mv, kZ0hv, kZ0qv, kThm, kThv, kQg, kT10,
  kVcmaxcintsha, kVcmaxcintsun, kParshaZ, kParsunZ, kLaishaZ, kLaisunZ,
  kForcPco2, kForcPo2, kDaylFactor, kBtran, kEl, kQsatl, kQsatldT, kTaf,
  kQaf, kUm, kObu, kDelq, kTVeg, kFveg, kIn
};

// PFTPsnParams' fields, in its order
enum {
  pFnr, pAct25, pKcha, pKoha, pCpha, pVcmaxha, pJmaxha, pTpuha, pLmrha,
  pVcmaxhd, pJmaxhd, pTpuhd, pLmrhd, pLmrse, pQe, pThetaCj, pBbbopt,
  pMbbopt, pC3psn, pSlatop, pLeafcn, pFlnr, pFnitr, pDleaf, pSmpso, pSmpsc,
  pTcStress, kTraits
};

// StabilityOut's floating [ncol] fields, in its order
enum {
  oBtran, oQflxTranVeg, oQflxEvapVeg, oEflxShVeg, oWtg, oWtl0, oWta0, oWtal,
  oEl, oQsatl, oQsatldT, oTaf, oQaf, oUm, oDth, oDqh, oObu, oTemp1, oTemp2,
  oTemp12m, oTemp22m, oTlbef, oDelq, oDtVeg, oTVeg, oWtgq, oWtalq, oWtlq0,
  oWtaq0, kOut
};

// Python-level constants, in ops/canopy.py's CONSTS order
struct Consts {
  double vkc, grav, csoilc, cpair, hvap, tfrz, rgas, pi, zetam, zetat,
      psi_m_zetam, psi_h_zetat, zetam_p333, zetat_m333, sco, rsmax0, fnps,
      theta_psii;
};
constexpr int kConsts = sizeof(Consts) / sizeof(double);

template <typename T>
struct Args {
  long long n;
  const T* in[kIn];
  const T* traits[kTraits];
  const T* t_soisno;     // [n, nlevtot]
  int nlevtot, nlevsno;
  const int* snl;        // [n]
  const unsigned char* soybean;  // [n]
  const T* ci_prev;      // [2n] or null
  bool warm_start;
  double dtime;
  Consts K;
  T* out[kOut];
  int* itlef;            // [n]
  T* ci;                 // [2n] sun | shade
  int* psn_iters;        // [2n]
};

// ---- elementwise arithmetic as PyTorch computes it -------------------------

HD float texp(float x) { return expf(x); }
HD double texp(double x) { return exp(x); }
HD float tlog(float x) { return logf(x); }
HD double tlog(double x) { return log(x); }
HD float tatan(float x) { return atanf(x); }
HD double tatan(double x) { return atan(x); }
HD float tpow(float x, float p) {
#ifdef __CUDA_ARCH__
  return canopy_powf(x, p);
#else
  return powf(x, p);
#endif
}
HD double tpow(double x, double p) {
#ifdef __CUDA_ARCH__
  return canopy_pow(x, p);
#else
  return pow(x, p);
#endif
}

// 2.0 ** x (torch.pow of a number by a tensor)
template <typename T>
HD T pow2(T x) { return tpow(T(2.0), x); }

// x ** p for a Python number p other than 2 and 3
template <typename T>
HD T powk(T x, double p) { return tpow(x, T(p)); }

// tensor / Python number
template <typename T>
HD T divs(T a, double s) {
#ifdef __CUDA_ARCH__
  const T inv = T(1.0 / s);
  return a * inv;
#else
  return a / T(s);
#endif
}

// torch.clamp(x, lo, hi), torch.clamp(x, max=hi)
template <typename T>
HD T clamp2(T x, double lo, double hi) { return nmin(nmax(x, T(lo)), T(hi)); }
template <typename T>
HD T clamp_max(T x, double hi) { return nmin(x, T(hi)); }

// ---- qsat ---------------------------------------------------------------

template <typename T>
struct QSat {
  T es, qs, qsdT;
};

template <typename T>
HD T horner(const double (&a)[9], T x) {
  T acc = T(a[8]);
  for (int k = 7; k >= 0; --k) acc = T(a[k]) + x * acc;
  return acc;
}

template <typename T>
HD QSat<T> qsat(T tv, T p, const Consts& K) {
  // water (T >= 0 C) and ice es and d(es)/dT, physics/qsat.py
  const double A[9] = {6.11213476, 0.444007856, 0.143064234e-01,
                       0.264461437e-03, 0.305903558e-05, 0.196237241e-07,
                       0.892344772e-10, -0.373208410e-12, 0.209339997e-15};
  const double B[9] = {0.444017302, 0.286064092e-01, 0.794683137e-03,
                       0.121211669e-04, 0.103354611e-06, 0.404125005e-09,
                       -0.788037859e-12, -0.114596802e-13, 0.381294516e-16};
  const double C[9] = {6.11123516, 0.503109514, 0.188369801e-01,
                       0.420547422e-03, 0.614396778e-05, 0.602780717e-07,
                       0.387940929e-09, 0.149436277e-11, 0.262655803e-14};
  const double D[9] = {0.503277922, 0.377289173e-01, 0.126801703e-02,
                       0.249468427e-04, 0.313703411e-06, 0.257180651e-08,
                       0.133268878e-10, 0.394116744e-13, 0.498070196e-16};
  const T td = clamp2(tv - T(K.tfrz), -75.0, 100.0);
  const bool water = td >= T(0);
  const T es = (water ? horner(A, td) : horner(C, td)) * T(100.0);
  const T esdT = (water ? horner(B, td) : horner(D, td)) * T(100.0);
  const T vp = T(1) / (p - es * T(0.378));
  const T vp1 = vp * T(0.622);
  const T vp2 = vp1 * vp;
  return {es, es * vp1, esdT * vp2 * p};
}

// ---- friction velocity (physics/friction_velocity.py) ----------------------

template <typename T>
HD T safe_log(T x) { return tlog(nmax(x, T(1e-300))); }

template <typename T>
HD T safe_npow(T x, double p) { return powk(nmax(x, T(1e-300)), p); }

template <typename T>
HD T stability_func1(T zeta, const Consts& K) {
  const T chik2 = tsqrt(nmax(T(1.0) - zeta * T(16.0), T(0)));
  const T chik = tsqrt(chik2);
  return tlog((T(1.0) + chik) * T(0.5)) * T(2.0) +
         tlog((T(1.0) + chik2) * T(0.5)) - tatan(chik) * T(2.0) +
         T(K.pi * 0.5);
}

template <typename T>
HD T stability_func2(T zeta) {
  const T chik2 = tsqrt(nmax(T(1.0) - zeta * T(16.0), T(0)));
  return tlog((T(1.0) + chik2) * T(0.5)) * T(2.0);
}

template <typename T>
HD T friction_velocity_wind(T hgt_u, T displa, T um, T obu, T z0m,
                            const Consts& K) {
  const T zldis = hgt_u - displa;
  const T zeta = zldis / obu;
  const T vkc_um = um * T(K.vkc);
  T den;
  if (zeta < T(-K.zetam)) {
    den = safe_log(obu * T(-K.zetam) / z0m) - T(K.psi_m_zetam) +
          stability_func1(z0m / obu, K) +
          (safe_npow(-zeta, 0.333) - T(K.zetam_p333)) * T(1.14);
  } else if (zeta < T(0)) {
    den = safe_log(zldis / z0m) - stability_func1(zeta, K) +
          stability_func1(z0m / obu, K);
  } else if (zeta <= T(1.0)) {
    den = safe_log(zldis / z0m) + zeta * T(5.0) - z0m * T(5.0) / obu;
  } else {
    den = safe_log(obu / z0m) + T(5.0) - z0m * T(5.0) / obu +
          (safe_log(zeta) * T(5.0) + zeta - T(1.0));
  }
  return vkc_um / den;
}

template <typename T>
HD T profile_factor(T zldis, T obu, T z0, const Consts& K) {
  const T zeta = zldis / obu;
  T den;
  if (zeta < T(-K.zetat)) {
    den = safe_log(obu * T(-K.zetat) / z0) - T(K.psi_h_zetat) +
          stability_func2(z0 / obu) +
          (T(K.zetat_m333) - safe_npow(-zeta, -0.333)) * T(0.8);
  } else if (zeta < T(0)) {
    den = safe_log(zldis / z0) - stability_func2(zeta) +
          stability_func2(z0 / obu);
  } else if (zeta <= T(1.0)) {
    den = safe_log(zldis / z0) + zeta * T(5.0) - z0 * T(5.0) / obu;
  } else {
    den = safe_log(obu / z0) + T(5.0) - z0 * T(5.0) / obu +
          (safe_log(zeta) * T(5.0) + zeta - T(1.0));
  }
  return T(K.vkc) / den;
}

// ---- one column ---------------------------------------------------------

template <typename T>
struct Column {
  const Args<T>& A;
  long long i;
  HD T in(int k) const { return A.in[k][i]; }
  HD T trait(int k) const { return A.traits[k][i]; }
};

// the aerodynamic chain of one pass from its entry (um, obu, taf)
template <typename T>
struct Chain1 {
  T ustar, temp1, temp2, rah0, raw0, rb, uaf, rah1, raw1;
};

template <typename T>
HD Chain1<T> chain1(const Column<T>& C, T um, T obu, T taf) {
  const Consts& K = C.A.K;
  Chain1<T> r;
  const T displa = C.in(kDispla), hgt_t = C.in(kHgtT), z0hv = C.in(kZ0hv);
  r.ustar = friction_velocity_wind(C.in(kHgtU), displa, um, obu, C.in(kZ0mv),
                                   K);
  r.temp1 = profile_factor(hgt_t - displa, obu, z0hv, K);
  const T hgt_q = C.in(kHgtQ), z0qv = C.in(kZ0qv);
  r.temp2 = (hgt_q == hgt_t && z0qv == z0hv)
                ? r.temp1
                : profile_factor(hgt_q - displa, obu, z0qv, K);
  const T ram = T(1) / (r.ustar * r.ustar / um);
  r.rah0 = T(1) / (r.temp1 * r.ustar);
  r.raw0 = T(1) / (r.temp2 * r.ustar);
  r.uaf = um * tsqrt(T(1) / (ram * um));
  const T cf_leaf = T(0.01) / (tsqrt(r.uaf) * tsqrt(C.trait(pDleaf)));
  r.rb = T(1) / (cf_leaf * r.uaf);

  const T w = texp(-(C.in(kElai) + C.in(kEsai)));
  const T z0mg = C.in(kZ0mg), t_grnd = C.in(kTGrnd);
  const T csoilb =
      T(K.vkc) / (powk(divs(z0mg * r.uaf, 1.5e-5), 0.45) * T(0.13));
  const T ri = (C.in(kHtop) * T(K.grav) * (taf - t_grnd)) /
               (taf * (r.uaf * r.uaf));
  const T ricsoilc =
      T(K.csoilc) / (T(1.0) + clamp_max(ri, 10.0) * T(0.5));
  const T csoilcn = (taf - t_grnd > T(0))
                        ? csoilb * w + ricsoilc * (T(1.0) - w)
                        : csoilb * w + (T(1.0) - w) * T(K.csoilc);
  r.rah1 = T(1) / (csoilcn * r.uaf);
  r.raw1 = r.rah1;
  return r;
}

// the flux chain of one pass from its entry state and stomatal resistances
template <typename T>
struct Chain2 {
  T dt_veg, t_veg_n, del, efe, wtg, wtl0, wtg0, wta0, wtal, wtgq, wtalq,
      wtlq0, wtaq0, wtgq0, qflx_tran_veg, qflx_evap_veg, eflx_sh_veg;
};

template <typename T>
HD Chain2<T> chain2(const Column<T>& C, const Chain1<T>& c1, T lw_grnd,
                    T t_veg, T qsatl, T qsatldT, T qaf, T delq, T efeb,
                    T btran, T rssun, T rssha) {
  const Consts& K = C.A.K;
  Chain2<T> r;
  const T elai = C.in(kElai), esai = C.in(kEsai);
  const T wta = T(1) / c1.rah0;
  const T wtl = (elai + esai) / c1.rb;
  r.wtg = T(1) / c1.rah1;
  const T wtshi = T(1) / (wta + wtl + r.wtg);
  r.wtl0 = wtl * wtshi;
  r.wtg0 = r.wtg * wtshi;
  r.wta0 = wta * wtshi;
  const T wtga = r.wta0 + r.wtg0;
  r.wtal = r.wta0 + r.wtl0;

  const T fdry = C.in(kFdry), rb = c1.rb;
  const T rppdry =
      (fdry > T(0))
          ? fdry * rb *
                (C.in(kLaisun) / (rb + rssun) + C.in(kLaisha) / (rb + rssha)) /
                elai
          : T(0);
  const T forc_rho = C.in(kForcRho);
  const T efpot = forc_rho * wtl * (qsatl - qaf);
  const bool can_tran = btran > T(0);
  const T h2ocan_dt = divs(C.in(kH2ocan), C.A.dtime);
  T qflx_tran_veg = (efpot > T(0) && can_tran) ? efpot * rppdry : T(0);
  const T fwet = C.in(kFwet);
  T rpp = (efpot > T(0)) ? (can_tran ? rppdry + fwet : fwet) : T(1.0);
  const T efpot_safe = (efpot != T(0)) ? efpot : T(1.0);
  if (efpot > T(0))
    rpp = nmin(rpp, (qflx_tran_veg + h2ocan_dt) / efpot_safe);

  const T fveg = C.in(kFveg);
  const T wtaq = fveg / c1.raw0;
  const T wtlq = fveg * (elai + esai) / rb * rpp;
  const T fsno_dl = divs(C.in(kSnowDepth), 0.05);
  const T elai_dl = (T(1.0) - clamp_max(fsno_dl, 1.0)) * T(0.5);
  const T rdl = (T(1.0) - texp(-elai_dl)) / (c1.uaf * T(0.004));
  r.wtgq = (delq < T(0)) ? fveg / (c1.raw1 + rdl)
                         : C.in(kSoilbeta) * fveg / (c1.raw1 + rdl);
  const T wtsqi = T(1) / (wtaq + wtlq + r.wtgq);
  r.wtgq0 = r.wtgq * wtsqi;
  r.wtlq0 = wtlq * wtsqi;
  r.wtaq0 = wtaq * wtsqi;
  const T wtgaq = r.wtaq0 + r.wtgq0;
  r.wtalq = r.wtaq0 + r.wtlq0;
  const T dc1 = forc_rho * T(K.cpair) * wtl;
  const T dc2 = forc_rho * T(K.hvap) * wtlq;
  const T t_grnd = C.in(kTGrnd), thm = C.in(kThm), qg = C.in(kQg),
          forc_q = C.in(kForcQ);
  const T efsh = dc1 * (wtga * t_veg - r.wtg0 * t_grnd - r.wta0 * thm);
  T efe = dc2 * (wtgaq * qsatl - r.wtgq0 * qg - r.wtaq0 * forc_q);

  // damp the oscillating leaf latent heat flux
  const bool osc = efe * efeb < T(0);
  const T erre = osc ? efe * T(0.1) - efe : T(0);
  if (osc) efe = efe * T(0.1);
  r.efe = efe;

  const T sabv = C.in(kSabv), air = C.in(kAir), bir = C.in(kBir),
          cir = C.in(kCir), qsd = qsatldT;
  const T tv3 = t_veg * t_veg * t_veg;
  T dt_veg = (sabv + air + bir * powk(t_veg, 4.0) + cir * lw_grnd - efsh -
              efe) /
             (bir * T(-4.0) * tv3 + dc1 * wtga + dc2 * wtgaq * qsd);
  r.t_veg_n = t_veg + dt_veg;
  const T dels = dt_veg;
  r.del = tabs(dels);
  const bool big = r.del > T(1.0);
  T err = T(0);
  if (big) {
    dt_veg = dels / r.del;
    r.t_veg_n = t_veg + dt_veg;
    err = sabv + air + bir * tv3 * (t_veg + dt_veg * T(4.0)) + cir * lw_grnd -
          (efsh + dc1 * wtga * dt_veg) - (efe + dc2 * wtgaq * qsd * dt_veg);
  }
  r.dt_veg = dt_veg;

  const T efpot2 = forc_rho * wtl *
                   (wtgaq * (qsatl + qsd * dt_veg) - r.wtgq0 * qg -
                    r.wtaq0 * forc_q);
  T qflx_evap_veg = rpp * efpot2;
  qflx_tran_veg = (efpot2 > T(0) && can_tran) ? efpot2 * rppdry : T(0);
  const T ecidif = nmax(qflx_evap_veg - qflx_tran_veg - h2ocan_dt, T(0));
  qflx_evap_veg = nmin(qflx_evap_veg, qflx_tran_veg + h2ocan_dt);
  r.qflx_tran_veg = qflx_tran_veg;
  r.qflx_evap_veg = qflx_evap_veg;
  r.eflx_sh_veg =
      efsh + dc1 * wtga * dt_veg + err + erre + ecidif * T(K.hvap);
  return r;
}

// Arrhenius response and high-temperature inhibition (photosynthesis.py)
template <typename T>
HD T ft(T tl, T ha, const Consts& K) {
  const double t25 = K.tfrz + 25.0;
  return texp(divs(ha, K.rgas * 1.0e-3 * t25) * (T(1.0) - T(t25) / tl));
}

template <typename T>
HD T fth(T tl, T hd, T se, T scale, const Consts& K) {
  return scale /
         (T(1.0) + texp((-hd + se * tl) / (tl * T(K.rgas * 1.0e-3))));
}

template <typename T>
HD T fth25(T hd, T se, const Consts& K) {
  const double t25 = K.tfrz + 25.0;
  return T(1.0) +
         texp(divs(-hd + se * T(t25), K.rgas * 1.0e-3 * t25));
}

// One leaf's photosynthesis (photosynthesis.py:photosynthesis, one canopy
// layer) and its ci solve; returns the leaf's stomatal resistance rs,
// updates the leaf's ci carry where the solve found a positive root and
// adds its secant iterations to `iters`.
template <typename T, int MODE>
HD T leaf(const Column<T>& C, T t_veg, T esat_tv, T eair, T rb, T btran,
          T vcmaxcint, T par_z, T lai_z, T& ci_carry, int& iters) {
  const Consts& K = C.A.K;
  const bool isc3 =
      MODE == kC3 || (MODE == kMixed && C.trait(pC3psn) >= T(0.5));
  const double t25 = K.tfrz + 25.0;

  const T lnc = T(1) / (C.trait(pSlatop) * C.trait(pLeafcn));
  const T act25 = divs(C.trait(pAct25) * T(1000.0), 60.0);
  const T vcmax25top = lnc * C.trait(pFlnr) * C.trait(pFnr) * act25 *
                       C.in(kDaylFactor) * C.trait(pFnitr);
  const T t10c = clamp2(C.in(kT10) - T(K.tfrz), 11.0, 35.0);
  const T jmax25top = (T(2.59) - t10c * T(0.035)) * vcmax25top;
  const T tpu25top = vcmax25top * T(0.167);
  const T kp25top = vcmax25top * T(20000.0);
  const T lmr25top = isc3 ? vcmax25top * T(0.015) : vcmax25top * T(0.025);

  const T nscaler = vcmaxcint;
  const T lmr25 = lmr25top * nscaler;
  // 2 ** ((t_veg - 298.15) / 10)
  const T q10 = pow2(divs(t_veg - T(t25), 10.0));
  T lmr_z;
  if (isc3) {
    const T lmrhd = C.trait(pLmrhd), lmrse = C.trait(pLmrse);
    const T lmrc = fth25(lmrhd, lmrse, K);
    lmr_z = lmr25 * ft(t_veg, C.trait(pLmrha), K) *
            fth(t_veg, lmrhd, lmrse, lmrc, K);
  } else {
    lmr_z = lmr25 * q10 /
            (T(1.0) + texp((t_veg - T(K.tfrz + 55.0)) * T(1.3)));
  }

  const bool day = par_z > T(0);
  const T vcmax25 = vcmax25top * nscaler;
  const T jmax25 = jmax25top * nscaler;
  const T tpu25 = tpu25top * nscaler;
  const T kp25 = kp25top * nscaler;
  const T vcmaxse = T(668.39) - t10c * T(1.07);
  const T jmaxse = T(659.70) - t10c * T(0.75);
  const T tpuse = vcmaxse;
  T vcmax_z, jmax_z, tpu_z, kp_z;
  if (isc3) {
    const T vcmaxhd = C.trait(pVcmaxhd);
    const T vcmaxc = fth25(vcmaxhd, vcmaxse, K);
    vcmax_z = vcmax25 * ft(t_veg, C.trait(pVcmaxha), K) *
              fth(t_veg, vcmaxhd, vcmaxse, vcmaxc, K);
  } else {
    vcmax_z = vcmax25 * q10 /
              (T(1.0) + texp((T(K.tfrz + 15.0) - t_veg) * T(0.2))) /
              (T(1.0) + texp((t_veg - T(K.tfrz + 40.0)) * T(0.3)));
  }
  {
    const T jmaxhd = C.trait(pJmaxhd);
    const T jmaxc = fth25(jmaxhd, jmaxse, K);
    jmax_z = jmax25 * ft(t_veg, C.trait(pJmaxha), K) *
             fth(t_veg, jmaxhd, jmaxse, jmaxc, K);
    const T tpuhd = C.trait(pTpuhd);
    const T tpuc = fth25(tpuhd, tpuse, K);
    tpu_z = tpu25 * ft(t_veg, C.trait(pTpuha), K) *
            fth(t_veg, tpuhd, tpuse, tpuc, K);
  }
  kp_z = kp25 * q10;
  if (!day) vcmax_z = jmax_z = tpu_z = kp_z = T(0);
  vcmax_z = vcmax_z * btran;
  lmr_z = lmr_z * btran;

  const T forc_pbot = C.in(kForcPbot);
  const T cf = forc_pbot / (C.in(kThm) * T(K.rgas * 1.0e-3)) * T(1.e06);
  const T gb = T(1) / rb;
  const T gb_mol = gb * cf;
  const T bbb = nmax(C.trait(pBbbopt) * btran, T(1.0));
  const T kc25 = forc_pbot * T(404.9 / 1.e06);
  const T ko25 = forc_pbot * T(278.4 / 1.e03);
  const T oair = C.in(kForcPo2);
  const T cp25 = divs(oair * T(0.5), K.sco);
  const T kc = kc25 * ft(t_veg, C.trait(pKcha), K);
  const T ko = ko25 * ft(t_veg, C.trait(pKoha), K);
  const T cp = cp25 * ft(t_veg, C.trait(pCpha), K);

  const T rs_night = clamp_max(T(1) / bbb * cf, K.rsmax0);

  const T ceair = nmin(eair, esat_tv);
  const T rh_can = ceair / esat_tv;
  const T qabs = par_z * T(0.5 * (1.0 - K.fnps)) * T(4.6);
  T r1, r2;
  quadratic_roots(T(K.theta_psii), -(qabs + jmax_z), qabs * jmax_z, r1, r2);
  const T je = nmin(r1, r2);

  const T cair = C.in(kForcPco2);
  T ci0 = isc3 ? cair * T(0.7) : cair * T(0.4);
  if (C.A.warm_start && ci_carry > T(0) && isfinite(ci_carry)) ci0 = ci_carry;

  const Env<T> e = {gb_mol, je,   cair,  oair,       lmr_z,
                    par_z,  rh_can, vcmax_z, forc_pbot, cp,
                    kc,     ko,   tpu_z, kp_z,       bbb,
                    C.trait(pQe), C.trait(pThetaCj), C.trait(pMbbopt),
                    C.trait(pC3psn)};
  Out<T> out;
  int it;
  const T ci = solve_leaf<T, MODE>(e, ci0, day, out, it);
  iters += it;
  if (day && ci > T(0)) ci_carry = ci;

  const T gs_mol = (out.an < T(0)) ? bbb : out.gs;
  const T gs = gs_mol / cf;
  const T rs_day = clamp_max(T(1) / ((gs != T(0)) ? gs : T(1.0)), K.rsmax0);
  const T rs_z = day ? rs_day : rs_night;
  const T gscan = lai_z / (rb + rs_z);
  return (lai_z > T(0)) ? lai_z / gscan - rb : T(0);
}

// The column's whole loop, its outputs written.
template <typename T, int MODE>
HD void canopy_column(const Args<T>& A, long long i) {
  const Column<T> C{A, i};
  const Consts& K = A.K;
  const long long n = A.n;
  T ci_sun = A.warm_start && A.ci_prev ? A.ci_prev[i] : T(0);
  T ci_sha = A.warm_start && A.ci_prev ? A.ci_prev[n + i] : T(0);
  int it_sun = 0, it_sha = 0;
  T* const* O = A.out;

  // state at entry to the loop
  T t_veg = C.in(kTVeg), el = C.in(kEl), qsatl = C.in(kQsatl),
    qsatldT = C.in(kQsatldT), taf = C.in(kTaf), qaf = C.in(kQaf),
    um = C.in(kUm), obu = C.in(kObu), delq = C.in(kDelq),
    btran = C.in(kBtran);
  int itlef = 0;

  if (C.in(kFveg) == T(0)) {
    // a bare column never iterates: the plain loop's pass-throughs, zeros
    for (int k = 0; k < kOut; ++k) O[k][i] = T(0);
    O[oBtran][i] = btran;
    O[oEl][i] = el;
    O[oQsatl][i] = qsatl;
    O[oQsatldT][i] = qsatldT;
    O[oTaf][i] = taf;
    O[oQaf][i] = qaf;
    O[oUm][i] = um;
    O[oObu][i] = obu;
    O[oDelq][i] = delq;
    O[oTVeg][i] = t_veg;
    A.itlef[i] = 0;
    A.ci[i] = ci_sun;
    A.ci[n + i] = ci_sha;
    A.psn_iters[i] = 0;
    A.psn_iters[n + i] = 0;
    return;
  }

  // the ground's longwave source: loop invariant
  const int L = A.nlevtot;
  const long long top = static_cast<long long>(A.nlevsno) - A.snl[i];
  const T* tsoi = A.t_soisno + i * static_cast<long long>(L);
  const T t_top_sno = (top >= 0 && top < L) ? tsoi[top] : T(0);
  const T t_top_soil = tsoi[A.nlevsno];
  const T frac_sno = C.in(kFracSno), frac_h2osfc = C.in(kFracH2osfc);
  const T lw_grnd = frac_sno * powk(t_top_sno, 4.0) +
                    (T(1.0) - frac_sno - frac_h2osfc) *
                        powk(t_top_soil, 4.0) +
                    frac_h2osfc * powk(C.in(kTH2osfc), 4.0);

  const bool soybean = A.soybean[i] != 0;
  const T forc_pbot = C.in(kForcPbot), forc_q = C.in(kForcQ),
          forc_th = C.in(kForcTh), zldis = C.in(kZldis), thv = C.in(kThv);
  T del = T(0), efeb = T(0), obuold = T(0);
  int nmozsgn = 0;
  // entry snapshots of the last pass, for the outputs' recompute
  T p_t_veg, p_qsatl, p_qsatldT, p_taf, p_qaf, p_um, p_obu, p_delq, p_efeb,
      p_rssun, p_rssha;

  bool stop = false;
  while (itlef <= 40 && !stop) {
    p_t_veg = t_veg; p_qsatl = qsatl; p_qsatldT = qsatldT; p_taf = taf;
    p_qaf = qaf; p_um = um; p_obu = obu; p_delq = delq; p_efeb = efeb;

    const Chain1<T> c1 = chain1(C, um, obu, taf);
    const T del2 = del;
    const T eah = divs(forc_pbot * qaf, 0.622);

    // the soybean btran boost, sun then shade, as the reference's in-place
    // updates compound it
    T btran_sun = btran, btran_sha = btran;
    if (soybean) {
      btran_sun = clamp_max(btran * T(1.25), 1.0);
      btran_sha = clamp_max(btran_sun * T(1.25), 1.0);
    }
    const T rssun = leaf<T, MODE>(C, t_veg, el, eah, c1.rb, btran_sun,
                                  C.in(kVcmaxcintsun), C.in(kParsunZ),
                                  C.in(kLaisunZ), ci_sun, it_sun);
    const T rssha = leaf<T, MODE>(C, t_veg, el, eah, c1.rb, btran_sha,
                                  C.in(kVcmaxcintsha), C.in(kParshaZ),
                                  C.in(kLaishaZ), ci_sha, it_sha);
    p_rssun = rssun;
    p_rssha = rssha;

    const Chain2<T> c2 = chain2(C, c1, lw_grnd, t_veg, qsatl, qsatldT, qaf,
                                delq, efeb, btran_sha, rssun, rssha);
    const QSat<T> qs = qsat(c2.t_veg_n, forc_pbot, K);

    const T t_grnd = C.in(kTGrnd), thm = C.in(kThm), qg = C.in(kQg);
    const T taf_n = c2.wtg0 * t_grnd + c2.wta0 * thm + c2.wtl0 * c2.t_veg_n;
    const T qaf_n = c2.wtlq0 * qs.qs + c2.wtgq0 * qg + forc_q * c2.wtaq0;
    const T dth = thm - taf_n;
    const T dqh = forc_q - qaf_n;
    const T delq_n = c2.wtalq * qg - c2.wtlq0 * qs.qs - c2.wtaq0 * forc_q;
    const T tstar = c1.temp1 * dth;
    const T qstar = c1.temp2 * dqh;
    const T thvstar = tstar * (T(1.0) + forc_q * T(0.61)) +
                      forc_th * T(0.61) * qstar;
    T zeta = zldis * T(K.vkc) * T(K.grav) * thvstar /
             (c1.ustar * c1.ustar * thv);
    const bool stab = zeta >= T(0);
    zeta = stab ? clamp2(zeta, 0.01, 2.0) : clamp2(zeta, -100.0, -0.01);
    const T wc = powk(nmax(c1.ustar * T(-K.grav) * thvstar * T(1000.0) / thv,
                           T(0)),
                      0.333) *
                 T(1.0);
    const T ur = C.in(kUr);
    const T um_n = stab ? nmax(ur, T(0.1)) : tsqrt(ur * ur + wc * wc);
    T obu_n = zldis / zeta;
    if (obuold * obu_n < T(0)) ++nmozsgn;
    if (nmozsgn >= 4) obu_n = divs(zldis, -0.01);

    ++itlef;
    const bool past_min = itlef > 2;
    const T dele = tabs(c2.efe - efeb);
    const T det = nmax(c2.del, del2);
    stop = past_min && det < T(0.01) && dele < T(0.1);
    if (past_min) efeb = c2.efe;

    t_veg = c2.t_veg_n;
    el = qs.es;
    qsatl = qs.qs;
    qsatldT = qs.qsdT;
    taf = taf_n;
    qaf = qaf_n;
    um = um_n;
    obu = obu_n;
    delq = delq_n;
    btran = btran_sha;
    del = c2.del;
    obuold = obu_n;
  }

  // the outputs, recomputed once from the last pass's entry state
  const Chain1<T> c1 = chain1(C, p_um, p_obu, p_taf);
  const T z0hv = C.in(kZ0hv), z0qv = C.in(kZ0qv);
  const T temp12m = profile_factor(T(2.0) + z0hv, p_obu, z0hv, K);
  const T temp22m = (z0qv == z0hv)
                        ? temp12m
                        : profile_factor(T(2.0) + z0qv, p_obu, z0qv, K);
  const Chain2<T> c2 = chain2(C, c1, lw_grnd, p_t_veg, p_qsatl, p_qsatldT,
                              p_qaf, p_delq, p_efeb, btran, p_rssun, p_rssha);
  O[oBtran][i] = btran;
  O[oQflxTranVeg][i] = c2.qflx_tran_veg;
  O[oQflxEvapVeg][i] = c2.qflx_evap_veg;
  O[oEflxShVeg][i] = c2.eflx_sh_veg;
  O[oWtg][i] = c2.wtg;
  O[oWtl0][i] = c2.wtl0;
  O[oWta0][i] = c2.wta0;
  O[oWtal][i] = c2.wtal;
  O[oEl][i] = el;
  O[oQsatl][i] = qsatl;
  O[oQsatldT][i] = qsatldT;
  O[oTaf][i] = taf;
  O[oQaf][i] = qaf;
  O[oUm][i] = um;
  O[oDth][i] = C.in(kThm) - taf;
  O[oDqh][i] = forc_q - qaf;
  O[oObu][i] = obu;
  O[oTemp1][i] = c1.temp1;
  O[oTemp2][i] = c1.temp2;
  O[oTemp12m][i] = temp12m;
  O[oTemp22m][i] = temp22m;
  O[oTlbef][i] = p_t_veg;
  O[oDelq][i] = delq;
  O[oDtVeg][i] = c2.dt_veg;
  O[oTVeg][i] = t_veg;
  O[oWtgq][i] = c2.wtgq;
  O[oWtalq][i] = c2.wtalq;
  O[oWtlq0][i] = c2.wtlq0;
  O[oWtaq0][i] = c2.wtaq0;
  A.itlef[i] = itlef;
  A.ci[i] = ci_sun;
  A.ci[n + i] = ci_sha;
  A.psn_iters[i] = it_sun;
  A.psn_iters[n + i] = it_sha;
}

template <typename T>
Args<T> make_args(long long n, const void* const* in,
                  const void* const* traits, const void* t_soisno,
                  int nlevtot, int nlevsno, const void* snl,
                  const void* soybean, const void* ci_prev, int warm_start,
                  double dtime, const double* consts, void* const* out,
                  void* itlef, void* ci, void* psn_iters) {
  Args<T> A;
  A.n = n;
  for (int k = 0; k < kIn; ++k) A.in[k] = static_cast<const T*>(in[k]);
  for (int k = 0; k < kTraits; ++k)
    A.traits[k] = static_cast<const T*>(traits[k]);
  A.t_soisno = static_cast<const T*>(t_soisno);
  A.nlevtot = nlevtot;
  A.nlevsno = nlevsno;
  A.snl = static_cast<const int*>(snl);
  A.soybean = static_cast<const unsigned char*>(soybean);
  A.ci_prev = static_cast<const T*>(ci_prev);
  A.warm_start = warm_start != 0;
  A.dtime = dtime;
  double* k = reinterpret_cast<double*>(&A.K);
  for (int j = 0; j < kConsts; ++j) k[j] = consts[j];
  for (int j = 0; j < kOut; ++j) A.out[j] = static_cast<T*>(out[j]);
  A.itlef = static_cast<int*>(itlef);
  A.ci = static_cast<T*>(ci);
  A.psn_iters = static_cast<int*>(psn_iters);
  return A;
}

#ifdef __CUDACC__

template <typename T, int MODE>
__global__ void canopy_kernel(const Args<T> A) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < A.n) canopy_column<T, MODE>(A, i);
}

constexpr int kThreads = 128;

template <typename T>
int launch(int mode, const Args<T>& A, cudaStream_t s) {
  if (A.n <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((A.n + kThreads - 1) / kThreads);
  switch (mode) {
    case kC3:
      canopy_kernel<T, kC3><<<blocks, kThreads, 0, s>>>(A);
      break;
    case kC4:
      canopy_kernel<T, kC4><<<blocks, kThreads, 0, s>>>(A);
      break;
    case kMixed:
      canopy_kernel<T, kMixed><<<blocks, kThreads, 0, s>>>(A);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// in: kIn [n] pointers (IN_FIELDS order); traits: kTraits [n] pointers
// (PFTPsnParams order); t_soisno [n, nlevtot]; snl int32 [n]; soybean
// uint8 [n]; ci_prev [2n] or null; consts: kConsts doubles (CONSTS order);
// out: kOut [n] pointers (StabilityOut's floating fields); itlef int32
// [n], ci [2n], psn_iters int32 [2n].  mode: 0 c3, 1 c4, 2 mixed.
// Launches on `stream`; returns cudaGetLastError().
#define CANOPY_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(int mode, long long n, const void* const* in,          \
                      const void* const* traits, const void* t_soisno,       \
                      int nlevtot, int nlevsno, const void* snl,             \
                      const void* soybean, const void* ci_prev,              \
                      int warm_start, double dtime, const double* consts,    \
                      void* const* out, void* itlef, void* ci,               \
                      void* psn_iters, void* stream) {                       \
    const Args<T> A = make_args<T>(n, in, traits, t_soisno, nlevtot,          \
                                   nlevsno, snl, soybean, ci_prev,           \
                                   warm_start, dtime, consts, out, itlef,    \
                                   ci, psn_iters);                           \
    return launch<T>(mode, A, static_cast<cudaStream_t>(stream));            \
  }
CANOPY_ENTRY(canopy_stability_f64, double)
CANOPY_ENTRY(canopy_stability_f32, float)
#undef CANOPY_ENTRY

#endif  // __CUDACC__
