// K2: the canopy stability loop, with the ci solve of both leaves inlined,
// as a resumable per-column machine on a persistent grid whose lanes take a
// new column as soon as theirs ends.
//
// Replaces: elmkernels_tpu/physics/canopy_fluxes.py:stability_iteration
// (line 199), whose masked lax.while_loop (line 506) the port ran as a
// Python while over the batch (physics/canopy_fluxes.py:
// stability_iteration_plain): about a thousand launches and one host wait
// an iteration, up to 41 iterations a step.  Reference:
// canopy_fluxes_impl.hh:185-452.
//
// A column runs its sequence of the masked loop to its own end: at most 41
// passes (itlef from 0 while itlef <= 40), each the aerodynamic chain
// (friction velocity and resistances), photosynthesis of the sun and the
// shade leaf (per-leaf set-up, then the ci solve of ci_leaf.cuh), the flux
// chain (damping of an oscillating latent heat, the leaf-temperature Newton
// step, the 1 K step limit), qsat, the Monin-Obukhov update with its
// sign-flip counter and the dual convergence test; the outputs are the
// last pass's.  A bare column (frac_veg_nosno == 0) never iterates: zeros
// and pass-throughs, as in the plain loop.
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
// - x ** 2.0 and x ** 3.0 are products, other powers pow: in float64
//   compiled apart with contraction on as PyTorch's kernels are
//   (canopy_pow.cu), in float32 inline (float pow rounds alike either
//   way); clamp, minimum and maximum propagate NaN (nmin, nmax);
// - a clamp's bound is rounded to T: clamp(min=1e-300) is a clamp at 0 in
//   float.
// The constants that Python computes with its own math library (the
// profile functions' values at the transition points) come from the caller
// (Consts), so both sides use the same bits.  A value the plain loop
// computes more than once from the same operands is computed once here,
// with the same operations, and so are the same bits: the sun and the shade
// leaf's temperature responses (the same t_veg, the same traits); what
// every pass of a column computes alike (ColumnConsts: the canopy's wind
// weight, the leaf size's square root, the high-temperature constants of
// the leaf rates); and the outputs, which the plain loop recomputes from
// the last pass's entry state and which are that pass's.  The profile
// functions take the log that begins each of their branches once, of the
// lane's own argument, so a warp whose lanes sit in different stability
// regimes runs one log, not one a branch.
//
// Schedule.  Run one thread a column to its end, a warp would last as long
// as its slowest column (tree columns at the 41-pass cap beside grass
// columns done in ~4) and each pass as long as its slowest leaf solve (2-60
// evaluations), with ~250 registers a thread (8 warps an SM).  So
// (canopy_kernel, below):
// - Warps claim chunks of 32 consecutive columns from a counter (one
//   atomicAdd a chunk) and hand them out in order to the lanes that have no
//   column; a lane whose column stops (converged, at the cap, or bare)
//   takes the next one before the warp's next step.
// - A step is one pass of every lane's column: its head (the aerodynamic
//   chain and both leaves' set-up), the leaves' ci evaluations, its tail
//   (the flux chain, qsat, the Monin-Obukhov update and the convergence
//   test).  The two leaves' solves run as one sequence of evaluations a
//   lane (the sun leaf's, then the shade leaf's, by the machine of
//   ci_leaf.cuh), so a warp's pass lasts its longest lane's sun + shade
//   evaluations, not the longest sun solve plus the longest shade solve.
//   A finer step (one evaluation, as in K1-T) would let lanes sit in
//   different phases of a pass, and a warp would then run a pass's head
//   and tail (~6-10 evaluations' worth of divisions and transcendentals)
//   in almost every step.  Going back to the heads and tails once fewer
//   than 8 lanes still evaluate measured 10-28 % slower on every input
//   tried (PERF.md), so a round's evaluations run until none is left.
// - What a column carries from pass to pass (its state, its constants, the
//   ci carry, the counts), and what a pass hands from one phase to the
//   next (the aerodynamic chain's resistances, the leaves' ci_func inputs,
//   their stomatal resistances), lives in shared memory in the lane's
//   column of its warp's [slot][lane] arrays (Lanes), not in registers:
//   each phase holds only its own temporaries.  13,824 B a warp in
//   float64, 7,168 B in float32.  The kernel is bound by latency, so it
//   asks for as many warps as shared memory allows: 24 an SM in float32
//   (80 registers a thread), 16 in float64 (128).
// - Inputs are read from device memory where they are used, by read-only
//   loads that the compiler may schedule past the lane's stores to shared
//   memory; they are not staged.  A warp's lanes sit on at most two chunks
//   (a 64-column window).  Measured on the test problems (PERF.md): a
//   second read of every input from L2 adds 17-43 % to a launch, and about
//   as much (16-42 %) to a schedule without refill, whose lanes read 32
//   consecutive columns and which runs 1.3-1.5x slower: the refilled
//   lanes' pattern makes a read no dearer.  What the reads cost bounds
//   what staging could win; staging a chunk's ~330-660 B a column in
//   shared memory (21-42 KB a warp, double-buffered) would cost warps that
//   hide the latency the kernel is bound by, and is not tried.
// - The grid is persistent: the resident blocks of 4 warps an SM
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor, cached per device) on
//   every SM, or fewer for a small batch.  The chunk counter and the lane
//   counters (below) are the launch's own, handed in by the caller (the
//   wrapper takes them from PyTorch's caching allocator on the launch's
//   stream) and zeroed by cudaMemsetAsync on that stream: a launch waits on
//   nothing and allocates nothing itself, so it can be captured in a CUDA
//   graph, and launches on two streams, or a graph's replay beside an
//   eager launch, count apart.
// - Each column's outputs are written once, by the lane that ran it, and
//   its sequence of operations is the same whatever the schedule: two
//   launches on the same inputs give the same bits.
// What bounds it: its operations (chains of dependent IEEE divisions,
// square roots and transcendentals a pass), and their latency, not its
// bytes (PERF.md, K2's row: registers, spills, resident warps and the
// lanes' use of every instantiation, from chip_smoke.py's K2 phase).
//
// The same source built by a host compiler (the device code is HD inline
// functions; the kernel and its launch sit under __CUDACC__) is what the
// CPU tests run: column_begin, pass_head, leaf_step and pass_tail, below,
// driven one column at a time and on a simulated warp whose lanes take
// columns in a random order.

#include "ci_leaf.cuh"

#ifdef __CUDACC__
// canopy_pow.cu: double pow compiled with contracted multiply-adds, as
// PyTorch's kernels compute x ** p (see there)
extern __device__ double canopy_pow(double x, double p);
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
  // per-column inputs and traits: element k of column i is at
  // [i * stride]; a stride of 0 gives every column one value (a 0-d
  // tensor), a row's length layer 0 of a [n, nlevcan] input
  const T* in[kIn];
  long long in_stride[kIn];
  const T* traits[kTraits];
  long long trait_stride[kTraits];
  const T* t_soisno;     // [n, nlevtot]
  int nlevtot, nlevsno;
  const int* snl;        // [n]
  const unsigned char* soybean;  // [n], or one value (stride 0)
  long long soybean_stride;
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
// float pow rounds alike with and without contraction, so it is compiled
// here, inline: no call, and its registers are the kernel's to allocate
HD float tpow(float x, float p) { return powf(x, p); }
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

// The plain version's four branches of the profile functions, tested in its
// order (a NaN zeta takes the last).  Each branch begins with a log of its
// own argument: the log is taken once, of the lane's argument, so that a
// warp whose lanes sit in different branches runs one log, not one a
// branch; likewise the unstable branches' stability function of z0 / obu.
template <typename T>
HD int profile_branch(T zeta, double zeta_m) {
  return zeta < T(-zeta_m) ? 0 : zeta < T(0) ? 1 : zeta <= T(1.0) ? 2 : 3;
}

template <typename T>
HD T friction_velocity_wind(T hgt_u, T displa, T um, T obu, T z0m,
                            const Consts& K) {
  const T zldis = hgt_u - displa;
  const T zeta = zldis / obu;
  const T vkc_um = um * T(K.vkc);
  const int br = profile_branch(zeta, K.zetam);
  const T lg = safe_log(br == 0   ? obu * T(-K.zetam) / z0m
                        : br == 3 ? obu / z0m
                                  : zldis / z0m);
  T den;
  if (br <= 1) {
    const T s0 = stability_func1(z0m / obu, K);
    den = br == 0 ? lg - T(K.psi_m_zetam) + s0 +
                        (safe_npow(-zeta, 0.333) - T(K.zetam_p333)) * T(1.14)
                  : lg - stability_func1(zeta, K) + s0;
  } else {
    const T z5 = z0m * T(5.0) / obu;
    den = br == 2 ? lg + zeta * T(5.0) - z5
                  : lg + T(5.0) - z5 +
                        (safe_log(zeta) * T(5.0) + zeta - T(1.0));
  }
  return vkc_um / den;
}

template <typename T>
HD T profile_factor(T zldis, T obu, T z0, const Consts& K) {
  const T zeta = zldis / obu;
  const int br = profile_branch(zeta, K.zetat);
  const T lg = safe_log(br == 0   ? obu * T(-K.zetat) / z0
                        : br == 3 ? obu / z0
                                  : zldis / z0);
  T den;
  if (br <= 1) {
    const T s0 = stability_func2(z0 / obu);
    den = br == 0 ? lg - T(K.psi_h_zetat) + s0 +
                        (T(K.zetat_m333) - safe_npow(-zeta, -0.333)) * T(0.8)
                  : lg - stability_func2(zeta) + s0;
  } else {
    const T z5 = z0 * T(5.0) / obu;
    den = br == 2 ? lg + zeta * T(5.0) - z5
                  : lg + T(5.0) - z5 +
                        (safe_log(zeta) * T(5.0) + zeta - T(1.0));
  }
  return T(K.vkc) / den;
}

// ---- one column -----------------------------------------------------------

// a read-only load (the non-coherent path on the card, which the compiler
// may move past the lane's stores to shared memory)
template <typename T>
HD T load(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

template <typename T>
struct Column {
  const Args<T>& A;
  long long i;
  HD T in(int k) const { return load(&A.in[k][i * A.in_stride[k]]); }
  HD T trait(int k) const {
    return load(&A.traits[k][i * A.trait_stride[k]]);
  }
  HD bool soybean() const {
    return A.soybean[i * A.soybean_stride] != 0;
  }
};

// What the passes of a column compute alike, computed once (column_consts)
// with the same operations: the wind-sheltering weight of the canopy, the
// square root of the leaf dimension, the numerator of the snow-free
// leaves' resistance under the canopy, and the high-temperature constants
// of the leaves' maintenance respiration, vcmax, jmax and tpu (fth25).
template <typename T>
struct ColumnConsts {
  T w, sqrt_dleaf, rdl_num, lmrc, vcmaxc, jmaxc, tpuc;
};

// the aerodynamic chain of one pass from its entry (um, obu, taf)
template <typename T>
struct Chain1 {
  T ustar, temp1, temp2, rah0, raw0, rb, uaf, rah1, raw1;
};

template <typename T>
HD Chain1<T> chain1(const Column<T>& C, const ColumnConsts<T>& Q, T um, T obu,
                    T taf) {
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
  const T cf_leaf = T(0.01) / (tsqrt(r.uaf) * Q.sqrt_dleaf);
  r.rb = T(1) / (cf_leaf * r.uaf);

  const T w = Q.w;
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
HD Chain2<T> chain2(const Column<T>& C, const ColumnConsts<T>& Q,
                    const Chain1<T>& c1, T lw_grnd,
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
  const T rdl = Q.rdl_num / (c1.uaf * T(0.004));
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

// ---- a lane's slots --------------------------------------------------------

// What a column carries from pass to pass, and what a pass hands from one
// phase to the next, in the lane's column of its warp's [slot][lane]
// arrays (Lanes: shared memory on the card).
enum {
  // the column's state: the next pass's entry values
  sTVeg, sEl, sQsatl, sQsatldT, sTaf, sQaf, sUm, sObu, sDelq, sBtran, sDel,
  sEfeb, sObuold, sLwGrnd,
  // the column's constants (ColumnConsts), and cf
  sW, sSqrtDleaf, sRdlNum, sLmrc, sVcmaxc, sJmaxc, sTpuc, sCf,
  // the pass's aerodynamic chain (Chain1)
  sUstar, sTemp1, sTemp2, sRah0, sRaw0, sRb, sUaf, sRah1, sRaw1,
  // the leaves' common photosynthesis inputs
  sGbMol, sRhCan, sCp, sKc, sKo,
  sLeaves  // then kLeafSlots a leaf, the sun leaf's first
};
// a leaf's: its ci carry, the ci_func inputs computed for it, and its
// stomatal resistance of the pass
enum { lCi, lJe, lLmrZ, lVcmaxZ, lTpuZ, lKpZ, lBbb, lRs, kLeafSlots };
constexpr int kSlots = sLeaves + 2 * kLeafSlots;
// the counts: passes, Monin-Obukhov sign flips, each leaf's secant
// iterations
enum { iItlef, iNmozsgn, iIters, kIntSlots = iIters + 2 };

template <typename T>
struct Lanes {
  T v[kSlots][kLanes];
  int k[kIntSlots][kLanes];
};

// one lane's slots
template <typename T>
struct Lane {
  Lanes<T>& L;
  int l;
  HD T& operator[](int s) const { return L.v[s][l]; }
  HD T& leaf(int lf, int s) const {
    return L.v[sLeaves + lf * kLeafSlots + s][l];
  }
  HD int& count(int s) const { return L.k[s][l]; }
};

template <typename T>
HD void store_chain1(const Lane<T>& S, const Chain1<T>& c) {
  S[sUstar] = c.ustar;
  S[sTemp1] = c.temp1;
  S[sTemp2] = c.temp2;
  S[sRah0] = c.rah0;
  S[sRaw0] = c.raw0;
  S[sRb] = c.rb;
  S[sUaf] = c.uaf;
  S[sRah1] = c.rah1;
  S[sRaw1] = c.raw1;
}

template <typename T>
HD Chain1<T> load_chain1(const Lane<T>& S) {
  Chain1<T> c;
  c.ustar = S[sUstar];
  c.temp1 = S[sTemp1];
  c.temp2 = S[sTemp2];
  c.rah0 = S[sRah0];
  c.raw0 = S[sRaw0];
  c.rb = S[sRb];
  c.uaf = S[sUaf];
  c.rah1 = S[sRah1];
  c.raw1 = S[sRaw1];
  return c;
}

// the soybean btran boost, sun then shade, as the reference's in-place
// updates compound it
template <typename T>
HD void leaf_btran(T btran, bool soybean, T& sun, T& sha) {
  sun = sha = btran;
  if (soybean) {
    sun = clamp_max(btran * T(1.25), 1.0);
    sha = clamp_max(sun * T(1.25), 1.0);
  }
}

template <typename T>
HD ColumnConsts<T> load_consts(const Lane<T>& S) {
  return {S[sW], S[sSqrtDleaf], S[sRdlNum], S[sLmrc], S[sVcmaxc], S[sJmaxc],
          S[sTpuc]};
}

// Column C's constants (ColumnConsts) and cf to the lane's slots.
template <typename T, int MODE>
HD void column_consts(const Column<T>& C, const Lane<T>& S) {
  const Consts& K = C.A.K;
  S[sW] = texp(-(C.in(kElai) + C.in(kEsai)));
  S[sSqrtDleaf] = tsqrt(C.trait(pDleaf));
  const T fsno_dl = divs(C.in(kSnowDepth), 0.05);
  const T elai_dl = (T(1.0) - clamp_max(fsno_dl, 1.0)) * T(0.5);
  S[sRdlNum] = T(1.0) - texp(-elai_dl);
  const bool isc3 =
      MODE == kC3 || (MODE == kMixed && C.trait(pC3psn) >= T(0.5));
  const T t10c = clamp2(C.in(kT10) - T(K.tfrz), 11.0, 35.0);
  const T vcmaxse = T(668.39) - t10c * T(1.07);
  const T jmaxse = T(659.70) - t10c * T(0.75);
  const T tpuse = vcmaxse;
  if (isc3) {
    S[sLmrc] = fth25(C.trait(pLmrhd), C.trait(pLmrse), K);
    S[sVcmaxc] = fth25(C.trait(pVcmaxhd), vcmaxse, K);
  }
  S[sJmaxc] = fth25(C.trait(pJmaxhd), jmaxse, K);
  S[sTpuc] = fth25(C.trait(pTpuhd), tpuse, K);
  S[sCf] = C.in(kForcPbot) / (C.in(kThm) * T(K.rgas * 1.0e-3)) * T(1.e06);
}

// ---- photosynthesis -------------------------------------------------------

// Both leaves' inputs to the ci solve (photosynthesis.py:photosynthesis,
// one canopy layer) for a pass: the common ones, then each leaf's, to the
// lane's slots.  The temperature responses at t_veg are computed once for
// both leaves: lmr_z is (lmr25 * lmr_a) * lmr_b in C3 and
// (lmr25 * lmr_a) / lmr_b in C4, vcmax_z likewise (/ vc_b / vc_c in C4),
// each operation the plain version's.
template <typename T, int MODE>
HD void leaves_setup(const Column<T>& C, const Lane<T>& S, T t_veg,
                     T esat_tv, T eair, T rb, T btran_sun, T btran_sha) {
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

  // 2 ** ((t_veg - 298.15) / 10)
  const T q10 = pow2(divs(t_veg - T(t25), 10.0));
  T lmr_a, lmr_b, vc_a, vc_b, vc_c = T(1);
  if (isc3) {
    lmr_a = ft(t_veg, C.trait(pLmrha), K);
    lmr_b = fth(t_veg, C.trait(pLmrhd), C.trait(pLmrse), S[sLmrc], K);
  } else {
    lmr_a = q10;
    lmr_b = T(1.0) + texp((t_veg - T(K.tfrz + 55.0)) * T(1.3));
  }
  const T vcmaxse = T(668.39) - t10c * T(1.07);
  const T jmaxse = T(659.70) - t10c * T(0.75);
  const T tpuse = vcmaxse;
  if (isc3) {
    vc_a = ft(t_veg, C.trait(pVcmaxha), K);
    vc_b = fth(t_veg, C.trait(pVcmaxhd), vcmaxse, S[sVcmaxc], K);
  } else {
    vc_a = q10;
    vc_b = T(1.0) + texp((T(K.tfrz + 15.0) - t_veg) * T(0.2));
    vc_c = T(1.0) + texp((t_veg - T(K.tfrz + 40.0)) * T(0.3));
  }
  const T jmax_a = ft(t_veg, C.trait(pJmaxha), K);
  const T jmax_b = fth(t_veg, C.trait(pJmaxhd), jmaxse, S[sJmaxc], K);
  const T tpu_a = ft(t_veg, C.trait(pTpuha), K);
  const T tpu_b = fth(t_veg, C.trait(pTpuhd), tpuse, S[sTpuc], K);

  const T forc_pbot = C.in(kForcPbot);
  const T gb = T(1) / rb;
  S[sGbMol] = gb * S[sCf];
  const T kc25 = forc_pbot * T(404.9 / 1.e06);
  const T ko25 = forc_pbot * T(278.4 / 1.e03);
  const T cp25 = divs(C.in(kForcPo2) * T(0.5), K.sco);
  S[sKc] = kc25 * ft(t_veg, C.trait(pKcha), K);
  S[sKo] = ko25 * ft(t_veg, C.trait(pKoha), K);
  S[sCp] = cp25 * ft(t_veg, C.trait(pCpha), K);
  const T ceair = nmin(eair, esat_tv);
  S[sRhCan] = ceair / esat_tv;

#pragma unroll 1
  for (int lf = 0; lf < 2; ++lf) {
    const T nscaler = lf ? C.in(kVcmaxcintsha) : C.in(kVcmaxcintsun);
    const T par_z = lf ? C.in(kParshaZ) : C.in(kParsunZ);
    const T btran = lf ? btran_sha : btran_sun;
    const bool day = par_z > T(0);
    T lmr_z = lmr25top * nscaler * lmr_a;
    lmr_z = isc3 ? lmr_z * lmr_b : lmr_z / lmr_b;
    T vcmax_z = vcmax25top * nscaler * vc_a;
    vcmax_z = isc3 ? vcmax_z * vc_b : vcmax_z / vc_b / vc_c;
    T jmax_z = jmax25top * nscaler * jmax_a * jmax_b;
    T tpu_z = tpu25top * nscaler * tpu_a * tpu_b;
    T kp_z = kp25top * nscaler * q10;
    if (!day) vcmax_z = jmax_z = tpu_z = kp_z = T(0);
    S.leaf(lf, lVcmaxZ) = vcmax_z * btran;
    S.leaf(lf, lLmrZ) = lmr_z * btran;
    S.leaf(lf, lTpuZ) = tpu_z;
    S.leaf(lf, lKpZ) = kp_z;
    S.leaf(lf, lBbb) = nmax(C.trait(pBbbopt) * btran, T(1.0));
    const T qabs = par_z * T(0.5 * (1.0 - K.fnps)) * T(4.6);
    T r1, r2;
    quadratic_roots(T(K.theta_psii), -(qabs + jmax_z), qabs * jmax_z, r1,
                    r2);
    S.leaf(lf, lJe) = nmin(r1, r2);
  }
}

// Leaf lf's ci_func inputs: those computed for the pass where they lie in
// the lane's slots, the column's inputs and traits as values.
template <typename T>
struct LeafEnv {
  const T& gb_mol;
  const T& je;
  T cair, oair;
  const T& lmr_z;
  T par_z;
  const T& rh_can;
  const T& vcmax_z;
  T forc_pbot;
  const T &cp, &kc, &ko, &tpu_z, &kp_z, &bbb;
  T qe, theta_cj, mbbopt, c3frac;
};

template <typename T>
HD LeafEnv<T> leaf_env(const Column<T>& C, const Lane<T>& S, int lf) {
  return {S[sGbMol],          S.leaf(lf, lJe),
          C.in(kForcPco2),    C.in(kForcPo2),
          S.leaf(lf, lLmrZ),  lf ? C.in(kParshaZ) : C.in(kParsunZ),
          S[sRhCan],          S.leaf(lf, lVcmaxZ),
          C.in(kForcPbot),    S[sCp],
          S[sKc],             S[sKo],
          S.leaf(lf, lTpuZ),  S.leaf(lf, lKpZ),
          S.leaf(lf, lBbb),   C.trait(pQe),
          C.trait(pThetaCj),  C.trait(pMbbopt),
          C.trait(pC3psn)};
}

// A lane's leaf solve inside a pass: the leaf being solved (0 sun, 1
// shade, 2 none left), its machine, and the an of its last evaluation.
template <typename T>
struct Solve {
  Leaf<T> s;
  T an;
  int leaf;
};

// Leaf lf's solve ended at ci, its last evaluation's gs_mol and an (0 for
// a night leaf) and `it` secant iterations: its stomatal resistance for
// the pass, its ci carry where the solve found a positive root, its count.
template <typename T>
HD void leaf_finish(const Column<T>& C, const Lane<T>& S, int lf, bool day,
                    T ci, T gs, T an, int it) {
  const Consts& K = C.A.K;
  const T bbb = S.leaf(lf, lBbb), cf = S[sCf], rb = S[sRb];
  const T gs_mol = (an < T(0)) ? bbb : gs;
  const T gsv = gs_mol / cf;
  const T rs_day =
      clamp_max(T(1) / ((gsv != T(0)) ? gsv : T(1.0)), K.rsmax0);
  const T rs_night = clamp_max(T(1) / bbb * cf, K.rsmax0);
  const T rs_z = day ? rs_day : rs_night;
  const T lai_z = lf ? C.in(kLaishaZ) : C.in(kLaisunZ);
  const T gscan = lai_z / (rb + rs_z);
  S.leaf(lf, lRs) = (lai_z > T(0)) ? lai_z / gscan - rb : T(0);
  S.count(iIters + lf) += it;
  if (day && ci > T(0)) S.leaf(lf, lCi) = ci;
}

// Starts leaf lf's solve, and the next leaf's where one needs no
// evaluation (a night leaf): the leaf now being solved, 2 if none is left.
template <typename T, int MODE>
HD int leaf_start(const Column<T>& C, const Lane<T>& S, Solve<T>& sv,
                  int lf) {
  const bool isc3 =
      MODE == kC3 || (MODE == kMixed && C.trait(pC3psn) >= T(0.5));
  for (; lf < 2; ++lf) {
    const bool day = (lf ? C.in(kParshaZ) : C.in(kParsunZ)) > T(0);
    const T cair = C.in(kForcPco2);
    T ci0 = isc3 ? cair * T(0.7) : cair * T(0.4);
    const T carry = S.leaf(lf, lCi);
    if (C.A.warm_start && carry > T(0) && isfinite(carry)) ci0 = carry;
    T xfin;
    if (leaf_begin(sv.s, ci0, day, xfin)) {
      sv.an = T(0);
      return lf;
    }
    leaf_finish(C, S, lf, day, xfin, T(0), T(0), 0);
  }
  return 2;
}

// ---- the machine -----------------------------------------------------------

// Takes column C: false if it is bare (its outputs written), else its
// state set for the first pass and its constants computed.
template <typename T, int MODE>
HD bool column_begin(const Column<T>& C, const Lane<T>& S) {
  const Args<T>& A = C.A;
  const long long i = C.i, n = A.n;
  T* const* O = A.out;
  const T ci_sun = A.warm_start && A.ci_prev ? A.ci_prev[i] : T(0);
  const T ci_sha = A.warm_start && A.ci_prev ? A.ci_prev[n + i] : T(0);
  if (C.in(kFveg) == T(0)) {
    // a bare column never iterates: the plain loop's pass-throughs, zeros
    for (int k = 0; k < kOut; ++k) O[k][i] = T(0);
    O[oBtran][i] = C.in(kBtran);
    O[oEl][i] = C.in(kEl);
    O[oQsatl][i] = C.in(kQsatl);
    O[oQsatldT][i] = C.in(kQsatldT);
    O[oTaf][i] = C.in(kTaf);
    O[oQaf][i] = C.in(kQaf);
    O[oUm][i] = C.in(kUm);
    O[oObu][i] = C.in(kObu);
    O[oDelq][i] = C.in(kDelq);
    O[oTVeg][i] = C.in(kTVeg);
    A.itlef[i] = 0;
    A.ci[i] = ci_sun;
    A.ci[n + i] = ci_sha;
    A.psn_iters[i] = 0;
    A.psn_iters[n + i] = 0;
    return false;
  }
  // the ground's longwave source: loop invariant
  const int L = A.nlevtot;
  const long long top = static_cast<long long>(A.nlevsno) - A.snl[i];
  const T* tsoi = A.t_soisno + i * static_cast<long long>(L);
  const T t_top_sno = (top >= 0 && top < L) ? tsoi[top] : T(0);
  const T t_top_soil = tsoi[A.nlevsno];
  const T frac_sno = C.in(kFracSno), frac_h2osfc = C.in(kFracH2osfc);
  S[sLwGrnd] = frac_sno * powk(t_top_sno, 4.0) +
               (T(1.0) - frac_sno - frac_h2osfc) * powk(t_top_soil, 4.0) +
               frac_h2osfc * powk(C.in(kTH2osfc), 4.0);
  S[sTVeg] = C.in(kTVeg);
  S[sEl] = C.in(kEl);
  S[sQsatl] = C.in(kQsatl);
  S[sQsatldT] = C.in(kQsatldT);
  S[sTaf] = C.in(kTaf);
  S[sQaf] = C.in(kQaf);
  S[sUm] = C.in(kUm);
  S[sObu] = C.in(kObu);
  S[sDelq] = C.in(kDelq);
  S[sBtran] = C.in(kBtran);
  S[sDel] = S[sEfeb] = S[sObuold] = T(0);
  column_consts<T, MODE>(C, S);
  S.leaf(0, lCi) = ci_sun;
  S.leaf(1, lCi) = ci_sha;
  S.count(iItlef) = S.count(iNmozsgn) = 0;
  S.count(iIters) = S.count(iIters + 1) = 0;
  return true;
}

// A pass's head: the aerodynamic chain and both leaves' set-up; the sun
// leaf's solve started (sv.leaf: the leaf to evaluate, 2 if neither needs
// an evaluation).
template <typename T, int MODE>
HD void pass_head(const Column<T>& C, const Lane<T>& S, Solve<T>& sv) {
  const Chain1<T> c1 = chain1(C, load_consts(S), S[sUm], S[sObu], S[sTaf]);
  store_chain1(S, c1);
  const T eah = divs(C.in(kForcPbot) * S[sQaf], 0.622);
  T btran_sun, btran_sha;
  leaf_btran(S[sBtran], C.soybean(), btran_sun, btran_sha);
  leaves_setup<T, MODE>(C, S, S[sTVeg], S[sEl], eah, c1.rb, btran_sun,
                        btran_sha);
  sv.leaf = leaf_start<T, MODE>(C, S, sv, 0);
}

// One ci evaluation of the leaf being solved; when its solve ends, the
// leaf is finished and the next one started (sv.leaf: 2 once both are).
template <typename T, int MODE>
HD void leaf_step(const Column<T>& C, const Lane<T>& S, Solve<T>& sv) {
  const int lf = sv.leaf;
  Out<T> o;
  o.gs = sv.s.gs;
  const T f = ci_func<T, MODE>(leaf_point(sv.s), o, leaf_env(C, S, lf));
  sv.s.gs = o.gs;
  sv.an = o.an;
  T xfin;
  if (leaf_after(sv.s, f, xfin)) return;
  leaf_finish(C, S, lf, true, xfin, sv.s.gs, sv.an, sv.s.it);
  sv.leaf = leaf_start<T, MODE>(C, S, sv, lf + 1);
}

// A pass's tail: the flux chain, qsat, the Monin-Obukhov update and the
// convergence test.  True if the column stops (converged or at the cap),
// its outputs written; else its state set for the next pass.
template <typename T, int MODE>
HD bool pass_tail(const Column<T>& C, const Lane<T>& S) {
  const Args<T>& A = C.A;
  const Consts& K = A.K;
  const long long i = C.i, n = A.n;
  const T t_veg = S[sTVeg], qsatl = S[sQsatl], qsatldT = S[sQsatldT],
          qaf = S[sQaf], delq = S[sDelq], efeb = S[sEfeb], obu = S[sObu];
  T btran_sun, btran_sha;
  leaf_btran(S[sBtran], C.soybean(), btran_sun, btran_sha);
  const Chain1<T> c1 = load_chain1(S);
  const Chain2<T> c2 =
      chain2(C, load_consts(S), c1, S[sLwGrnd], t_veg, qsatl, qsatldT, qaf,
             delq, efeb, btran_sha, S.leaf(0, lRs), S.leaf(1, lRs));
  const T forc_pbot = C.in(kForcPbot), forc_q = C.in(kForcQ),
          forc_th = C.in(kForcTh), zldis = C.in(kZldis), thv = C.in(kThv);
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
  int nmozsgn = S.count(iNmozsgn);
  if (S[sObuold] * obu_n < T(0)) ++nmozsgn;
  if (nmozsgn >= 4) obu_n = divs(zldis, -0.01);

  const int itlef = S.count(iItlef) + 1;
  const bool past_min = itlef > 2;
  const T dele = tabs(c2.efe - efeb);
  const T det = nmax(c2.del, S[sDel]);
  const bool stop = past_min && det < T(0.01) && dele < T(0.1);
  if (!stop && itlef <= 40) {
    S[sTVeg] = c2.t_veg_n;
    S[sEl] = qs.es;
    S[sQsatl] = qs.qs;
    S[sQsatldT] = qs.qsdT;
    S[sTaf] = taf_n;
    S[sQaf] = qaf_n;
    S[sUm] = um_n;
    S[sObu] = obu_n;
    S[sDelq] = delq_n;
    S[sBtran] = btran_sha;
    S[sDel] = c2.del;
    if (past_min) S[sEfeb] = c2.efe;
    S[sObuold] = obu_n;
    S.count(iNmozsgn) = nmozsgn;
    S.count(iItlef) = itlef;
    return false;
  }

  // the outputs: the last pass's (what the plain loop recomputes from its
  // entry state)
  const T z0hv = C.in(kZ0hv), z0qv = C.in(kZ0qv);
  const T temp12m = profile_factor(T(2.0) + z0hv, obu, z0hv, K);
  const T temp22m = (z0qv == z0hv)
                        ? temp12m
                        : profile_factor(T(2.0) + z0qv, obu, z0qv, K);
  T* const* O = A.out;
  O[oBtran][i] = btran_sha;
  O[oQflxTranVeg][i] = c2.qflx_tran_veg;
  O[oQflxEvapVeg][i] = c2.qflx_evap_veg;
  O[oEflxShVeg][i] = c2.eflx_sh_veg;
  O[oWtg][i] = c2.wtg;
  O[oWtl0][i] = c2.wtl0;
  O[oWta0][i] = c2.wta0;
  O[oWtal][i] = c2.wtal;
  O[oEl][i] = qs.es;
  O[oQsatl][i] = qs.qs;
  O[oQsatldT][i] = qs.qsdT;
  O[oTaf][i] = taf_n;
  O[oQaf][i] = qaf_n;
  O[oUm][i] = um_n;
  O[oDth][i] = dth;
  O[oDqh][i] = dqh;
  O[oObu][i] = obu_n;
  O[oTemp1][i] = c1.temp1;
  O[oTemp2][i] = c1.temp2;
  O[oTemp12m][i] = temp12m;
  O[oTemp22m][i] = temp22m;
  O[oTlbef][i] = t_veg;
  O[oDelq][i] = delq_n;
  O[oDtVeg][i] = c2.dt_veg;
  O[oTVeg][i] = c2.t_veg_n;
  O[oWtgq][i] = c2.wtgq;
  O[oWtalq][i] = c2.wtalq;
  O[oWtlq0][i] = c2.wtlq0;
  O[oWtaq0][i] = c2.wtaq0;
  A.itlef[i] = itlef;
  A.ci[i] = S.leaf(0, lCi);
  A.ci[n + i] = S.leaf(1, lCi);
  A.psn_iters[i] = S.count(iIters);
  A.psn_iters[n + i] = S.count(iIters + 1);
  return true;
}

template <typename T>
Args<T> make_args(long long n, const void* const* in,
                  const long long* in_stride, const void* const* traits,
                  const long long* trait_stride, const void* t_soisno,
                  int nlevtot, int nlevsno, const void* snl,
                  const void* soybean, long long soybean_stride,
                  const void* ci_prev, int warm_start, double dtime,
                  const double* consts, void* const* out, void* itlef,
                  void* ci, void* psn_iters) {
  Args<T> A;
  A.n = n;
  for (int k = 0; k < kIn; ++k) {
    A.in[k] = static_cast<const T*>(in[k]);
    A.in_stride[k] = in_stride[k];
  }
  for (int k = 0; k < kTraits; ++k) {
    A.traits[k] = static_cast<const T*>(traits[k]);
    A.trait_stride[k] = trait_stride[k];
  }
  A.t_soisno = static_cast<const T*>(t_soisno);
  A.nlevtot = nlevtot;
  A.nlevsno = nlevsno;
  A.snl = static_cast<const int*>(snl);
  A.soybean = static_cast<const unsigned char*>(soybean);
  A.soybean_stride = soybean_stride;
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

constexpr int kWarps = 4;  // warps a block
constexpr int kThreads = kWarps * kLanes;
// resident blocks an SM that __launch_bounds__ asks for: in float32 24
// warps (at most 80 registers a thread), in float64 16 (128 registers; its
// shared memory holds no more)
template <typename T>
constexpr int kMinBlocks = sizeof(T) == sizeof(float) ? 6 : 4;
// the launch's counters: [0] the next chunk to claim; [1] warp rounds, [2]
// lane rounds (lanes that ran a pass's head or tail in them); [3] warp
// evaluation steps, [4] lane evaluation steps (lanes that evaluated in
// them)
constexpr int kSched = 5;

__device__ __forceinline__ long long claim_chunk(unsigned long long* sched,
                                                 int lane) {
  unsigned long long c = 0;
  if (lane == 0) c = atomicAdd(&sched[0], 1ULL);
  return static_cast<long long>(__shfl_sync(0xffffffffu, c, 0));
}

// a lane's phase: no column, its pass's head next, evaluating its leaves,
// its pass's tail next
enum { kNone, kHead, kEval, kTail };

// Each warp is on its own, in rounds: the tails of the passes whose
// evaluations are done; the columns of the warp's chunk handed out, in
// order, to the lanes that have none (the next chunk claimed when this one
// is spent); the heads of the lanes' next passes; then ci evaluations until
// none evaluates: every round is one pass of every lane's column.  The
// warp ends when the
// chunks are spent and its lanes' columns have stopped.  Lanes touch only
// their own slots: no lane reads another's, so the warp needs no barrier.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
    canopy_kernel(const __grid_constant__ Args<T> A,
                  unsigned long long* sched) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kLanes;
  const Lane<T> S{reinterpret_cast<Lanes<T>*>(smem_raw)[threadIdx.x / kLanes],
                  lane};
  const unsigned full = 0xffffffffu;
  const long long nchunks = (A.n + kLanes - 1) / kLanes;
  long long cur = claim_chunk(sched, lane), col = 0;
  int pos = 0, phase = kNone;
  Solve<T> sv;
  sv.leaf = 2;
  unsigned long long steps[4] = {0, 0, 0, 0};
  for (;;) {
    const bool tail = phase == kTail;
    if (tail) phase = pass_tail<T, MODE>(Column<T>{A, col}, S) ? kNone : kHead;
    unsigned need = __ballot_sync(full, phase == kNone);
    while (need && cur < nchunks) {
      const int valid = static_cast<int>(
          min(static_cast<long long>(kLanes), A.n - cur * kLanes));
      const int rank = __popc(need & ((1u << lane) - 1u));
      const int taken = min(valid - pos, __popc(need));
      if (phase == kNone && rank < taken) {
        col = cur * kLanes + pos + rank;
        if (column_begin<T, MODE>(Column<T>{A, col}, S)) phase = kHead;
      }
      pos += taken;
      if (pos == valid) {
        cur = claim_chunk(sched, lane);
        pos = 0;
      }
      need = __ballot_sync(full, phase == kNone);
    }
    if (need == full) break;
    const bool head = phase == kHead;
    if (head) {
      pass_head<T, MODE>(Column<T>{A, col}, S, sv);
      phase = sv.leaf < 2 ? kEval : kTail;
    }
    ++steps[0];
    steps[1] += __popc(__ballot_sync(full, head || tail));
    for (;;) {
      const int nev = __popc(__ballot_sync(full, phase == kEval));
      if (nev == 0) break;
      ++steps[2];
      steps[3] += nev;
      if (phase == kEval) {
        leaf_step<T, MODE>(Column<T>{A, col}, S, sv);
        if (sv.leaf == 2) phase = kTail;
      }
    }
  }
  if (lane == 0) {
    for (int k = 0; k < 4; ++k) atomicAdd(&sched[1 + k], steps[k]);
  }
}

constexpr int kMaxDevices = 64;

template <typename T>
constexpr unsigned smem_bytes() {
  return kWarps * sizeof(Lanes<T>);
}

// Resident blocks an SM of K2 in (T, MODE) on the current device (its
// shared memory limit set first), and the SMs; cached per device.
template <typename T, int MODE>
cudaError_t resident(int* sms_out, int* per_sm_out) {
  static int sms[kMaxDevices], per_sm[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(canopy_kernel<T, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<T>());
    if (err != cudaSuccess) return err;
    int n = 0, k = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &k, canopy_kernel<T, MODE>, kThreads, smem_bytes<T>());
    if (err != cudaSuccess) return err;
    if (k < 1) return cudaErrorInvalidConfiguration;
    sms[dev] = n;
    per_sm[dev] = k;
  }
  *sms_out = sms[dev];
  *per_sm_out = per_sm[dev];
  return cudaSuccess;
}

template <typename T, int MODE>
int launch_mode(const Args<T>& A, unsigned long long* sched, cudaStream_t s) {
  int sms = 0, per_sm = 0;
  cudaError_t err = resident<T, MODE>(&sms, &per_sm);
  if (err != cudaSuccess) return err;
  const long long chunks = (A.n + kLanes - 1) / kLanes;
  const long long need = (chunks + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(need < cap ? need : cap);
  canopy_kernel<T, MODE><<<grid, kThreads, smem_bytes<T>(), s>>>(A, sched);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int mode, const Args<T>& A, unsigned long long* sched,
           cudaStream_t s) {
  const cudaError_t err =
      cudaMemsetAsync(sched, 0, kSched * sizeof(unsigned long long), s);
  if (err != cudaSuccess || A.n <= 0) return err;
  switch (mode) {
    case kC3:
      return launch_mode<T, kC3>(A, sched, s);
    case kC4:
      return launch_mode<T, kC4>(A, sched, s);
    case kMixed:
      return launch_mode<T, kMixed>(A, sched, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// {threads a block, dynamic shared memory bytes a block, resident blocks
// an SM, SMs, registers a thread, local memory bytes a thread (spills)}
template <typename T, int MODE>
int layout_of(int* out) {
  int sms = 0, per_sm = 0;
  cudaError_t err = resident<T, MODE>(&sms, &per_sm);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, canopy_kernel<T, MODE>);
  if (err != cudaSuccess) return err;
  out[0] = kThreads;
  out[1] = static_cast<int>(smem_bytes<T>());
  out[2] = per_sm;
  out[3] = sms;
  out[4] = attr.numRegs;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// in: kIn pointers (IN_FIELDS order) and their strides in elements (0: one
// value for every column); traits: kTraits pointers (PFTPsnParams order)
// and strides; t_soisno [n, nlevtot]; snl int32 [n]; soybean uint8 with its
// stride; ci_prev [2n] or null; consts: kConsts doubles (CONSTS order);
// out: kOut [n] pointers (StabilityOut's floating fields); itlef int32
// [n], ci [2n], psn_iters int32 [2n]; sched: kSched 8-B counters on the
// device, the launch's own (zeroed here, on `stream`, before the kernel:
// two launches that may overlap need two).  mode: 0 c3, 1 c4, 2 mixed.
// Launches on `stream`; returns the first CUDA error.
#define CANOPY_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(int mode, long long n, const void* const* in,          \
                      const long long* in_stride, const void* const* traits, \
                      const long long* trait_stride, const void* t_soisno,   \
                      int nlevtot, int nlevsno, const void* snl,             \
                      const void* soybean, long long soybean_stride,         \
                      const void* ci_prev, int warm_start, double dtime,     \
                      const double* consts, void* const* out, void* itlef,   \
                      void* ci, void* psn_iters, void* sched,                \
                      void* stream) {                                        \
    const Args<T> A = make_args<T>(                                           \
        n, in, in_stride, traits, trait_stride, t_soisno, nlevtot, nlevsno,  \
        snl, soybean, soybean_stride, ci_prev, warm_start, dtime, consts,    \
        out, itlef, ci, psn_iters);                                          \
    return launch<T>(mode, A, static_cast<unsigned long long*>(sched),       \
                     static_cast<cudaStream_t>(stream));                     \
  }
CANOPY_ENTRY(canopy_stability_f64, double)
CANOPY_ENTRY(canopy_stability_f32, float)
#undef CANOPY_ENTRY

// What K2's launch chooses on the current device in `mode`, float64 if
// `f64`, else float32: out = {threads a block, dynamic shared memory bytes
// a block, resident blocks an SM, SMs, registers a thread, local memory
// bytes a thread}.  Returns a CUDA error code.
extern "C" int canopy_stability_layout(int f64, int mode, int* out) {
  switch (mode * 2 + (f64 != 0)) {
    case kC3 * 2: return layout_of<float, kC3>(out);
    case kC3 * 2 + 1: return layout_of<double, kC3>(out);
    case kC4 * 2: return layout_of<float, kC4>(out);
    case kC4 * 2 + 1: return layout_of<double, kC4>(out);
    case kMixed * 2: return layout_of<float, kMixed>(out);
    case kMixed * 2 + 1: return layout_of<double, kMixed>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#endif  // __CUDACC__
