// K5: the snow-hydrology block of the step, one thread a column: meltwater
// percolation with aerosol flushing, aerosol deposition and phase change,
// compaction, combination of thin layers, the layerless pass-through,
// division of thick layers, pruning, aerosol concentrations and the grain
// aging (ELM's clamp, or the reference's pinned radius).
//
// Replaces: elmkernels_tpu/physics/snow_hydrology.py lines 57-927, the ten
// functions the JAX step (driver/step.py:641-712) runs in turn, whose
// lax.scans over the 5 snow positions (lines 117, 172, 468, 576, 606, 749)
// the port ran as Python loops of masked, full-width tensor operations
// (physics/snow_hydrology.py:snow_hydrology_block_plain): some thousand
// launches a step, each streaming a [ncol, 20] array.  Reference:
// snow_hydrology_impl.hh:80-1353, aerosol_physics_impl.hh:34-107.
//
// A column runs the plain block's sequence, position by position, with its
// semantics: the pre-merge reads at position i, snl changing in the middle
// of a pass, the shifts that move the layers above a removed one down, the
// top-anchored scratch layout of divide_layers and its four-rung ladder,
// the soil-top row (position 5) that combine merges into and that
// snow_water updates for a layerless column, the percolation clamp's kept
// deviation vol_ice[i+1], the soil-like mask (soil, crop, urban) of the
// merges and the soil/crop mask of the melt compaction, do_capsnow.  Every
// position of every field is computed as the plain block computes it, the
// inactive ones included, since the step keeps them.
//
// The layer fields live in registers: every loop over the positions is
// unrolled, and a position chosen at run time (the top layer, the merge
// partner, the scratch layout's source) is read and written by predicated
// selects over the unrolled positions (pick, shift_down), never by an index
// into an array, which would put the array in local memory.
//
// The arithmetic is the plain block's, operation by operation and in its
// order (build with --fmad=false), as PyTorch's elementwise kernels compute
// each operation on the card:
// - a Python number meets a tensor rounded to T (`T(k)`); a constant
//   Python folds (-1.0 / dtime, dtime / 3600.0, 4.0 * pi) is folded here
//   in double the same way;
// - tensor / number multiplies by the number's reciprocal, taken in double
//   and rounded to T, on the card, and divides on the CPU (divs);
// - x ** 3.0 and x ** 2.0 are products; a tensor power, acos and exp come
//   from snow_math.cu, compiled apart with contraction on as PyTorch's
//   kernels are; clamp, minimum and maximum propagate NaN (nmin, nmax);
// - torch.sum over the 5 positions adds as PyTorch's reduction does on the
//   card (four lanes: ((x0 + x4) + x2) + (x1 + x3)) and torch.cumsum as its
//   Sklansky scan does; on the CPU both add in order (sum5, cumsum5).
//
// The same source built by a host compiler (the device code is HD inline
// functions; the kernel and its launch sit under __CUDACC__) is what the
// CPU tests run, one column at a time (run_column).

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#define UNROLL _Pragma("unroll")
// snow_math.cu: pow, acos and exp compiled with contracted multiply-adds
extern __device__ double snow_pow(double x, double p);
extern __device__ float snow_pow(float x, float p);
extern __device__ double snow_acos(double x);
extern __device__ float snow_acos(float x);
extern __device__ double snow_exp(double x);
extern __device__ float snow_exp(float x);
#else
#define HD inline
#define UNROLL
#endif

namespace {

constexpr int kSno = 5;      // NLEVSNO
constexpr int kSpecies = 6;  // AERO_SPECIES
constexpr int kAero = 11;    // AERO_DEP_KEYS

// ---- the per-column [ncol] inputs, in ops/snow.py's IN_FIELDS order ------
enum {
  iFse, iFracSno, iH2osno, iSnowDepth, iIntSnow, iSubSnow, iEvapGrnd,
  iDewSnow, iDewGrnd, iRainGrnd, iSnomelt, iSnowMelt, iNMelt, iSnwcpIce,
  iSnowGrnd, iAero, kIn = iAero + kAero
};
// the layered inputs ([ncol, L] with a row stride), LAYER_FIELDS' order
enum {
  lLiq, lIce, lT, lDz, lZ, lZi, lFracIceold, lSweOld, lSnwRds, lSnofrz,
  lMss, kLay = lMss + kSpecies
};
// the [ncol] outputs, OUT_FIELDS' order
enum {
  oH2osno, oSnowDepth, oFracSno, oFse, oIntSnow, oSnowMelt, oTopSoil,
  oSlTopSoil, oSnow2topsoi, oMflxSnowlyr, oMflxNeg, kOut
};
// the layered outputs: t, ice, liq, dz, z [ncol, nlevtot], zi [ncol,
// nlevtot + 1], snw_rds, the masses and the concentrations [ncol, 5]
enum { qT, qIce, qLiq, qDz, qZ, qZi, qRds, qMss, qCnc = qMss + kSpecies,
       kLayOut = qCnc + kSpecies };

// Python-level constants, in ops/snow.py's CONSTS order
struct Consts {
  double tfrz, denice, denh2o, cpice, cpwat, hfus, pi, rds_min, rds_max;
};
constexpr int kConsts = sizeof(Consts) / sizeof(double);

template <typename T>
struct Args {
  long long n;
  // element of column i: in[k][i * in_stride[k]] (a stride of 0 gives
  // every column one value), lay[k][i * lay_stride[k] + p]
  const T* in[kIn];
  long long in_stride[kIn];
  const T* lay[kLay];
  long long lay_stride[kLay];
  const long long* snl;           // [n]
  const long long* do_capsnow;    // [n], or one value (stride 0)
  long long capsnow_stride;
  const long long* imelt;         // [n, >= 5] with a row stride
  long long imelt_stride;
  const unsigned char* soil_like;  // [n] or one value (stride 0)
  long long soil_like_stride;
  const unsigned char* soil_crop;
  long long soil_crop_stride;
  const T *tau, *kappa, *drdt0;   // [n_t, n_tgrd, n_rhos], contiguous
  int n_t, n_tgrd, n_rhos;
  int nlevtot;
  double dtime;
  Consts K;
  long long* snl_out;
  T* out[kOut];
  T* lay_out[kLayOut];
};

// ---- elementwise arithmetic as PyTorch computes it -------------------------

template <typename T>
HD T nmax(T a, T b) { return (a > b || isnan(a)) ? a : b; }
template <typename T>
HD T nmin(T a, T b) { return (a < b || isnan(a)) ? a : b; }

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

template <typename T>
HD T tpow(T x, T p) {
#ifdef __CUDA_ARCH__
  return snow_pow(x, p);
#else
  return pow(x, p);
#endif
}
template <typename T>
HD T tacos(T x) {
#ifdef __CUDA_ARCH__
  return snow_acos(x);
#else
  return acos(x);
#endif
}
template <typename T>
HD T texp(T x) {
#ifdef __CUDA_ARCH__
  return snow_exp(x);
#else
  return exp(x);
#endif
}

// torch.sum(x, dim=1) over the 5 positions: on the card four lanes of
// PyTorch's reduction take x0 + x4, x1, x2 and x3, and two shuffles at
// halving offsets add lane 2 to lane 0 and lane 3 to lane 1, then lane 1
// to lane 0 (measured against every association of the five)
template <typename T>
HD T sum5(const T (&x)[kSno]) {
#ifdef __CUDA_ARCH__
  return ((x[0] + x[4]) + x[2]) + (x[1] + x[3]);
#else
  return (((x[0] + x[1]) + x[2]) + x[3]) + x[4];
#endif
}

// torch.cumsum(x, dim=1) over the 5 positions
template <typename T>
HD void cumsum5(const T (&x)[kSno], T (&c)[kSno]) {
  c[0] = x[0];
  c[1] = x[1] + x[0];
  c[2] = x[2] + c[1];
#ifdef __CUDA_ARCH__
  c[3] = (x[3] + x[2]) + c[1];
#else
  c[3] = x[3] + c[2];
#endif
  c[4] = x[4] + c[3];
}

// a read-only load (the non-coherent path on the card)
template <typename T>
HD T load(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// a[k] for a run-time k in [0, N), by selects over the unrolled positions
template <typename T, int N>
HD T pick(const T (&a)[N], int k) {
  T v = a[0];
  UNROLL for (int p = 1; p < N; ++p) v = (p == k) ? a[p] : v;
  return v;
}

// where(on and lo < p <= hi): a[p] = a[p - 1], over positions 0..4, each
// from the value before the shift (plain: _shift_down)
template <typename T, int N>
HD void shift_down(T (&a)[N], bool on, int lo, int hi) {
  UNROLL for (int p = kSno - 1; p >= 1; --p) {
    if (on && p > lo && p <= hi) a[p] = a[p - 1];
  }
}

// the table index rint(x) clamped to [0, hi], NaN to 0 (_table_index)
template <typename T>
HD int table_index(T x, int hi) {
  const T r = rint(x);
  if (isnan(r) || r <= T(0)) return 0;
  if (r >= T(hi)) return hi;
  return static_cast<int>(r);
}

// Mass/energy-conserving merge of layer 2 into layer 1 (_combine_vals)
template <typename T>
struct Merged {
  T dz, wliq, wice, t;
};
template <typename T>
HD Merged<T> combine_vals(T dz2, T wliq2, T wice2, T t2, T dz1, T wliq1,
                          T wice1, T t1, const Consts& K) {
  const T cpice = T(K.cpice), cpwat = T(K.cpwat), hfus = T(K.hfus);
  const T tfrz = T(K.tfrz);
  const T h1 = (cpice * wice1 + cpwat * wliq1) * (t1 - tfrz) + hfus * wliq1;
  const T h2 = (cpice * wice2 + cpwat * wliq2) * (t2 - tfrz) + hfus * wliq2;
  const T wice = wice1 + wice2;
  const T wliq = wliq1 + wliq2;
  const T den = cpice * wice + cpwat * wliq;
  const T tc = tfrz + (h1 + h2 - hfus * wliq) / (den != T(0) ? den : T(1));
  return {dz1 + dz2, wliq, wice, tc};
}

// One column's snow: positions 0-4 the snow layers, 5 the top soil row
// (liq, ice, t, dz and zi read it; combine and snow_water write liq/ice)
template <typename T>
struct Pack {
  T t[kSno + 1], ice[kSno + 1], liq[kSno + 1], dz[kSno + 1];
  T z[kSno], zi[kSno + 1], rds[kSno];
  T mss[kSpecies][kSno];
  int snl;
};

// z(i) = zi(i+1) - dz/2, zi(i) = zi(i+1) - dz from the bottom snow layer
// up, for the active layers (_rebuild_snow_mesh)
template <typename T>
HD void rebuild_mesh(Pack<T>& P) {
  const int top = kSno - P.snl;
  UNROLL for (int i = kSno - 1; i >= 0; --i) {
    if (i >= top) {
      P.z[i] = P.zi[i + 1] - T(0.5) * P.dz[i];
      P.zi[i] = P.zi[i + 1] - P.dz[i];
    }
  }
}

template <typename T>
struct Column {
  const Args<T>& A;
  long long i;
  HD T in(int k) const { return load(&A.in[k][i * A.in_stride[k]]); }
  HD T lay(int k, int p) const {
    return load(&A.lay[k][i * A.lay_stride[k] + p]);
  }
};

// What combine hands on besides the layers
template <typename T>
struct Combined {
  T h2osno, snow_depth, frac_sno, fse, int_snow, qsl, qs2t, mflx;
};

// ---- 1-3: snow_water, compute_aerosol_deposition, aerosol_phase_change ----

template <typename T>
struct Water {
  T snow_melt, top_soil, int_snow, frac_sno, mflx_neg;
};

template <typename T>
HD Water<T> snow_water(const Column<T>& C, Pack<T>& P, bool cap, T fse) {
  const double dtime = C.A.dtime;
  const Consts& K = C.A.K;
  const T Tdt = T(dtime);
  const int top = kSno - P.snl;
  const T sub = C.in(iSubSnow), evap = C.in(iEvapGrnd);
  const T dew_snow = C.in(iDewSnow), dew_grnd = C.in(iDewGrnd);
  const T rain = C.in(iRainGrnd);
  // top-layer sublimation/frost/dew (impl:298-315); a layerless column's
  // top is the soil row
  const T sub_cap = (fse * sub) * Tdt;
  const T add_nc = (fse * (dew_snow - sub)) * Tdt;
  const T liq_cap = ((-fse) * evap) * Tdt;
  const T liq_nc = (fse * ((rain + dew_grnd) - evap)) * Tdt;
  UNROLL for (int p = 0; p <= kSno; ++p) {
    const T wgdif = cap ? P.ice[p] - sub_cap : P.ice[p] + add_nc;
    const bool neg = wgdif < T(0);
    const bool at_top = p == top;
    P.ice[p] = at_top ? (neg ? T(0) : wgdif) : P.ice[p];
    P.liq[p] = P.liq[p] + ((at_top && neg) ? wgdif : T(0));
    P.liq[p] = P.liq[p] + (at_top ? (cap ? liq_cap : liq_nc) : T(0));
  }
  // zero negative liquid downward from the top, to the first
  // non-negative layer (impl:317-324)
  bool running = pick(P.liq, top) < T(0);
  T mflx_neg = T(0);
  UNROLL for (int p = 0; p <= kSno; ++p) {
    const T w = P.liq[p];
    const bool below = p >= top;
    const bool hit = running && below && w < T(0);
    P.liq[p] = hit ? T(0) : w;
    mflx_neg = hit ? divs(w, dtime) : mflx_neg;
    running = running && (!below || hit);
  }
  // porosity and partial volumes (impl:327-335)
  T vol_ice[kSno], eff_por[kSno], vol_liq[kSno];
  UNROLL for (int p = 0; p < kSno; ++p) {
    const T dzf = P.dz[p] * fse;
    const T den_i = dzf * T(K.denice);
    const T den_l = dzf * T(K.denh2o);
    vol_ice[p] = nmin(den_i != T(0) ? P.ice[p] / den_i : T(0), T(1));
    eff_por[p] = T(1) - vol_ice[p];
    vol_liq[p] = nmin(eff_por[p], den_l != T(0) ? P.liq[p] / den_l : T(0));
  }
  // percolation with aerosol scavenging (impl:353-461)
  const double scv[kSpecies] = {0.20, 0.03, 0.02, 0.02, 0.01, 0.01};
  T qin = T(0), qout = T(0), qin_a[kSpecies];
  UNROLL for (int k = 0; k < kSpecies; ++k) qin_a[k] = T(0);
  UNROLL for (int i = 0; i < kSno; ++i) {
    const bool act = i >= top;
    P.liq[i] = P.liq[i] + (act ? qin : T(0));
    UNROLL for (int k = 0; k < kSpecies; ++k)
      P.mss[k][i] = P.mss[k][i] + (act ? qin_a[k] : T(0));
    const int ip1 = i + 1 < kSno ? i + 1 : kSno - 1;
    const T base = nmax(((vol_liq[i] - T(0.033) * eff_por[i]) * P.dz[i]) * fse,
                        T(0));
    // (the reference reads vol_ice[i+i] here: corrected to i+1)
    const T capq = (((T(1) - vol_ice[ip1]) - vol_liq[ip1]) * P.dz[ip1]) * fse;
    const bool blocked = eff_por[i] < T(0.05) || eff_por[ip1] < T(0.05);
    T q = i < kSno - 1 ? (blocked ? T(0) : nmin(base, capq)) : base;
    q = q * T(1000.0);
    P.liq[i] = P.liq[i] + (act ? -q : T(0));
    qin = act ? q : qin;
    qout = act ? q : qout;
    const T liqice = nmax(P.liq[i] + P.ice[i], T(1.0e-30));
    UNROLL for (int k = 0; k < kSpecies; ++k) {
      const T mk = P.mss[k][i];
      const T qa = nmin((q * T(scv[k])) * (mk / liqice), mk);
      P.mss[k][i] = mk + (act ? -qa : T(0));
      qin_a[k] = act ? qa : qin_a[k];
    }
  }
  // layer thickness floor (impl:468-470)
  UNROLL for (int p = 0; p < kSno; ++p) {
    if (p >= top) {
      P.dz[p] = nmax(P.dz[p], divs(P.liq[p], K.denh2o) +
                                  divs(P.ice[p], K.denice));
    }
  }
  // bottom fluxes (impl:472-483)
  const bool has = P.snl > 0;
  const T h2osno = C.in(iH2osno), int_snow = C.in(iIntSnow);
  Water<T> W;
  W.snow_melt = has ? C.in(iSnowMelt) + divs(qout, dtime) : C.in(iSnomelt);
  W.top_soil = has ? divs(qout, dtime) + (T(1) - fse) * rain
                   : rain + C.in(iSnomelt);
  W.int_snow = has ? int_snow + (fse * ((dew_snow + dew_grnd) + rain)) * Tdt
                   : (h2osno <= T(0) ? T(0) : int_snow);
  W.frac_sno = (!has && h2osno <= T(0)) ? T(0) : C.in(iFracSno);
  W.mflx_neg = mflx_neg;
  return W;
}

template <typename T>
HD void aerosols_in(const Column<T>& C, Pack<T>& P) {
  const T Tdt = T(C.A.dtime);
  const int top = kSno - P.snl;
  // deposition into the top layer (aerosol_physics_impl.hh:34-60)
  T add[kSpecies];
  add[0] = C.in(iAero + 0);
  add[1] = C.in(iAero + 1) + C.in(iAero + 2);
  UNROLL for (int k = 2; k < kSpecies; ++k)
    add[k] = C.in(iAero + 2 * k - 1) + C.in(iAero + 2 * k);
  const bool has = P.snl > 0;
  UNROLL for (int k = 0; k < kSpecies; ++k) {
    const T d = add[k] * Tdt;
    UNROLL for (int p = 0; p < kSno; ++p)
      P.mss[k][p] = P.mss[k][p] + ((p == top && has) ? d : T(0));
  }
  // within-ice BC to external BC with the sublimated mass
  // (snow_hydrology_impl.hh:492-543)
  const T tot = pick(P.liq, top) + pick(P.ice, top);
  const T subsnow = nmax(C.in(iSubSnow) * Tdt, T(0));
  const T frc = nmin(tot > T(0) ? subsnow / tot : T(0), T(1));
  UNROLL for (int p = 0; p < kSno; ++p) {
    const T dm = p == top ? P.mss[0][p] * frc : T(0);
    P.mss[0][p] = P.mss[0][p] - dm;
    P.mss[1][p] = P.mss[1][p] + dm;
  }
}

// ---- 4: snow_compaction (snow_hydrology_impl.hh:546-637) -------------------

template <typename T>
HD void compaction(const Column<T>& C, Pack<T>& P, T frac_sno, T int_snow,
                   bool soil_crop) {
  const double dtime = C.A.dtime;
  const Consts& K = C.A.K;
  const int top = kSno - P.snl;
  const T fs = frac_sno;
  const T fs_safe = fs != T(0) ? fs : T(1);
  T wx[kSno], wx_act[kSno], cum[kSno];
  UNROLL for (int p = 0; p < kSno; ++p) {
    wx[p] = P.ice[p] + P.liq[p];
    wx_act[p] = p >= top ? wx[p] : T(0);
  }
  cumsum5(wx_act, cum);
  const T wsum = sum5(wx_act);
  const T int_safe = int_snow != T(0) ? int_snow : T(1);
  const T n_melt = C.in(iNMelt);
  const T rdt = T(-1.0 / dtime);
  UNROLL for (int p = 0; p < kSno; ++p) {
    const T ice = P.ice[p], liq = P.liq[p], dz = P.dz[p];
    const T dz_safe = dz != T(0) ? dz : T(1);
    const T vd = T(1) - (divs(ice, K.denice) + divs(liq, K.denh2o)) /
                            (fs_safe * dz_safe);
    const bool compact = p >= top && vd > T(0.001) && ice > T(0.1);
    const T bi = ice / (fs_safe * dz_safe);
    const T wx_safe = wx[p] != T(0) ? wx[p] : T(1);
    const T fi = ice / wx_safe;
    const T td = T(K.tfrz) - P.t[p];
    const T dexpf = texp(T(-0.04) * td);
    T ddz1 = T(-2.777e-6) * dexpf;
    if (bi > T(100.0)) ddz1 = ddz1 * texp(T(-46.0e-3) * (bi - T(100.0)));
    if (liq > (T(0.01) * dz) * fs) ddz1 = ddz1 * T(2.0);
    // overburden: exclusive prefix sum of the layer mass from the top
    const T burden = cum[p] - wx_act[p];
    const T ddz2 = divs((-(burden + divs(wx[p], 2.0))) *
                            texp(T(-0.08) * td - T(23.e-3) * bi),
                        9.0e+5);
    // melt compaction: ELM's fractional-area form on soil and crop
    const T swe = C.lay(lSweOld, p);
    T ddz3_sc = nmin(nmax((swe - wx[p]) / wx_safe, T(0)), T(1));
    const bool shrunk = (swe - wx[p]) > T(0);
    const T x = nmin((p == top ? wsum : T(0)) / int_safe, T(1));
    const T fsno_melt =
        T(1) - tpow(divs(tacos(T(2.0) * x - T(1.0)), K.pi), n_melt);
    ddz3_sc = ddz3_sc - (shrunk ? nmax((fsno_melt - fs) / fs_safe, T(0))
                                : T(0));
    ddz3_sc = rdt * ddz3_sc;
    const T fio = C.lay(lFracIceold, p);
    const T fio_safe = fio != T(0) ? fio : T(1);
    const T ddz3_ns = rdt * nmax((fio - fi) / fio_safe, T(0));
    T ddz3 = soil_crop ? ddz3_sc : ddz3_ns;
    const long long imelt = C.A.imelt[C.i * C.A.imelt_stride + p];
    ddz3 = imelt == 1 ? ddz3 : T(0);
    const T pdzdtc = (ddz1 + ddz2) + ddz3;
    const T dz_comp = nmax(dz * (T(1) + pdzdtc * T(dtime)),
                           (divs(ice, K.denice) + divs(liq, K.denh2o)) /
                               fs_safe);
    P.dz[p] = compact ? dz_comp : dz;
  }
}

// ---- 5: combine_layers (snow_hydrology_impl.hh:648-897) --------------------

template <typename T>
HD void shift_layers(Pack<T>& P, bool on, int lo, int hi) {
  shift_down(P.t, on, lo, hi);
  shift_down(P.liq, on, lo, hi);
  shift_down(P.ice, on, lo, hi);
  shift_down(P.dz, on, lo, hi);
  shift_down(P.rds, on, lo, hi);
  UNROLL for (int k = 0; k < kSpecies; ++k) shift_down(P.mss[k], on, lo, hi);
}

template <typename T>
HD Combined<T> combine(const Column<T>& C, Pack<T>& P, bool soil_like,
                       T fse, T frac_sno, T int_snow) {
  const double dtime = C.A.dtime;
  const Consts& K = C.A.K;
  Combined<T> R;
  R.qsl = T(0);
  R.qs2t = T(0);
  R.mflx = T(0);
  // pass 1: eliminate layers with ice <= 0.01 (impl:689-756)
  const int top_old = kSno - P.snl;
  UNROLL for (int i = 0; i < kSno; ++i) {
    const T liq_i = P.liq[i], ice_i = P.ice[i];  // pre-merge values
    const bool m = i >= top_old && ice_i <= T(0.01);
    const bool msl = m && soil_like;
    // merge the mass into the layer below (soil-like land units); the
    // bottom layer's into the soil row
    if (msl) {
      P.liq[i + 1] = P.liq[i + 1] + liq_i;
      P.ice[i + 1] = P.ice[i + 1] + ice_i;
    }
    T q = T(0);
    if (i == kSno - 1) {
      q = msl ? divs(liq_i + ice_i, dtime) : T(0);
      R.qsl = msl ? q : R.qsl;
    }
    R.mflx = R.mflx + q;
    if (i < kSno - 1 && msl) {
      P.dz[i + 1] = P.dz[i + 1] + P.dz[i];
      UNROLL for (int k = 0; k < kSpecies; ++k)
        P.mss[k][i + 1] = P.mss[k][i + 1] + P.mss[k][i];
    }
    // shift the layers above down one
    const int topc = kSno - P.snl;
    shift_layers(P, m && i > topc && P.snl > 1, topc, i);
    P.snl = m ? P.snl - 1 : P.snl;
  }
  // totals (impl:758-769)
  T wt[kSno], d[kSno], wi[kSno], wl[kSno];
  {
    const int top = kSno - P.snl;
    UNROLL for (int p = 0; p < kSno; ++p) {
      const bool a = p >= top;
      wt[p] = a ? P.ice[p] + P.liq[p] : T(0);
      d[p] = a ? P.dz[p] : T(0);
      wi[p] = a ? P.ice[p] : T(0);
      wl[p] = a ? P.liq[p] : T(0);
    }
  }
  T h2osno = sum5(wt), snow_depth = sum5(d);
  const T zwice = sum5(wi), zwliq = sum5(wl);
  // dissolve too-shallow packs (impl:775-800)
  const T fsd = fse * snow_depth;
  const T fsd_safe = fsd != T(0) ? fsd : T(1);
  const bool gone = snow_depth > T(0) &&
                    (fsd < T(0.01) || h2osno / fsd_safe < T(50.0));
  P.snl = gone ? 0 : P.snl;
  h2osno = gone ? zwice : h2osno;
  UNROLL for (int k = 0; k < kSpecies; ++k)
    UNROLL for (int p = 0; p < kSno; ++p)
      P.mss[k][p] = gone ? T(0) : P.mss[k][p];
  snow_depth = (gone && h2osno <= T(0)) ? T(0) : snow_depth;
  const bool gsl = gone && soil_like;
  P.liq[kSno - 1] = gsl ? T(0) : P.liq[kSno - 1];
  P.liq[kSno] = P.liq[kSno] + (gsl ? zwliq : T(0));
  R.qs2t = gsl ? divs(zwliq, dtime) : R.qs2t;
  R.mflx = R.mflx + (gsl ? divs(zwliq, dtime) : T(0));
  const bool none_left = h2osno <= T(0);
  R.h2osno = h2osno;
  R.snow_depth = none_left ? T(0) : snow_depth;
  R.frac_sno = none_left ? T(0) : frac_sno;
  R.fse = none_left ? T(0) : fse;
  R.int_snow = none_left ? T(0) : int_snow;
  // merge below-minimum layers with a neighbour (impl:813-890)
  const double dzmin[kSno] = {0.010, 0.015, 0.025, 0.055, 0.115};
  const int top_old2 = kSno - P.snl;
  int mssi = 0;
  bool stop = P.snl <= 1;
  const T f = R.fse;
  UNROLL for (int i = 0; i < kSno; ++i) {
    const T dz_i = P.dz[i];
    const T fse_dz = f * dz_i;
    const T fse_dz_safe = fse_dz != T(0) ? fse_dz : T(1);
    T dmin = T(dzmin[0]);
    UNROLL for (int k = 1; k < kSno; ++k) dmin = mssi == k ? T(dzmin[k]) : dmin;
    const bool thin = fse_dz < dmin ||
                      (P.ice[i] + P.liq[i]) / fse_dz_safe < T(50.0);
    const bool m = !stop && i >= top_old2 && thin;
    const int topc = kSno - P.snl;
    // the first position merges downward, the last upward, the middle
    // ones with the thinner neighbour (impl:823-834): nb: j = i+1, l = i;
    // else j = i, l = i-1
    bool nb;
    if (i == 0) {
      nb = true;
    } else if (i == kSno - 1) {
      nb = false;
    } else {
      nb = i == topc || !((P.dz[i - 1] + dz_i) < (P.dz[i + 1] + dz_i));
    }
    const int ja = i + 1 < kSno ? i + 1 : i;
    const int lb = i > 0 ? i - 1 : 0;
    const int j = nb ? i + 1 : i;
    const T wl_j = nb ? P.liq[ja] : P.liq[i], wl_l = nb ? P.liq[i] : P.liq[lb];
    const T wi_j = nb ? P.ice[ja] : P.ice[i], wi_l = nb ? P.ice[i] : P.ice[lb];
    const T t_j = nb ? P.t[ja] : P.t[i], t_l = nb ? P.t[i] : P.t[lb];
    const T dz_j = nb ? P.dz[ja] : P.dz[i], dz_l = nb ? P.dz[i] : P.dz[lb];
    const T r_j = nb ? P.rds[ja] : P.rds[i], r_l = nb ? P.rds[i] : P.rds[lb];
    const T tot = ((wl_j + wi_j) + wl_l) + wi_l;
    const T rds_new = (r_j * (wl_j + wi_j) + r_l * (wl_l + wi_l)) /
                      (tot != T(0) ? tot : T(1));
    const Merged<T> M =
        combine_vals(dz_l, wl_l, wi_l, t_l, dz_j, wl_j, wi_j, t_j, K);
    if (m) {
      if (nb) {
        P.liq[ja] = M.wliq;
        P.ice[ja] = M.wice;
        P.t[ja] = M.t;
        P.dz[ja] = M.dz;
        P.rds[ja] = rds_new;
        UNROLL for (int k = 0; k < kSpecies; ++k)
          P.mss[k][ja] = P.mss[k][ja] + P.mss[k][i];
      } else {
        P.liq[i] = M.wliq;
        P.ice[i] = M.wice;
        P.t[i] = M.t;
        P.dz[i] = M.dz;
        P.rds[i] = rds_new;
        UNROLL for (int k = 0; k < kSpecies; ++k)
          P.mss[k][i] = P.mss[k][i] + P.mss[k][lb];
      }
    }
    // shift the layers above down one (impl:865-879): from j-1 to the top
    shift_layers(P, m && (j - 1) > topc, topc - 1, j - 1);
    P.snl = m ? P.snl - 1 : P.snl;
    stop = stop || (m && P.snl <= 1);
    mssi = (!stop && i >= top_old2 && !m) ? mssi + 1 : mssi;
  }
  rebuild_mesh(P);
  return R;
}

// ---- 7: divide_layers (snow_hydrology_impl.hh:907-1285) --------------------

template <typename T>
HD void divide(Pack<T>& P, T frac_sno, const Consts& K) {
  const int snl = P.snl;
  const int top = kSno - snl;
  const T fs = frac_sno;
  const T fs_safe = fs != T(0) ? fs : T(1);
  // top-anchored scratch: index k holds layer top + k
  T dzs[kSno], swice[kSno], swliq[kSno], tsno[kSno], rds[kSno];
  T ms[kSpecies][kSno];
  UNROLL for (int k = 0; k < kSno; ++k) {
    const bool in = k < snl;
    const int src = top + k < kSno - 1 ? top + k : kSno - 1;
    dzs[k] = (in ? pick<T, kSno + 1>(P.dz, src) : T(0)) * fs;
    swice[k] = in ? pick<T, kSno + 1>(P.ice, src) : T(0);
    swliq[k] = in ? pick<T, kSno + 1>(P.liq, src) : T(0);
    tsno[k] = in ? pick<T, kSno + 1>(P.t, src) : T(0);
    rds[k] = in ? pick(P.rds, src) : T(0);
    UNROLL for (int s = 0; s < kSpecies; ++s)
      ms[s][k] = in ? pick(P.mss[s], src) : T(0);
  }
  int msno = snl;
  // one layer thicker than 0.03: split it in two (impl:962-986)
  if (msno == 1 && dzs[0] > T(0.03)) {
    dzs[0] = dzs[1] = divs(dzs[0], 2.0);
    swice[0] = swice[1] = divs(swice[0], 2.0);
    swliq[0] = swliq[1] = divs(swliq[0], 2.0);
    UNROLL for (int s = 0; s < kSpecies; ++s)
      ms[s][0] = ms[s][1] = divs(ms[s][0], 2.0);
    tsno[1] = tsno[0];
    rds[1] = rds[0];
    msno = 2;
  }
  // the ladder: trim layer k to dmax, push the excess into k+1, then maybe
  // split k+1
  const double dmaxs[4] = {0.02, 0.05, 0.11, 0.23};
  const int split_msno[3] = {2, 3, 4};
  const double split_dz[3] = {0.07, 0.18, 0.41};
  UNROLL for (int k = 0; k < 4; ++k) {
    const T dmax = T(dmaxs[k]);
    const T dzs_k = dzs[k];
    const bool thick = msno > k + 1 && dzs_k > dmax;
    const T dz_k = dzs_k != T(0) ? dzs_k : T(1);
    const T drr = dzs_k - dmax;
    const T propor_x = drr / dz_k;
    const T zwice = propor_x * swice[k];
    const T zwliq = propor_x * swliq[k];
    const T propor = dmax / dz_k;
    if (thick) {
      swice[k] = swice[k] * propor;
      swliq[k] = swliq[k] * propor;
      UNROLL for (int s = 0; s < kSpecies; ++s) {
        ms[s][k + 1] = ms[s][k + 1] + propor_x * ms[s][k];
        ms[s][k] = ms[s][k] * propor;
      }
      dzs[k] = dmax;
    }
    const T tot = ((swliq[k + 1] + swice[k + 1]) + zwliq) + zwice;
    const T rds_next = (rds[k + 1] * (swliq[k + 1] + swice[k + 1]) +
                        rds[k] * (zwliq + zwice)) /
                       (tot != T(0) ? tot : T(1));
    if (thick) rds[k + 1] = rds_next;
    const Merged<T> M =
        combine_vals(drr, zwliq, zwice, tsno[k], dzs[k + 1], swliq[k + 1],
                     swice[k + 1], tsno[k + 1], K);
    if (thick) {
      dzs[k + 1] = M.dz;
      swliq[k + 1] = M.wliq;
      swice[k + 1] = M.wice;
      tsno[k + 1] = M.t;
    }
    if (k == 3) break;  // the last rung never splits
    // subdivide layer k+1
    const bool split =
        thick && msno <= split_msno[k] && dzs[k + 1] > T(split_dz[k]);
    const T dtdz = (tsno[k] - tsno[k + 1]) / divs(dzs[k] + dzs[k + 1], 2.0);
    const T half_dz = divs(dzs[k + 1], 2.0);
    const T t_up = tsno[k + 1];
    const T hq = divs(dtdz * half_dz, 2.0);
    const T t_low = t_up - hq;
    // the reference's warm check differs across the rungs (impl:1041,
    // 1118, 1194)
    const bool warm = k == 1 ? t_up >= T(K.tfrz) : t_low >= T(K.tfrz);
    if (split) {
      dzs[k + 1] = dzs[k + 2] = half_dz;
      swice[k + 1] = swice[k + 2] = divs(swice[k + 1], 2.0);
      swliq[k + 1] = swliq[k + 2] = divs(swliq[k + 1], 2.0);
      tsno[k + 2] = warm ? t_up : t_low;
      tsno[k + 1] = warm ? t_up : t_up + hq;
      UNROLL for (int s = 0; s < kSpecies; ++s)
        ms[s][k + 1] = ms[s][k + 2] = divs(ms[s][k + 1], 2.0);
      rds[k + 2] = rds[k + 1];
      msno = k + 3;
    }
  }
  // back to the bottom-anchored layout (impl:1263-1284)
  P.snl = msno;
  const int top_new = kSno - msno;
  T dzb[kSno];
  UNROLL for (int k = 0; k < kSno; ++k) dzb[k] = dzs[k] / fs_safe;
  UNROLL for (int p = 0; p < kSno; ++p) {
    const int back = p - top_new;
    if (back >= 0) {
      P.dz[p] = pick(dzb, back);
      P.ice[p] = pick(swice, back);
      P.liq[p] = pick(swliq, back);
      P.t[p] = pick(tsno, back);
      P.rds[p] = pick(rds, back);
      UNROLL for (int s = 0; s < kSpecies; ++s) P.mss[s][p] = pick(ms[s], back);
    }
  }
  rebuild_mesh(P);
}

// ---- 10: snow aging (snow_hydrology_impl.hh:80-225) ------------------------

template <typename T>
HD void aging_pinned(const Pack<T>& P, T h2osno, const Consts& K,
                     T (&out)[kSno]) {
  const int top = kSno - P.snl;
  const bool layered = P.snl > 0;
  UNROLL for (int p = 0; p < kSno; ++p) {
    const bool active = p >= top && layered;
    out[p] = active ? T(K.rds_min) : (layered ? T(0) : P.rds[p]);
  }
  if (P.snl == 0 && h2osno > T(0)) out[kSno - 1] = T(K.rds_min);
}

template <typename T>
HD void aging_elm(const Column<T>& C, const Pack<T>& P, bool cap, T frac_sno,
                  T h2osno, T (&out)[kSno]) {
  const Args<T>& A = C.A;
  const Consts& K = A.K;
  const double dtime = A.dtime;
  const int top = kSno - P.snl;
  const bool layered = P.snl > 0;
  const T fs = frac_sno;
  const T newsnow =
      nmax((cap ? C.in(iSnwcpIce) : C.in(iSnowGrnd)) * T(dtime), T(0));
  UNROLL for (int p = 0; p < kSno; ++p) {
    const T liq = P.liq[p], ice = P.ice[p], t = P.t[p], dz = P.dz[p];
    const T h = liq + ice;
    const T h_safe = h != T(0) ? h : T(1);
    // temperatures at the layer's top and bottom interfaces
    const T t_m1 = p == 0 ? P.t[0] : P.t[p > 0 ? p - 1 : 0];
    const T dz_m1 = p == 0 ? P.dz[0] : P.dz[p > 0 ? p - 1 : 0];
    const T t_p1 = P.t[p + 1], dz_p1 = P.dz[p + 1];
    const T sb = dz + dz_p1, st = dz + dz_m1;
    const T den_b = sb != T(0) ? sb : T(1);
    const T den_t = st != T(0) ? st : T(1);
    const bool at_top = p == top;
    const T t_top_itf = at_top ? t : (t_m1 * dz + t * dz_m1) / den_t;
    const T t_btm_itf = (t_p1 * dz + t * dz_p1) / den_b;
    const T cdz = fs * dz;
    const T cdz_safe = cdz != T(0) ? cdz : T(1);
    const T dTdz = fabs((t_top_itf - t_btm_itf) / cdz_safe);
    const T rhos = nmax(h / cdz_safe, T(50.0));
    const int ti = table_index(divs(t - T(223.0), 5.0), A.n_t - 1);
    const int gi = table_index(divs(dTdz, 10.0), A.n_tgrd - 1);
    const int ri = table_index(divs(rhos - T(50.0), 50.0), A.n_rhos - 1);
    const long long at = (static_cast<long long>(ti) * A.n_tgrd + gi) *
                             A.n_rhos + ri;
    const T tau = load(&A.tau[at]), kappa = load(&A.kappa[at]);
    const T drdt0 = load(&A.drdt0[at]);
    const T rds = P.rds[p];
    T dr_fresh = rds - T(K.rds_min);
    dr_fresh = fabs(dr_fresh) < T(1.0e-8) ? T(0) : dr_fresh;
    const T kappa_safe = kappa != T(0) ? kappa : T(1);
    T dr = (drdt0 * tpow(tau / (dr_fresh + tau), T(1) / kappa_safe)) *
           T(dtime / 3600.0);
    const T frc_liq = nmin(liq / h_safe, T(0.1));
    const T rds_safe = rds != T(0) ? rds : T(1);
    const T dr_wet =
        T(1.0e18) * ((T(dtime) * (T(4.22e-13) * ((frc_liq * frc_liq) *
                                                  frc_liq))) /
                     (T(4.0 * K.pi) * (rds_safe * rds_safe)));
    dr = dr + dr_wet;
    const T refrz = nmax(C.lay(lSnofrz, p) * T(dtime), T(0));
    T frc_refrz = refrz / h_safe;
    T frc_new = at_top ? newsnow / h_safe : T(0);
    const T both = frc_refrz + frc_new;
    const bool over = both > T(1);
    const T tot = both != T(0) ? both : T(1);
    frc_refrz = over ? frc_refrz / tot : frc_refrz;
    frc_new = over ? T(1) - frc_refrz : frc_new;
    const T frc_old = over ? T(0) : (T(1) - frc_refrz) - frc_new;
    T r = ((rds + dr) * frc_old + T(K.rds_min) * frc_new) +
          T(1000.0) * frc_refrz;
    r = r < T(K.rds_min) ? T(K.rds_min) : r;
    r = r > T(K.rds_max) ? T(K.rds_max) : r;
    const bool active = p >= top && layered;
    out[p] = active ? r : (layered ? T(0) : rds);
  }
  if (P.snl == 0 && h2osno > T(0)) out[kSno - 1] = T(K.rds_min);
}

// ---- the block, one column ---------------------------------------------------

template <typename T, bool ELM>
HD void run_column(const Args<T>& A, long long i) {
  const Column<T> C{A, i};
  const Consts& K = A.K;
  const int L = A.nlevtot;
  Pack<T> P;
  P.snl = static_cast<int>(A.snl[i]);
  const int snl0 = P.snl;
  UNROLL for (int p = 0; p <= kSno; ++p) {
    P.t[p] = C.lay(lT, p);
    P.ice[p] = C.lay(lIce, p);
    P.liq[p] = C.lay(lLiq, p);
    P.dz[p] = C.lay(lDz, p);
    P.zi[p] = C.lay(lZi, p);
  }
  UNROLL for (int p = 0; p < kSno; ++p) {
    P.z[p] = C.lay(lZ, p);
    P.rds[p] = C.lay(lSnwRds, p);
    UNROLL for (int k = 0; k < kSpecies; ++k) P.mss[k][p] = C.lay(lMss + k, p);
  }
  const bool cap = A.do_capsnow[i * A.capsnow_stride] != 0;
  const bool soil_like = A.soil_like[i * A.soil_like_stride] != 0;
  const bool soil_crop = A.soil_crop[i * A.soil_crop_stride] != 0;
  const T fse = C.in(iFse);

  // 1-3: percolation, deposition, BC phase change
  const Water<T> W = snow_water(C, P, cap, fse);
  aerosols_in(C, P);
  // 4: compaction
  compaction(C, P, W.frac_sno, W.int_snow, soil_crop);
  // 5: combine
  Combined<T> R = combine(C, P, soil_like, fse, W.frac_sno, W.int_snow);
  // 6: ELM combines only over the snowc filter (columns with snow layers):
  // a layerless column passes its pack scalars through
  if (snl0 == 0) {
    R.h2osno = C.in(iH2osno);
    R.snow_depth = C.in(iSnowDepth);
    R.frac_sno = W.frac_sno;
    R.fse = fse;
    R.int_snow = W.int_snow;
    R.qsl = T(0);
    R.qs2t = T(0);
    R.mflx = T(0);
  }
  // 7-8: divide, prune the inactive layers
  divide(P, R.frac_sno, K);
  const int top = kSno - P.snl;
  UNROLL for (int p = 0; p < kSno; ++p) {
    if (p < top) {
      P.t[p] = P.ice[p] = P.liq[p] = P.dz[p] = P.z[p] = P.zi[p] = T(0);
    }
  }
  // 10: aging (before 9 here: it reads no aerosol)
  T rds_out[kSno];
  if (ELM) {
    aging_elm(C, P, cap, R.frac_sno, R.h2osno, rds_out);
  } else {
    aging_pinned(P, R.h2osno, K, rds_out);
  }

  // outputs
  A.snl_out[i] = P.snl;
  T* const* o = A.out;
  o[oH2osno][i] = R.h2osno;
  o[oSnowDepth][i] = R.snow_depth;
  o[oFracSno][i] = R.frac_sno;
  o[oFse][i] = R.fse;
  o[oIntSnow][i] = R.int_snow;
  o[oSnowMelt][i] = W.snow_melt;
  o[oTopSoil][i] = W.top_soil;
  o[oSlTopSoil][i] = R.qsl;
  o[oSnow2topsoi][i] = R.qs2t;
  o[oMflxSnowlyr][i] = R.mflx;
  o[oMflxNeg][i] = W.mflx_neg;
  T* const* q = A.lay_out;
  const long long r = i * L, rz = i * (L + 1), r5 = i * kSno;
  UNROLL for (int p = 0; p < kSno; ++p) {
    q[qT][r + p] = P.t[p];
    q[qIce][r + p] = P.ice[p];
    q[qLiq][r + p] = P.liq[p];
    q[qDz][r + p] = P.dz[p];
    q[qZ][r + p] = P.z[p];
    q[qZi][rz + p] = P.zi[p];
    q[qRds][r5 + p] = rds_out[p];
  }
  q[qIce][r + kSno] = P.ice[kSno];
  q[qLiq][r + kSno] = P.liq[kSno];
  q[qT][r + kSno] = P.t[kSno];
  q[qDz][r + kSno] = P.dz[kSno];
  q[qZ][r + kSno] = C.lay(lZ, kSno);
  q[qZi][rz + kSno] = P.zi[kSno];
  // the soil rows pass through (snow_water adds 0 to the liquid twice)
  for (int p = kSno + 1; p < L; ++p) {
    q[qT][r + p] = C.lay(lT, p);
    q[qIce][r + p] = C.lay(lIce, p);
    q[qLiq][r + p] = (C.lay(lLiq, p) + T(0)) + T(0);
    q[qDz][r + p] = C.lay(lDz, p);
    q[qZ][r + p] = C.lay(lZ, p);
    q[qZi][rz + p] = C.lay(lZi, p);
  }
  q[qZi][rz + L] = C.lay(lZi, L);
  // 9: snow-cap rescaling of the masses and the concentrations
  // (aerosol_physics_impl.hh:63-107)
  const T cap_add = C.in(iSnwcpIce) * T(A.dtime);
  UNROLL for (int p = 0; p < kSno; ++p) {
    const bool above = p < top;
    const T snowmass = above ? T(1.0e-12) : P.ice[p] + P.liq[p];
    const T scl = (p == top && cap) ? snowmass / (snowmass + cap_add)
                                    : (above ? T(0) : T(1));
    UNROLL for (int k = 0; k < kSpecies; ++k) {
      const T m = P.mss[k][p] * scl;
      q[qMss + k][r5 + p] = m;
      q[qCnc + k][r5 + p] = m / snowmass;
    }
  }
}

template <typename T>
Args<T> make_args(long long n, const void* const* in,
                  const long long* in_stride, const void* const* lay,
                  const long long* lay_stride, const void* snl,
                  const void* do_capsnow, long long capsnow_stride,
                  const void* imelt, long long imelt_stride,
                  const void* soil_like, long long soil_like_stride,
                  const void* soil_crop, long long soil_crop_stride,
                  const void* tau, const void* kappa, const void* drdt0,
                  int n_t, int n_tgrd, int n_rhos, int nlevtot, double dtime,
                  const double* consts, void* snl_out, void* const* out,
                  void* const* lay_out) {
  Args<T> A;
  A.n = n;
  for (int k = 0; k < kIn; ++k) {
    A.in[k] = static_cast<const T*>(in[k]);
    A.in_stride[k] = in_stride[k];
  }
  for (int k = 0; k < kLay; ++k) {
    A.lay[k] = static_cast<const T*>(lay[k]);
    A.lay_stride[k] = lay_stride[k];
  }
  A.snl = static_cast<const long long*>(snl);
  A.do_capsnow = static_cast<const long long*>(do_capsnow);
  A.capsnow_stride = capsnow_stride;
  A.imelt = static_cast<const long long*>(imelt);
  A.imelt_stride = imelt_stride;
  A.soil_like = static_cast<const unsigned char*>(soil_like);
  A.soil_like_stride = soil_like_stride;
  A.soil_crop = static_cast<const unsigned char*>(soil_crop);
  A.soil_crop_stride = soil_crop_stride;
  A.tau = static_cast<const T*>(tau);
  A.kappa = static_cast<const T*>(kappa);
  A.drdt0 = static_cast<const T*>(drdt0);
  A.n_t = n_t;
  A.n_tgrd = n_tgrd;
  A.n_rhos = n_rhos;
  A.nlevtot = nlevtot;
  A.dtime = dtime;
  double* k = reinterpret_cast<double*>(&A.K);
  for (int j = 0; j < kConsts; ++j) k[j] = consts[j];
  A.snl_out = static_cast<long long*>(snl_out);
  for (int j = 0; j < kOut; ++j) A.out[j] = static_cast<T*>(out[j]);
  for (int j = 0; j < kLayOut; ++j) A.lay_out[j] = static_cast<T*>(lay_out[j]);
  return A;
}

#ifdef __CUDACC__

constexpr int kThreads = 128;

template <typename T, bool ELM>
__global__ void __launch_bounds__(kThreads)
    snow_kernel(const Args<T> A) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < A.n) run_column<T, ELM>(A, i);
}

template <typename T>
int launch(int elm, const Args<T>& A, cudaStream_t s) {
  if (A.n <= 0) return cudaSuccess;
  const unsigned grid =
      static_cast<unsigned>((A.n + kThreads - 1) / kThreads);
  if (elm) {
    snow_kernel<T, true><<<grid, kThreads, 0, s>>>(A);
  } else {
    snow_kernel<T, false><<<grid, kThreads, 0, s>>>(A);
  }
  return static_cast<int>(cudaGetLastError());
}

// {threads a block, registers a thread, local memory bytes a thread
// (spills), resident blocks an SM}
template <typename T, bool ELM>
int layout_of(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, snow_kernel<T, ELM>);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, snow_kernel<T, ELM>, kThreads, 0);
  if (err != cudaSuccess) return err;
  out[0] = kThreads;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = per_sm;
  return cudaSuccess;
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// in: kIn pointers (IN_FIELDS order) and their strides in elements (0: one
// value for every column); lay: kLay pointers (LAYER_FIELDS order) and
// their row strides; snl int64 [n]; do_capsnow int64 with its stride;
// imelt int64 [n, >= 5] with its row stride; soil_like, soil_crop uint8
// with their strides; the aging tables [n_t, n_tgrd, n_rhos]; consts:
// kConsts doubles (CONSTS order); snl_out int64 [n]; out: kOut [n]
// pointers (OUT_FIELDS); lay_out: kLayOut pointers (contiguous: t, ice,
// liq, dz, z [n, nlevtot], zi [n, nlevtot + 1], snw_rds, masses,
// concentrations [n, 5]).  elm: ELM's aging (else the pinned radius).
// Launches on `stream`; returns the first CUDA error.
#define SNOW_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(                                                        \
      int elm, long long n, const void* const* in,                            \
      const long long* in_stride, const void* const* lay,                     \
      const long long* lay_stride, const void* snl, const void* do_capsnow,   \
      long long capsnow_stride, const void* imelt, long long imelt_stride,    \
      const void* soil_like, long long soil_like_stride,                      \
      const void* soil_crop, long long soil_crop_stride, const void* tau,     \
      const void* kappa, const void* drdt0, int n_t, int n_tgrd, int n_rhos,  \
      int nlevtot, double dtime, const double* consts, void* snl_out,         \
      void* const* out, void* const* lay_out, void* stream) {                 \
    const Args<T> A = make_args<T>(                                           \
        n, in, in_stride, lay, lay_stride, snl, do_capsnow, capsnow_stride,   \
        imelt, imelt_stride, soil_like, soil_like_stride, soil_crop,          \
        soil_crop_stride, tau, kappa, drdt0, n_t, n_tgrd, n_rhos, nlevtot,    \
        dtime, consts, snl_out, out, lay_out);                                \
    return launch<T>(elm, A, static_cast<cudaStream_t>(stream));              \
  }
SNOW_ENTRY(snow_hydrology_f64, double)
SNOW_ENTRY(snow_hydrology_f32, float)
#undef SNOW_ENTRY

// What K5's launch uses on the current device, float64 if `f64`, ELM's
// aging if `elm`: out = {threads a block, registers a thread, local memory
// bytes a thread, resident blocks an SM}.  Returns a CUDA error code.
extern "C" int snow_hydrology_layout(int f64, int elm, int* out) {
  switch ((f64 != 0) * 2 + (elm != 0)) {
    case 0: return layout_of<float, false>(out);
    case 1: return layout_of<float, true>(out);
    case 2: return layout_of<double, false>(out);
    case 3: return layout_of<double, true>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#endif  // __CUDACC__
