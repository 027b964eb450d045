// K7: the soil temperature module of the step, one thread a column: the
// surface heat fluxes and their derivative, the diffusive heat flux and
// the matrix factor, the Crank-Nicolson system of the snow, surface-water
// and soil layers and its pentadiagonal solve, the new temperatures, the
// freezing of standing surface water, the melt and freeze of the snow and
// soil layers (thin snow, supercooled soil water, the round-off guard) and
// the ground temperature.
//
// Replaces: the chain elmkernels_torch/driver/step.py ran after
// soil_thermal.thermal_properties (the JAX package's driver/step.py
// 588-637): calc_surface_heat_flux, calc_dhsdT, calc_diffusive_heat_flux,
// calc_heat_flux_matrix_factor, _assemble_system, K4's solve,
// update_temperature, phase_change_h2osfc, phase_change_soisno and
// update_t_grnd of physics/soil_temperature.py, several hundred masked
// full-width operations over [ncol, 20] and [ncol, 21, 5] arrays
// (soil_temperature_block_plain).  Reference: soil_temperature_impl.hh,
// soil_temp_lhs_impl.hh, soil_temp_rhs_impl.hh,
// pentadiagonal_solver_impl.hh, phase_change_impl.hh.
//
// Bound: bytes.  A column reads ~1.9 KB (float64: 25 scalars, t, ice, liq,
// dz, z, tk and cv [20], zi [21], sabg_lyr [6], watsat, sucsat and bsw
// [15]) and writes ~0.95 KB (14 scalars, fact, t, ice, liq [20], imelt
// [20] int64, qflx_snofrz_lyr [5]) for a few thousand operations.  So:
// - A block of kB columns, one thread each, stages the rows it reads in
//   full through shared memory by cp.async (column_kernel.cuh's TileWalk:
//   consecutive threads read consecutive addresses), in two phases: t, z,
//   tk and cv before the solve; ice and liq into z's and tk's slots once
//   the forward sweep has read them, while the back substitution runs.
//   The outputs leave the same way, each row whole.  Slot s of column r
//   lies at [s * kLd + r].
// - The system never reaches memory: row i of it needs z, tk, fact, t and
//   the diffusive flux of rows i - 1, i and i + 1 only, so it is assembled
//   row by row into the forward sweep (pdma_row.cuh, K4's recurrence).
//   The sweep's A, B and Z (3 x 21) sit in the thread's slots; the back
//   substitution leaves x in Z's.
// - Of the rows a column reads only in a few places (dz and zi at the top
//   layer, sabg_lyr at the active snow rows and the top soil row, dz,
//   watsat, sucsat and bsw at soil layers below freezing) each thread
//   loads what it needs straight from the inputs.
// - Work whose result the plain chain throws away by a select (the
//   branches of every torch.where, the phase change of a layer that does
//   not change phase) is not done: every output keeps its bits.
//
// The arithmetic is the plain chain's, operation by operation and in its
// order (build with --fmad=false), as PyTorch's elementwise kernels compute
// each operation on the card:
// - a Python number meets a tensor rounded to T (`T(k)`); tensor / number
//   multiplies by the number's reciprocal (divs); number / tensor is
//   PyTorch's reciprocal(tensor) * number, which rounds as one division
//   for 1.0 and -1.0, and rdiv's full_like(tensor, number) / tensor is one
//   division;
// - x ** 3.0 is (x * x) * x; x ** 4.0 and the tensor power of the
//   supercooled water are pow, float64's from snow_math.cu (compiled with
//   contraction on, as PyTorch's kernels are), float32's inline; clamp and
//   minimum propagate NaN (nmin, nmax);
// - torch.sum over the 20 layers adds as PyTorch's reduction does on the
//   card (sum20: 16 lanes, halving shuffles); on the CPU in order.  (The
//   chain's third sum, qflx_snofrz over the 5 snow layers, and
//   eflx_snomelt are not computed: the step reads neither.)
//
// The same source built by a host compiler (the device code is HD inline
// functions; the kernel and its launch sit under __CUDACC__) is what the
// CPU tests run, one column at a time (run_column: a block of one column,
// whose slots are a plain array).

#include "column_kernel.cuh"
#include "pdma_row.cuh"

// A store to an output (the host tests count them through this hook)
#ifndef K7_STORE
#define K7_STORE(ptr, v) (*(ptr) = (v))
#endif

namespace {

constexpr int kSno = 5;    // NLEVSNO
constexpr int kLev = 20;   // NLEVTOT
constexpr int kRows = kLev + 1;  // the system's rows: snow, surface water, soil

// ---- the per-column [ncol] inputs, in ops/soil_temperature.py's IN_FIELDS
// order -----------------------------------------------------------------------
enum {
  iFse, iFracSno, iFh2osfc, iH2osfc, iH2osno, iIntSnow, iSnowDepth, iTgrnd,
  iTh2osfc, iSabgSnow, iSabgSoil, iDlrad, iEmg, iForcLwrad, iHtvp, iShSoil,
  iEvSoil, iShH2osfc, iEvH2osfc, iShSnow, iEvSnow, iCgrnd, iDzH2osfc,
  iCH2osfc, iTkH2osfc, kIn
};
// the layered inputs ([ncol, L] with a row stride), LAYER_FIELDS' order:
// L is 20 for the first eight (zi: 21), 6 for sabg_lyr, 15 for the soil's
enum {
  lT, lLiq, lIce, lDz, lZ, lZi, lTk, lCv, lSabg, lWatsat, lSucsat, lBsw, kLay
};
// the [ncol] outputs, OUT_FIELDS' order
enum {
  oSabgChk, oDhsdT, oTgrnd, oTh2osfc, oH2osfc, oIntSnow, oH2osno,
  oSnowDepth, oXmfH2osfc, oH2osfcToIce, oH2osfcToSnow, oXmf, oSnomelt,
  oSnowMelt, kOut
};
// the layered floating outputs: fact, t_soisno, h2osoi_ice, h2osoi_liq
// [ncol, 20], qflx_snofrz_lyr [ncol, 5] (imelt [ncol, 20] int64 apart)
enum { qFact, qT, qIce, qLiq, qSnofrz, kLayOut };

// A column's slots.  t holds the old temperatures, then the new ones; z
// and tk are read by the forward sweep and then take ice and liq; cv
// becomes fact; A, B and Z the sweep's (x replaces Z), then the terms of
// the two sums over the layers (A's, B's) and qflx_snofrz_lyr (x's).
enum {
  sT = 0, sZ = sT + kLev, sTk = sZ + kLev, sF = sTk + kLev,
  sA = sF + kLev, sB = sA + kRows, sX = sB + kRows, kSlots = sX + kRows,
  sIce = sZ, sLiq = sTk
};

// Python-level constants, in ops/soil_temperature.py's CONSTS order
struct Consts {
  double tfrz, stebol, hfus, grav, denice, cpwat, cnfac, capr;
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
  const long long* snl;          // [n]
  const long long* fveg;         // frac_veg_nosno [n], or one value
  long long fveg_stride;
  const unsigned char* scmask;   // the supercooled-water land mask
  long long scmask_stride;
  double dtime;
  Consts K;
  T* out[kOut];
  T* lay_out[kLayOut];
  long long* imelt;              // [n, 20]
};

// torch.sum(x, dim=1) over the 20 layers: on the card 16 lanes of
// PyTorch's reduction take x0 + x16, ..., x3 + x19, x4, ..., x15, and four
// shuffles at halving offsets (8, 4, 2, 1) add them; on the CPU in order
template <typename T, typename F>
HD T sum20(F&& x) {
#ifdef __CUDA_ARCH__
  const T a0 = (x(0) + x(16)) + x(8), a1 = (x(1) + x(17)) + x(9);
  const T a2 = (x(2) + x(18)) + x(10), a3 = (x(3) + x(19)) + x(11);
  const T a4 = x(4) + x(12), a5 = x(5) + x(13), a6 = x(6) + x(14);
  const T a7 = x(7) + x(15);
  return ((a0 + a4) + (a2 + a6)) + ((a1 + a5) + (a3 + a7));
#else
  T s = x(0);
  for (int l = 1; l < kLev; ++l) s = s + x(l);
  return s;
#endif
}

// clamp(x, min=1e-300)'s bound in T: PyTorch converts the bound to the
// tensor's type, which rounds it to 0 in float32
template <typename T>
HD T smp_floor();
template <>
HD double smp_floor<double>() { return 1e-300; }
template <>
HD float smp_floor<float>() { return 0.0f; }

// ---- the block ---------------------------------------------------------------

// The block's shared arrays: slot s of the block's row r at
// slots[s * ld + r]; imelt at layer l of row r at melt[l * mld + r]
template <typename T>
struct Tile {
  const Args<T>& A;
  long long i0;   // the block's first column
  int rows;       // its columns (the last block may have fewer than kB)
  int tid, nt;    // this thread, of nt
  T* slots;
  unsigned char* melt;
  int ld, mld;

  HD const T* row(int k, int r) const {
    return A.lay[k] + (i0 + r) * A.lay_stride[k];
  }
  // the positions [0, kLev) of layered input k into slots s0 + p
  // (cp.async)
  HD void stage(int k, int s0) const {
    for_tile(tid, nt, rows, 0, kLev, [&](int r, int p) {
      async_copy(slots + (s0 + p) * ld + r, row(k, r) + p);
    });
  }
  // slots s0 + p of every row into positions [0, w) of output q (row
  // width w)
  HD void store(int q, int s0, int w) const {
    T* out = A.lay_out[q] + i0 * w;
    tile_pass<T>(tid, nt, rows, 0, w,
                 [&](int r, int p) { return slots[(s0 + p) * ld + r]; },
                 [&](int r, int p, T v) { K7_STORE(out + r * w + p, v); });
  }
  HD void store_imelt() const {
    long long* out = A.imelt + i0 * kLev;
    tile_pass<long long>(
        tid, nt, rows, 0, kLev,
        [&](int r, int p) {
          return static_cast<long long>(melt[p * mld + r]);
        },
        [&](int r, int p, long long v) { K7_STORE(out + r * kLev + p, v); });
  }
};

// One column: its inputs and its slots
template <typename T>
struct Column {
  const Args<T>& A;
  long long i;
  T* s;
  int ld;
  HD T in(int k) const { return load(&A.in[k][i * A.in_stride[k]]); }
  HD T lay(int k, int p) const {
    return load(A.lay[k] + i * A.lay_stride[k] + p);
  }
  HD T& operator[](int k) const { return s[k * ld]; }
};

// One row of the system: bands d0 (2nd super) .. d4 (2nd sub), rhs r
template <typename T>
struct Row {
  T d0, d1, d2, d3, d4, r;
};

// What the solve needs of a column besides its slots
template <typename T>
struct Surface {
  int snl, top;
  T fse, fh, dhsdT, hs_top_snow, hs_soil, hs_h2osfc, t_h2osfc;
  T dz_h2osfc, c_h2osfc, tk_h2osfc;
};

// calc_surface_heat_flux (soil_temperature_impl.hh:15-28)
template <typename T>
HD T surface_heat_flux(const Column<T>& C, T one_m_fveg, T solar, T temp,
                       T sh, T ev) {
  const Consts& K = C.A.K;
  const T emg = C.in(iEmg);
  const T emit = (emg * T(K.stebol)) * tpow(temp, T(4.0));
  return (((solar + C.in(iDlrad)) + ((one_m_fveg * emg) * C.in(iForcLwrad))) -
          emit) -
         (sh + ev * C.in(iHtvp));
}

// calc_heat_flux_matrix_factor: fact into cv's slots
template <typename T>
HD void matrix_factor(const Column<T>& C, int top) {
  const Consts& K = C.A.K;
  for (int l = 0; l < kLev; ++l) {
    const T cv = C[sF + l];
    T fact = T(0);
    if (l >= top) {
      const T base = T(C.A.dtime) / (cv != T(0) ? cv : T(1));
      fact = base;
      if (l == top) {
        const T z = C[sZ + l], zi = C.lay(lZi, l);
        const T z_p1 = C[sZ + (l + 1 < kLev ? l + 1 : l)];
        fact = (base * C.lay(lDz, l)) /
               (T(0.5) * ((z - zi) + T(K.capr) * (z_p1 - zi)));
      }
    }
    C[sF + l] = fact;
  }
}

// calc_diffusive_heat_flux fn(l): between layers l and l + 1, 0 above the
// top layer and at the bottom
template <typename T>
HD T diffusive_flux(const Column<T>& C, int top, int l) {
  if (l >= kLev - 1 || l < top) return T(0);
  return (C[sTk + l] * (C[sT + l + 1] - C[sT + l])) /
         (C[sZ + l + 1] - C[sZ + l]);
}

// Row r of the system (_assemble_system): snow rows 0-4, the surface water
// row 5, the soil rows 6-20 (layer r - 1); identity rows above the top
template <typename T>
HD Row<T> system_row(const Column<T>& C, const Surface<T>& U, int r) {
  const double cn = C.A.K.cnfac;
  const T h = T(1.0 - cn), mh = T(-(1.0 - cn)), c = T(cn);
  const T one = T(1), dhsdT = U.dhsdT;
  Row<T> R{T(0), T(0), T(1), T(0), T(0), T(0)};
  if (r < U.top) return R;
  if (r < kSno) {
    // snow layer r (snl > 0 here)
    const int m1 = r > 0 ? r - 1 : 0;
    const T z = C[sZ + r], dzp = C[sZ + r + 1] - z, dzm = z - C[sZ + m1];
    const T dzp_s = dzp != T(0) ? dzp : one, dzm_s = dzm != T(0) ? dzm : one;
    const T tk = C[sTk + r], tk_m1 = C[sTk + m1], f = C[sF + r];
    const T t = C[sT + r];
    if (r == U.top) {
      R.d2 = (one + ((h * f) * tk) / dzp_s) - f * dhsdT;
      R.d1 = U.snl > 1 ? ((mh * f) * tk) / dzp_s : T(0);
      R.r = t + f * ((U.hs_top_snow - dhsdT * t) +
                     c * diffusive_flux(C, U.top, r));
    } else {
      R.d2 = one + (h * f) * (tk / dzp_s + tk_m1 / dzm_s);
      R.d1 = r != kSno - 1 ? ((mh * f) * tk) / dzp_s : T(0);
      R.d3 = ((mh * f) * tk_m1) / dzm_s;
      R.r = (t + (c * f) * (diffusive_flux(C, U.top, r) -
                            diffusive_flux(C, U.top, r - 1))) +
            f * C.lay(lSabg, r);
    }
    if (r == kSno - 1) {
      R.d0 = ((mh * C[sF + r]) * C[sTk + r]) / (C[sZ + kSno] - C[sZ + r]);
    }
    return R;
  }
  const T den_sfc = T(0.5) * U.dz_h2osfc + C[sZ + kSno];
  if (r == kSno) {
    // standing surface water
    const T c_sfc = U.c_h2osfc != T(0) ? U.c_h2osfc : one;
    const T q = T(C.A.dtime) / c_sfc;
    R.d2 = (one + ((h * q) * U.tk_h2osfc) / den_sfc) - q * dhsdT;
    R.d1 = ((mh * q) * U.tk_h2osfc) / den_sfc;
    const T fn_h2osfc = (U.tk_h2osfc * (C[sT + kSno] - U.t_h2osfc)) / den_sfc;
    R.r = U.t_h2osfc +
          q * ((U.hs_h2osfc - dhsdT * U.t_h2osfc) + c * fn_h2osfc);
    return R;
  }
  // soil layer l
  const int l = r - 1;
  const T z = C[sZ + l];
  const T dzp = C[sZ + (l + 1 < kLev ? l + 1 : l)] - z;
  const T dzp_s = dzp != T(0) ? dzp : one;
  const T dzm = z - C[sZ + l - 1];
  const T tk = C[sTk + l], tk_m1 = C[sTk + l - 1], f = C[sF + l];
  const T t = C[sT + l];
  const T fn = diffusive_flux(C, U.top, l);
  const T fn_m1 = diffusive_flux(C, U.top, l - 1);
  if (l == kSno) {
    const T fse = U.fse;
    T d2;
    if (U.snl == 0) {
      d2 = (one + ((h * f) * tk) / dzp_s) - f * dhsdT;
      R.r = t + f * ((U.hs_top_snow - dhsdT * t) + c * fn);
    } else {
      d2 = (one + (h * f) * (tk / dzp_s + (fse * tk_m1) / dzm)) -
           ((one - fse) * f) * dhsdT;
      R.r = (t + f * ((one - fse) * (U.hs_soil - dhsdT * t) +
                      c * (fn - fse * fn_m1))) +
            (fse * f) * C.lay(lSabg, kSno);
      R.d4 = ((((-fse) * h) * f) * tk_m1) / dzm;
    }
    R.d2 = d2 + (U.fh != T(0) ? U.fh * (((h * f) * U.tk_h2osfc) / den_sfc +
                                         f * dhsdT)
                               : T(0));
    R.d1 = ((mh * f) * tk) / dzp_s;
    if (U.fh != T(0)) R.d3 = ((((-U.fh) * h) * f) * U.tk_h2osfc) / den_sfc;
    return R;
  }
  if (l == kLev - 1) {
    R.d2 = one + ((h * f) * tk_m1) / dzm;
    R.d3 = ((mh * f) * tk_m1) / dzm;
    R.r = (t - (c * f) * fn_m1) + f * fn;
    return R;
  }
  R.d2 = one + (h * f) * (tk / dzp_s + tk_m1 / dzm);
  R.d1 = ((mh * f) * tk) / dzp_s;
  R.d3 = ((mh * f) * tk_m1) / dzm;
  R.r = t + (c * f) * (fn - fn_m1);
  return R;
}

// The forward sweep over the 21 rows, each assembled as it is reached:
// A, B and Z into the slots
template <typename T>
HD void forward_sweep(const Column<T>& C, const Surface<T>& U) {
  Row<T> R = system_row(C, U, 0);
  PdmaAbz<T> p2 = pdma_row0(R.d0, R.d1, R.d2, R.r);
  C[sA] = p2.a;
  C[sB] = p2.b;
  C[sX] = p2.z;
  R = system_row(C, U, 1);
  PdmaAbz<T> p1 = pdma_row1(R.d0, R.d1, R.d2, R.d3, R.r, p2);
  C[sA + 1] = p1.a;
  C[sB + 1] = p1.b;
  C[sX + 1] = p1.z;
  for (int r = 2; r < kRows; ++r) {
    R = system_row(C, U, r);
    const PdmaAbz<T> p = pdma_row(R.d0, R.d1, R.d2, R.d3, R.d4, R.r, p2, p1);
    C[sA + r] = p.a;
    C[sB + r] = p.b;
    C[sX + r] = p.z;
    p2 = p1;
    p1 = p;
  }
}

// The back substitution: x into Z's slots
template <typename T>
HD void back_substitution(const Column<T>& C) {
  T x2 = C[sX + kRows - 1];
  T x1 = pdma_back1(PdmaAbz<T>{C[sA + kRows - 2], C[sB + kRows - 2],
                               C[sX + kRows - 2]},
                    x2);
  C[sX + kRows - 2] = x1;
  for (int r = kRows - 3; r >= 0; --r) {
    const T x = pdma_back(PdmaAbz<T>{C[sA + r], C[sB + r], C[sX + r]}, x1, x2);
    C[sX + r] = x;
    x2 = x1;
    x1 = x;
  }
}

// phase_change_h2osfc's results (phase_change_impl.hh:12-153)
template <typename T>
struct Pc1 {
  T t_h2osfc, h2osfc, xmf_h2osfc, to_ice, to_snow, h2osno, int_snow,
      snow_depth;
};

// Freezing of standing surface water into the snow pack; writes the
// bottom snow layer's ice and temperature into their slots
template <typename T>
HD Pc1<T> phase_change_h2osfc(const Column<T>& C, const Surface<T>& U,
                              T t_h2osfc) {
  const Consts& K = C.A.K;
  const double dtime = C.A.dtime;
  const T Tdt = T(dtime), tfrz = T(K.tfrz), one = T(1);
  const int snl = U.snl;
  const T fh = U.fh, dhsdT = U.dhsdT, ch = U.c_h2osfc;
  const T frac_sno = C.in(iFracSno), h2osfc = C.in(iH2osfc);
  const T h2osno = C.in(iH2osno), int_snow = C.in(iIntSnow);
  const T snow_depth = C.in(iSnowDepth);
  Pc1<T> P{t_h2osfc, h2osfc, T(0), T(0), T(0), h2osno, int_snow, snow_depth};
  if (!(fh > T(0) && t_h2osfc <= tfrz)) return P;
  const T tinc = tfrz - t_h2osfc;
  const T hm = fh * (dhsdT * tinc - divs(tinc * ch, dtime));
  const T xm = divs(hm * Tdt, K.hfus);
  const T temp1 = h2osfc + xm;
  const T z_avg = frac_sno * snow_depth;
  const T rho_avg = z_avg > T(0) ? nmin(h2osno / z_avg, T(800.0)) : T(200.0);
  const T ice_sl1 = C[sIce + kSno - 1], t_sl1 = C[sT + kSno - 1];
  const T f = C[sF + kSno - 1];
  const T fact_safe = f != T(0) ? f : one;
  const T c1 = snl == 1 ? frac_sno * (Tdt / fact_safe - dhsdT * Tdt)
                        : (frac_sno / fact_safe) * Tdt;
  const bool layered = frac_sno > T(0) && snl > 0;
  if (temp1 >= T(0)) {
    // partial freeze
    P.h2osno = h2osno - xm;
    P.int_snow = int_snow - xm;
    if (snl > 0) C[sIce + kSno - 1] = ice_sl1 - xm;
    P.h2osfc = h2osfc + xm;
    P.xmf_h2osfc = hm;
    P.to_ice = divs(-xm, dtime);
    const T den = rho_avg * frac_sno;
    P.snow_depth = layered ? (den != T(0) ? P.h2osno / den : T(0))
                           : divs(P.h2osno, K.denice);
    const T c2 =
        fh != T(0) ? T(-K.cpwat) * xm - (fh * dhsdT) * Tdt : T(0);
    const T den_t = c1 + c2 != T(0) ? c1 + c2 : one;
    const T t_new =
        snl == 0 ? tfrz : (c1 * t_sl1 + c2 * tfrz) / den_t;
    C[sT + kSno - 1] = t_new;
    P.to_snow = snl == 0 ? T(0) : divs((tfrz - t_new) * c2, dtime);
    P.t_h2osfc = tfrz;
  } else if (temp1 < T(0)) {
    // full freeze
    const T sum = h2osno + h2osfc;
    const T rho_f = (h2osno * rho_avg + h2osfc * T(K.denice)) /
                    (sum != T(0) ? sum : one);
    P.h2osno = h2osno + h2osfc;
    P.int_snow = int_snow + h2osfc;
    P.to_ice = divs(h2osfc, dtime);
    if (snl > 0) C[sIce + kSno - 1] = ice_sl1 + h2osfc;
    const T cooled = tfrz - (temp1 * T(K.hfus)) / (Tdt * dhsdT - ch);
    P.xmf_h2osfc = hm - divs((fh * temp1) * T(K.hfus), dtime);
    const T c2 = fh != T(0) ? fh * (ch - Tdt * dhsdT) : T(0);
    const T den_t = c1 + c2 != T(0) ? c1 + c2 : one;
    const T t_new = snl == 0 ? cooled : (c1 * t_sl1 + c2 * cooled) / den_t;
    C[sT + kSno - 1] = t_new;
    P.t_h2osfc = snl == 0 ? cooled : t_new;
    P.h2osfc = T(0);
    const T den = rho_f * frac_sno;
    P.snow_depth = layered ? (den != T(0) ? P.h2osno / den : T(0))
                           : divs(P.h2osno, K.denice);
  }
  return P;
}

// phase_change_soisno's [ncol] results (phase_change_impl.hh:184-417)
template <typename T>
struct Pc2 {
  T h2osno, snow_depth, xmf, snomelt, snow_melt;
};

// The melt and freeze of the snow and soil layers, layer by layer: the new
// temperatures, ice and liquid into their slots, imelt into its bytes,
// qflx_snofrz_lyr into x's slots and the two sums' terms into A's and B's
template <typename T>
HD Pc2<T> phase_change_soisno(const Column<T>& C, const Surface<T>& U,
                              unsigned char* melt, int mld, bool scmask,
                              T h2osno, T snow_depth) {
  const Consts& K = C.A.K;
  const double dtime = C.A.dtime;
  const T Tdt = T(dtime), tfrz = T(K.tfrz), hfus = T(K.hfus), one = T(1);
  const int snl = U.snl, top = U.top;
  const T fse = U.fse, fh = U.fh, dhsdT = U.dhsdT;
  const T fse_safe = fse != T(0) ? fse : one;
  const bool thin_pack = snl == 0 && h2osno > T(0);
  T xmf0 = T(0), snomelt0 = T(0);
  bool do_ts = false;
  for (int l = 0; l < kLev; ++l) {
    const bool active = l >= top, is_snow = l < kSno;
    const bool at_top = l == top, at_topsoil = l == kSno;
    T t = C[sT + l];
    const T ice = C[sIce + l], liq = C[sLiq + l], f = C[sF + l];
    int imelt = active && ice > T(0) && t > tfrz ? 1 : 0;
    // supercooled soil water (Zhao 1997, Koren 1999)
    T supercool = T(0);
    if (!is_snow && scmask && t < tfrz) {
      const int g = l - kSno;
      const T smp = ((hfus * (tfrz - t)) / (T(K.grav) * t)) * T(1000.0);
      const T e = -(one / C.lay(lBsw, g));
      supercool = ((C.lay(lWatsat, g) *
                    tpow(nmax(smp / C.lay(lSucsat, g), smp_floor<T>()), e)) *
                   C.lay(lDz, l)) *
                  T(1000.0);
    }
    if (active && t < tfrz && (is_snow ? liq > T(0) : liq > supercool))
      imelt = 2;
    if (thin_pack && at_topsoil && t > tfrz) imelt = 1;
    T hm = T(0);
    if (imelt > 0) {
      const T tinc = tfrz - t;
      t = tfrz;
      const T fs = f != T(0) ? f : one;
      if (at_top) {
        const T raw = dhsdT * tinc - tinc / fs;
        hm = is_snow ? fse * raw
                     : (fh != T(0) ? raw - (fh * dhsdT) * tinc : raw);
      } else if (at_topsoil) {
        hm = (((one - fse) - fh) * dhsdT) * tinc - tinc / fs;
      } else {
        hm = is_snow ? (-fse) * (tinc / fs) : (-tinc) / fs;
      }
      // the tridiagonal round-off guard
      if ((imelt == 1 && hm < T(0)) || (imelt == 2 && hm > T(0))) {
        hm = T(0);
        imelt = 0;
      }
    }
    const bool do_pc = imelt > 0 && fabs(hm) > T(0);
    T xm = divs(hm * Tdt, K.hfus);
    if (at_topsoil) {
      // thin snow on bare soil melts at the top soil layer
      do_ts = thin_pack && xm > T(0) && fabs(hm) > T(0) && imelt > 0;
      if (do_ts) {
        const T temp1 = h2osno;
        const T h2osno_new = nmax(temp1 - xm, T(0));
        const T propor = temp1 != T(0) ? h2osno_new / temp1 : T(0);
        const T heatr = hm - divs(hfus * (temp1 - h2osno_new), dtime);
        snomelt0 = divs(nmax(temp1 - h2osno_new, T(0)), dtime);
        xmf0 = hfus * snomelt0;
        h2osno = h2osno_new;
        snow_depth = snow_depth * propor;
        xm = heatr > T(0) ? divs(heatr * Tdt, K.hfus) : T(0);
        hm = heatr > T(0) ? heatr : T(0);
      }
    }
    // the ice and liquid
    T ice_new = ice, liq_new = liq, heatr = T(0);
    if (do_pc) {
      const T wmass0 = ice + liq;
      if (xm > T(0)) {
        ice_new = nmax(ice - xm, T(0));
      } else if (xm < T(0)) {
        ice_new = is_snow ? nmin(wmass0, ice - xm)
                          : (wmass0 < supercool
                                 ? T(0)
                                 : nmin(wmass0 - supercool, ice - xm));
      }
      if (xm != T(0)) heatr = hm - divs(hfus * (ice - ice_new), dtime);
      liq_new = nmax(wmass0 - ice_new, T(0));
    }
    // the residual heat's temperature change
    T adj = T(0);
    const bool apply = do_pc && fabs(heatr) > T(0);
    if (apply) {
      if (at_top) {
        adj = snl == 0 ? (f * heatr) / (one - ((one - fh) * f) * dhsdT)
                       : ((f / fse_safe) * heatr) / (one - f * dhsdT);
      } else if (at_topsoil) {
        adj = (f * heatr) / (one - (((one - fse) - fh) * f) * dhsdT);
      } else if (!is_snow) {
        adj = f * heatr;
      } else {
        adj = fse > T(0) ? (f / fse_safe) * heatr : T(0);
      }
    }
    t = t + adj;
    if (apply && is_snow && liq_new * ice_new > T(0)) t = tfrz;
    const T dice = do_pc ? ice - ice_new : T(0);
    C[sT + l] = t;
    C[sIce + l] = ice_new;
    C[sLiq + l] = liq_new;
    melt[l * mld] = static_cast<unsigned char>(imelt);
    C[sA + l] = divs(hfus * dice, dtime);
    C[sB + l] = imelt == 1 && is_snow && do_pc ? divs(nmax(dice, T(0)), dtime)
                                               : T(0);
    if (is_snow) {
      C[sX + l] = imelt == 2 && do_pc
                      ? divs(nmax(ice_new - ice, T(0)), dtime)
                      : T(0);
    }
  }
  Pc2<T> P;
  P.h2osno = h2osno;
  P.snow_depth = snow_depth;
  P.xmf = xmf0 + sum20<T>([&](int l) { return C[sA + l]; });
  P.snomelt = snomelt0 + sum20<T>([&](int l) { return C[sB + l]; });
  P.snow_melt = do_ts ? snomelt0 : T(0);
  return P;
}

// Columns i0 .. i0 + B.rows - 1, thread B.tid of B.nt computing column
// i0 + B.tid (if there is one).  Every thread runs every staging pass and
// reaches every barrier.
template <typename T>
HD void run_block(const Tile<T>& B) {
  const Args<T>& A = B.A;
  const Consts& K = A.K;
  const bool live = B.tid < B.rows;
  const long long i = B.i0 + B.tid;
  const Column<T> C{A, i, B.slots + B.tid, B.ld};
  T* const* o = A.out;

  B.stage(lT, sT);
  B.stage(lZ, sZ);
  B.stage(lTk, sTk);
  B.stage(lCv, sF);
  async_wait();
  block_sync();

  Surface<T> U{};
  if (live) {
    U.snl = static_cast<int>(A.snl[i]);
    U.top = kSno - U.snl;
    U.fse = C.in(iFse);
    U.fh = C.in(iFh2osfc);
    U.t_h2osfc = C.in(iTh2osfc);
    U.dz_h2osfc = C.in(iDzH2osfc);
    U.c_h2osfc = C.in(iCH2osfc);
    U.tk_h2osfc = C.in(iTkH2osfc);
    const T one = T(1);
    const T sabg_snow = C.in(iSabgSnow), sabg_soil = C.in(iSabgSoil);
    K7_STORE(o[oSabgChk] + i, U.fse * sabg_snow + (one - U.fse) * sabg_soil);
    // (1.0 - frac_veg_nosno) of the integer frac_veg_nosno: 0 or 1
    const T one_m_fveg =
        T(1.0 - static_cast<double>(A.fveg[i * A.fveg_stride]));
    U.hs_soil = surface_heat_flux(C, one_m_fveg, sabg_soil, C[sT + kSno],
                                  C.in(iShSoil), C.in(iEvSoil));
    U.hs_h2osfc = surface_heat_flux(C, one_m_fveg, sabg_soil, U.t_h2osfc,
                                    C.in(iShH2osfc), C.in(iEvH2osfc));
    U.hs_top_snow =
        surface_heat_flux(C, one_m_fveg, C.lay(lSabg, U.top), C[sT + U.top],
                          C.in(iShSnow), C.in(iEvSnow));
    const T tg = C.in(iTgrnd);
    U.dhsdT = -C.in(iCgrnd) -
              ((T(4.0) * C.in(iEmg)) * T(K.stebol)) * ((tg * tg) * tg);
    K7_STORE(o[oDhsdT] + i, U.dhsdT);
    matrix_factor(C, U.top);
    forward_sweep(C, U);
  }
  // z's and tk's slots take ice and liq while the back substitution runs
  block_sync();
  B.stage(lIce, sIce);
  B.stage(lLiq, sLiq);
  if (live) back_substitution(C);
  async_wait();
  block_sync();

  if (live) {
    // update_temperature: the active snow layers and the soil from x
    for (int l = 0; l < kLev; ++l) {
      if (l >= kSno) {
        C[sT + l] = C[sX + l + 1];
      } else if (l >= U.top) {
        C[sT + l] = C[sX + l];
      }
    }
    const T t_h2osfc = U.fh != T(0) ? C[sX + kSno] : C[sT + kSno];
    const Pc1<T> P1 = phase_change_h2osfc(C, U, t_h2osfc);
    const bool scmask = A.scmask[i * A.scmask_stride] != 0;
    const Pc2<T> P2 = phase_change_soisno(C, U, B.melt + B.tid, B.mld,
                                          scmask, P1.h2osno, P1.snow_depth);
    // update_t_grnd (soil_temperature_impl.hh:178-205)
    const T one = T(1), fse = U.fse, fh = U.fh, th = P1.t_h2osfc;
    const T t_sno = C[sT + U.top], t_soil = C[sT + kSno];
    const bool sfc = fh != T(0);
    T tg;
    if (U.snl > 0) {
      tg = sfc ? (fse * t_sno + ((one - fse) - fh) * t_soil) + fh * th
               : fse * t_sno + (one - fse) * t_soil;
    } else {
      tg = sfc ? (one - fh) * t_soil + fh * th : t_soil;
    }
    K7_STORE(o[oTgrnd] + i, tg);
    K7_STORE(o[oTh2osfc] + i, th);
    K7_STORE(o[oH2osfc] + i, P1.h2osfc);
    K7_STORE(o[oIntSnow] + i, P1.int_snow);
    K7_STORE(o[oXmfH2osfc] + i, P1.xmf_h2osfc);
    K7_STORE(o[oH2osfcToIce] + i, P1.to_ice);
    K7_STORE(o[oH2osfcToSnow] + i, P1.to_snow);
    K7_STORE(o[oH2osno] + i, P2.h2osno);
    K7_STORE(o[oSnowDepth] + i, P2.snow_depth);
    K7_STORE(o[oXmf] + i, P2.xmf);
    K7_STORE(o[oSnomelt] + i, P2.snomelt);
    K7_STORE(o[oSnowMelt] + i, P2.snow_melt);
  }
  block_sync();
  B.store(qFact, sF, kLev);
  B.store(qT, sT, kLev);
  B.store(qIce, sIce, kLev);
  B.store(qLiq, sLiq, kLev);
  B.store(qSnofrz, sX, kSno);
  B.store_imelt();
}

// One column on the host: a block of one thread, its slots a plain array
template <typename T>
void run_column(const Args<T>& A, long long i) {
  T slots[kSlots];
  unsigned char melt[kLev];
  run_block<T>(Tile<T>{A, i, 1, 0, 1, slots, melt, 1, 1});
}

template <typename T>
Args<T> make_args(long long n, const void* const* in,
                  const long long* in_stride, const void* const* lay,
                  const long long* lay_stride, const void* snl,
                  const void* fveg, long long fveg_stride, const void* scmask,
                  long long scmask_stride, double dtime, const double* consts,
                  void* const* out, void* const* lay_out, void* imelt) {
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
  A.fveg = static_cast<const long long*>(fveg);
  A.fveg_stride = fveg_stride;
  A.scmask = static_cast<const unsigned char*>(scmask);
  A.scmask_stride = scmask_stride;
  A.dtime = dtime;
  double* k = reinterpret_cast<double*>(&A.K);
  for (int j = 0; j < kConsts; ++j) k[j] = consts[j];
  for (int j = 0; j < kOut; ++j) A.out[j] = static_cast<T*>(out[j]);
  for (int j = 0; j < kLayOut; ++j) A.lay_out[j] = static_cast<T*>(lay_out[j]);
  A.imelt = static_cast<long long*>(imelt);
  return A;
}

// ---- the launch --------------------------------------------------------------

// Columns (threads) a block, and the stride of a slot in the block's
// shared arrays
constexpr int kB = 64;
constexpr int kLd = kB + 1;

// Dynamic shared memory a block: the slots, then imelt's bytes
template <typename T>
constexpr int smem_bytes() {
  return kSlots * kLd * static_cast<int>(sizeof(T)) + kLev * kB;
}

#ifdef __CUDACC__

// Resident blocks an SM asked of ptxas: three in float64 (3 x 75,640 B of
// the SM's 228 KB of shared memory), five in float32 (5 x 38,460 B)
template <typename T>
struct MinBlocks;
template <>
struct MinBlocks<double> {
  static constexpr int value = 3;
};
template <>
struct MinBlocks<float> {
  static constexpr int value = 5;
};

template <typename T>
__global__ void __launch_bounds__(kB, MinBlocks<T>::value)
    soil_temperature_kernel(const Args<T> A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long i0 = static_cast<long long>(blockIdx.x) * kB;
  const long long left = A.n - i0;
  const int rows = left < kB ? static_cast<int>(left) : kB;
  run_block<T>(Tile<T>{A, i0, rows, static_cast<int>(threadIdx.x), kB,
                       reinterpret_cast<T*>(smem),
                       smem + kSlots * kLd * sizeof(T), kLd, kB});
}

constexpr int kMaxDevices = 64;

// Sets the kernel's dynamic shared memory limit, once per device
template <typename T>
int prepare() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(soil_temperature_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<T>());
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <typename T>
int launch(const Args<T>& A, cudaStream_t s) {
  if (A.n <= 0) return cudaSuccess;
  const int err = prepare<T>();
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((A.n + kB - 1) / kB);
  soil_temperature_kernel<T><<<grid, kB, smem_bytes<T>(), s>>>(A);
  return static_cast<int>(cudaGetLastError());
}

// {threads a block, registers a thread, local memory bytes a thread
// (spills), resident blocks an SM, dynamic shared memory bytes a block}
template <typename T>
int layout_of(int* out) {
  cudaError_t err = static_cast<cudaError_t>(prepare<T>());
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, soil_temperature_kernel<T>);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, soil_temperature_kernel<T>, kB, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  out[0] = kB;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = per_sm;
  out[4] = smem_bytes<T>();
  return cudaSuccess;
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// in: kIn pointers (IN_FIELDS order) and their strides in elements (0: one
// value for every column); lay: kLay pointers (LAYER_FIELDS order) and
// their row strides; snl int64 [n]; frac_veg_nosno int64 and the
// supercooled-water mask uint8, each with its stride; consts: kConsts
// doubles (CONSTS order); out: kOut [n] pointers (OUT_FIELDS); lay_out:
// kLayOut pointers (contiguous: fact, t, ice, liq [n, 20], qflx_snofrz_lyr
// [n, 5]); imelt int64 [n, 20].  Launches on `stream`; returns the first
// CUDA error.
#define SOIL_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(long long n, const void* const* in,                    \
                      const long long* in_stride, const void* const* lay,    \
                      const long long* lay_stride, const void* snl,          \
                      const void* fveg, long long fveg_stride,               \
                      const void* scmask, long long scmask_stride,           \
                      double dtime, const double* consts, void* const* out,  \
                      void* const* lay_out, void* imelt, void* stream) {     \
    const Args<T> A = make_args<T>(n, in, in_stride, lay, lay_stride, snl,   \
                                   fveg, fveg_stride, scmask, scmask_stride, \
                                   dtime, consts, out, lay_out, imelt);      \
    return launch<T>(A, static_cast<cudaStream_t>(stream));                  \
  }
SOIL_ENTRY(soil_temperature_f64, double)
SOIL_ENTRY(soil_temperature_f32, float)
#undef SOIL_ENTRY

// What K7's launch uses on the current device, float64 if `f64`: out =
// {threads a block, registers a thread, local memory bytes a thread,
// resident blocks an SM, dynamic shared memory bytes a block}.  Returns a
// CUDA error code.
extern "C" int soil_temperature_layout(int f64, int* out) {
  return f64 ? layout_of<double>(out) : layout_of<float>(out);
}

#endif  // __CUDACC__
