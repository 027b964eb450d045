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
// Bound: bytes.  A column reads ~1.6 KB and writes ~1.6 KB (float64) for a
// few thousand operations; 41 % of those bytes are the soil rows (positions
// 6-19 of t, ice, liq, dz and z, 5-20 of zi), which pass through.  So the
// design moves the bytes as the card moves them best and keeps a thread's
// registers for the arithmetic:
// - A block of kB columns, one thread each, stages its rows through shared
//   memory.  Each layered field's tile is walked as one flat range
//   (TileWalk): element k is row k / w, position k % w of the w positions
//   read, so consecutive threads read consecutive addresses wherever the
//   row stride is the width (the step's fresh [n, 20] fields), and runs of
//   w elements where it is larger (a view of the packed carry).
// - The snow positions go to the block's shared memory by cp.async, which
//   passes through no register: a thread issues all of a phase's copies,
//   then waits once.  Slot s of column r lies at [s * kLd + r], kLd = kB +
//   13 (13 times 5 is 1 modulo 32, so the 5-position tiles fill and empty
//   without bank conflicts, and a thread reading its own slots never
//   conflicts).
// - The outputs leave the same way: each thread writes its results into
//   its slots, then the block stores each tile as one flat range, kBatch
//   elements in flight a thread; the [ncol] outputs leave as soon as they
//   are final.  The soil positions go from the input straight into the
//   same pass (the liquid as (x + 0) + 0, as snow_water's two additions of
//   0 give it), never through the thread that computes the column: each
//   output row is written whole at once, since sectors written in two
//   parts far apart in time cost the card several times their bytes (a
//   soil copy at the start took 0.38 ms for 0.10 ms of bytes).
// - Only the snow layers' ice and liq (positions 0-4), which every step of
//   the block reads, live in registers.  The temperatures, thicknesses,
//   aerosol masses and grain radii live in the thread's slots, where a
//   position chosen at run time is an index, not a select; imelt as one
//   byte a position.  The few fields a layer reads only where it compacts
//   and melts (swe_old, frac_iceold) or ages (the refreezing rates) come
//   straight from the inputs there.  z and zi (positions 0-4) are not
//   read: the block's last mesh rebuild sets every active position from
//   zi[5] and the thicknesses, and pruning zeroes the others, so they are
//   computed when the outputs are written.
// - The hot rows are staged, read into registers, and their slots then
//   take the cold state (kSlots slots a column), so that four blocks of 128
//   threads (16 warps, 128 registers a thread) fit on an SM in float64 with
//   no register spilled.
// - Work whose result the plain block throws away by a select on the
//   column (the flux of an inactive position, the rates of a layer that
//   does not compact, a merge that is not made, a rung of divide whose
//   layer is not thick, the aging of an inactive layer) is not done: every
//   output keeps its bits, and a column without snow layers (the July
//   site of the main path) runs little besides the staging.
// A position chosen at run time in the register arrays (the top layer, the
// merge partner, divide's top-anchored source) is reached by selects over
// the unrolled positions (pick, shift_down), never by an index, which would
// put the array in local memory.  divide_layers' ladder records each rung's
// proportions and flags, then replays them on one species' masses at a time.
//
// The arithmetic is the plain block's, operation by operation and in its
// order (build with --fmad=false), as PyTorch's elementwise kernels compute
// each operation on the card:
// - a Python number meets a tensor rounded to T (`T(k)`); a constant
//   Python folds (-1.0 / dtime, dtime / 3600.0, 4.0 * pi) is folded here
//   in double the same way;
// - tensor / number multiplies by the number's reciprocal, taken in double
//   and rounded to T, on the card, and divides on the CPU (divs);
// - x ** 3.0 and x ** 2.0 are products; a float64 tensor power comes from
//   snow_math.cu, compiled apart with contraction on as PyTorch's kernels
//   are, since the CUDA library's float64 pow rounds some inputs
//   differently without it; acos, exp and float32 pow round alike either
//   way (the same bits on 268 M inputs in K5's ranges, on the card) and are
//   inline, which keeps their call sites from costing registers; clamp,
//   minimum and maximum propagate NaN (nmin, nmax);
// - torch.sum over the 5 positions adds as PyTorch's reduction does on the
//   card (four lanes: ((x0 + x4) + x2) + (x1 + x3)) and torch.cumsum as its
//   Sklansky scan does; on the CPU both add in order (sum5, cumsum5_at).
//
// The same source built by a host compiler (the device code is HD inline
// functions; the kernel and its launch sit under __CUDACC__) is what the
// CPU tests run, one column at a time (run_column: a block of one column,
// whose slots are a plain array).

#include "column_kernel.cuh"

// A store to an output (the host tests count them through this hook)
#ifndef K5_STORE
#define K5_STORE(ptr, v) (*(ptr) = (v))
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

// A column's slots, in three uses.  First the hot rows as staged: ice and
// liq at positions 0-4; the thread reads them into registers.
enum { hIce = 0, hLiq = hIce + kSno, kHotSlots = hLiq + kSno };
// Then the cold state: the masses (species k at cMss + 5k), the grain radii,
// and, from the staging to the outputs, the temperatures and the
// thicknesses (positions 0-5), zi[5] and the top soil row's ice and liq
// (position 5)
enum { cMss = 0, cRds = cMss + kSpecies * kSno, cT = cRds + kSno,
       cDz = cT + kSno + 1, cZi5 = cDz + kSno + 1, cIce5 = cZi5 + 1,
       cLiq5 = cIce5 + 1, kSlots = cLiq5 + 1 };
// Last the layered outputs other than t and dz (which leave from cT and
// cDz), snw_rds (from cRds, where the aging leaves it) and the masses and
// concentrations (from cMss): ice and liq at positions 0-5, z and zi at 0-4
enum { rIce = 0, rLiq = rIce + kSno + 1, rZ = rLiq + kSno + 1,
       rZi = rZ + kSno, kOutSlots = rZi + kSno };
static_assert(int(kHotSlots) <= int(cT) && int(kOutSlots) <= int(cRds),
              "the hot rows leave cT and up alone, the outputs cRds and up");

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

// ---- elementwise arithmetic as PyTorch computes it (besides
// column_kernel.cuh's) ---------------------------------------------------

template <typename T>
HD T tacos(T x) {
  return acos(x);
}
template <typename T>
HD T texp(T x) {
  return exp(x);
}

// element p of torch.cumsum(x, dim=1) over the 5 positions, c[p], from
// x[p], x[p - 1], c[p - 1] and c[1], so that a loop over the positions
// holds two sums, not five: on the card the Sklansky scan's c[3] =
// (x[3] + x[2]) + c[1], else c[p] = x[p] + c[p - 1]; on the CPU in order
template <typename T>
HD T cumsum5_at(int p, T x, T x_prev, T c_prev, T c1) {
  if (p == 0) return x;
#ifdef __CUDA_ARCH__
  if (p == 3) return (x + x_prev) + c1;
#endif
  return x + c_prev;
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

// ---- the block's tiles (column_kernel.cuh's staging) ------------------------

// The block's shared arrays: slot s of the block's row r at
// slots[s * ld + r]; imelt == 1 at position p of row r at melt[p * mld + r]
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
  // the positions [p0, p0 + w) of layered input k into slots s0 + p - p0
  // (cp.async)
  HD void stage(int k, int s0, int p0, int w) const {
    for_tile(tid, nt, rows, p0, w, [&](int r, int p) {
      async_copy(slots + (s0 + p - p0) * ld + r, row(k, r) + p);
    });
  }
  // slots s0 + p of every row into positions [0, w) of output q (row
  // width w)
  HD void store(int q, int s0, int w) const {
    T* out = A.lay_out[q] + i0 * w;
    tile_pass<T>(tid, nt, rows, 0, w,
                 [&](int r, int p) { return slots[(s0 + p) * ld + r]; },
                 [&](int r, int p, T v) { K5_STORE(out + r * w + p, v); });
  }
  // whole rows of output q (width wq): positions [0, ns) from slots s0 + p,
  // the rest straight from layered input k, the liquid as snow_water
  // leaves the soil rows, with 0 added twice.  Each row leaves in one pass,
  // so no sector of it is written in parts at different times.
  HD void store_rows(int q, int s0, int ns, int k, int wq) const {
    T* out = A.lay_out[q] + i0 * wq;
    const bool liq = k == lLiq;
    tile_pass<T>(tid, nt, rows, 0, wq,
                 [&](int r, int p) {
                   if (p < ns) return slots[(s0 + p) * ld + r];
                   const T v = load(row(k, r) + p);
                   return liq ? (v + T(0)) + T(0) : v;
                 },
                 [&](int r, int p, T v) { K5_STORE(out + r * wq + p, v); });
  }
};

// The first phase: positions 0-5 of t, ice, liq and dz and zi[5] into
// their slots (cp.async), meanwhile imelt into its bytes
template <typename T>
HD void stage_hot(const Tile<T>& B) {
  B.stage(lT, cT, 0, kSno + 1);
  B.stage(lIce, hIce, 0, kSno);
  B.stage(lLiq, hLiq, 0, kSno);
  B.stage(lDz, cDz, 0, kSno + 1);
  B.stage(lIce, cIce5, kSno, 1);
  B.stage(lLiq, cLiq5, kSno, 1);
  B.stage(lZi, cZi5, kSno, 1);
  const Args<T>& A = B.A;
  tile_pass<long long>(
      B.tid, B.nt, B.rows, 0, kSno,
      [&](int r, int p) {
        return load(A.imelt + (B.i0 + r) * A.imelt_stride + p);
      },
      [&](int r, int p, long long v) { B.melt[p * B.mld + r] = v == 1; });
  async_wait();
}

// The second: the masses and the radii into the cold slots (cp.async)
template <typename T>
HD void stage_cold(const Tile<T>& B) {
  UNROLL for (int k = 0; k < kSpecies; ++k)
    B.stage(lMss + k, cMss + k * kSno, 0, kSno);
  B.stage(lSnwRds, cRds, 0, kSno);
  async_wait();
}

template <typename T>
HD void store_masses(const Tile<T>& B, int q) {
  UNROLL for (int k = 0; k < kSpecies; ++k)
    B.store(q + k, cMss + k * kSno, kSno);
}

// The layers: t, ice, liq and dz (snow positions and the soil-top row from
// the slots), z and zi (the snow positions), each with the soil rows from
// the inputs; the radii
template <typename T>
HD void store_layers(const Tile<T>& B) {
  const int L = B.A.nlevtot;
  B.store_rows(qT, cT, kSno + 1, lT, L);
  B.store_rows(qIce, rIce, kSno + 1, lIce, L);
  B.store_rows(qLiq, rLiq, kSno + 1, lLiq, L);
  B.store_rows(qDz, cDz, kSno + 1, lDz, L);
  B.store_rows(qZ, rZ, kSno, lZ, L);
  B.store_rows(qZi, rZi, kSno, lZi, L + 1);
  B.store(qRds, cRds, kSno);
}

// ---- a column --------------------------------------------------------------

// A column's slots (its row of the block's shared arrays)
template <typename T>
struct Slots {
  T* s;
  const unsigned char* melt;
  int ld, mld;
  HD T& operator[](int k) const { return s[k * ld]; }
  HD T& mss(int k, int p) const { return s[(cMss + k * kSno + p) * ld]; }
  HD T& rds(int p) const { return s[(cRds + p) * ld]; }
  HD T& t(int p) const { return s[(cT + p) * ld]; }
  HD T& ice5() const { return s[cIce5 * ld]; }
  HD T& liq5() const { return s[cLiq5 * ld]; }
  HD T& dz(int p) const { return s[(cDz + p) * ld]; }
  HD bool melting(int p) const { return melt[p * mld] != 0; }
};

// One column's snow: positions 0-4 the snow layers, 5 the top soil row
// (liq, ice, t and dz read it; combine and snow_water write liq/ice).  The
// layers' ice, liq and dz in registers, the rest (the temperatures and the
// soil row included) in its slots
template <typename T>
struct Pack {
  T ice[kSno], liq[kSno];
  Slots<T> S;
  int snl;
  // ice and liq at position p of 0-5
  HD T ice_at(int p) const { return p == kSno ? S.ice5() : pick(ice, p); }
  HD T liq_at(int p) const { return p == kSno ? S.liq5() : pick(liq, p); }
};

template <typename T>
struct Column {
  const Args<T>& A;
  long long i;
  HD T in(int k) const { return load(&A.in[k][i * A.in_stride[k]]); }
};

// combine's [ncol] results
template <typename T>
struct Combined {
  T h2osno, snow_depth, frac_sno, fse, int_snow, qsl, qs2t, mflx;
};

// What combine hands on to divide and the aging
template <typename T>
struct Handed {
  T frac_sno, h2osno;
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
  const Slots<T>& S = P.S;
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
  {
    // (the other positions' liquid takes 0 twice)
    const T ice_t = P.ice_at(top), liq_t = P.liq_at(top);
    const T wgdif = cap ? ice_t - sub_cap : ice_t + add_nc;
    const bool neg = wgdif < T(0);
    const T ice_new = neg ? T(0) : wgdif;
    const T liq_new =
        (liq_t + (neg ? wgdif : T(0))) + (cap ? liq_cap : liq_nc);
    UNROLL for (int p = 0; p < kSno; ++p) {
      P.ice[p] = p == top ? ice_new : P.ice[p];
      P.liq[p] = p == top ? liq_new : (P.liq[p] + T(0)) + T(0);
    }
    S.ice5() = top == kSno ? ice_new : S.ice5();
    S.liq5() = top == kSno ? liq_new : (S.liq5() + T(0)) + T(0);
  }
  // zero negative liquid downward from the top, to the first
  // non-negative layer (impl:317-324)
  bool running = P.liq_at(top) < T(0);
  T mflx_neg = T(0);
  UNROLL for (int p = 0; p <= kSno; ++p) {
    const T w = p < kSno ? P.liq[p] : S.liq5();
    const bool below = p >= top;
    const bool hit = running && below && w < T(0);
    if (p < kSno) {
      P.liq[p] = hit ? T(0) : w;
    } else if (hit) {
      S.liq5() = T(0);
    }
    mflx_neg = hit ? divs(w, dtime) : mflx_neg;
    running = running && (!below || hit);
  }
  // porosity and partial volumes (impl:327-335) of position p, from the
  // layers as they stand before percolation (position p's liquid changes
  // only at step p of it)
  auto volumes = [&](int p, T& vol_ice, T& eff_por, T& vol_liq) {
    const T dzf = P.S.dz(p) * fse;
    const T den_i = dzf * T(K.denice);
    const T den_l = dzf * T(K.denh2o);
    vol_ice = nmin(den_i != T(0) ? P.ice[p] / den_i : T(0), T(1));
    eff_por = T(1) - vol_ice;
    vol_liq = nmin(eff_por, den_l != T(0) ? P.liq[p] / den_l : T(0));
  };
  // percolation with aerosol scavenging (impl:353-461)
  const double scv[kSpecies] = {0.20, 0.03, 0.02, 0.02, 0.01, 0.01};
  T qin = T(0), qout = T(0), qin_a[kSpecies];
  UNROLL for (int k = 0; k < kSpecies; ++k) qin_a[k] = T(0);
  // (an inactive position only adds 0 to its liquid and its masses: its
  // flux, which the plain block computes and discards, is not computed)
  T vi = T(0), ep = T(0), vl = T(0);
  if (top == 0) volumes(0, vi, ep, vl);
  UNROLL for (int i = 0; i < kSno; ++i) {
    // position i + 1's volumes (the bottom layer's own at the bottom)
    T vi1 = vi, ep1 = ep, vl1 = vl;
    if (i + 1 < kSno && i + 1 >= top) volumes(i + 1, vi1, ep1, vl1);
    const bool act = i >= top;
    P.liq[i] = P.liq[i] + (act ? qin : T(0));
    T q = T(0);
    if (act) {
      const int ip1 = i + 1 < kSno ? i + 1 : kSno - 1;
      const T base = nmax(((vl - T(0.033) * ep) * P.S.dz(i)) * fse, T(0));
      // (the reference reads vol_ice[i+i] here: corrected to i+1)
      const T capq = (((T(1) - vi1) - vl1) * P.S.dz(ip1)) * fse;
      const bool blocked = ep < T(0.05) || ep1 < T(0.05);
      q = i < kSno - 1 ? (blocked ? T(0) : nmin(base, capq)) : base;
      q = q * T(1000.0);
    }
    P.liq[i] = P.liq[i] + (act ? -q : T(0));
    qin = act ? q : qin;
    qout = act ? q : qout;
    // the masses take what flowed in from above, then lose what the flux
    // scavenges
    if (act) {
      const T liqice = nmax(P.liq[i] + P.ice[i], T(1.0e-30));
      UNROLL for (int k = 0; k < kSpecies; ++k) {
        const T mk = S.mss(k, i) + qin_a[k];
        const T qa = nmin((q * T(scv[k])) * (mk / liqice), mk);
        S.mss(k, i) = mk + -qa;
        qin_a[k] = qa;
      }
    } else {
      UNROLL for (int k = 0; k < kSpecies; ++k)
        S.mss(k, i) = (S.mss(k, i) + T(0)) + T(0);
    }
    vi = vi1;
    ep = ep1;
    vl = vl1;
  }
  // layer thickness floor (impl:468-470)
  UNROLL for (int p = 0; p < kSno; ++p) {
    if (p >= top) {
      P.S.dz(p) = nmax(P.S.dz(p), divs(P.liq[p], K.denh2o) +
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
  const Slots<T>& S = P.S;
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
      S.mss(k, p) = S.mss(k, p) + ((p == top && has) ? d : T(0));
  }
  // within-ice BC to external BC with the sublimated mass
  // (snow_hydrology_impl.hh:492-543)
  const T tot = P.liq_at(top) + P.ice_at(top);
  const T subsnow = nmax(C.in(iSubSnow) * Tdt, T(0));
  const T frc = nmin(tot > T(0) ? subsnow / tot : T(0), T(1));
  UNROLL for (int p = 0; p < kSno; ++p) {
    const T m0 = S.mss(0, p);
    const T dm = p == top ? m0 * frc : T(0);
    S.mss(0, p) = m0 - dm;
    S.mss(1, p) = S.mss(1, p) + dm;
  }
}

// ---- 4: snow_compaction (snow_hydrology_impl.hh:546-637) -------------------

template <typename T>
HD void compaction(const Column<T>& C, Pack<T>& P, T frac_sno, T int_snow) {
  const double dtime = C.A.dtime;
  const Consts& K = C.A.K;
  const Slots<T>& S = P.S;
  const int top = kSno - P.snl;
  const T fs = frac_sno;
  const T fs_safe = fs != T(0) ? fs : T(1);
  const T rdt = T(-1.0 / dtime);
  // ELM's melt form on soil and crop (read here, where it is needed)
  const bool soil_crop = C.A.soil_crop[C.i * C.A.soil_crop_stride] != 0;
  // (a position that does not compact keeps its thickness: the rates the
  // plain block computes for it and discards are not computed)
  unsigned compacts = 0;  // a bit a position
  UNROLL for (int p = 0; p < kSno; ++p) {
    const T ice = P.ice[p], liq = P.liq[p], dz = P.S.dz(p);
    const T dz_safe = dz != T(0) ? dz : T(1);
    if (p >= top) {
      const T vd = T(1) - (divs(ice, K.denice) + divs(liq, K.denh2o)) /
                              (fs_safe * dz_safe);
      if (vd > T(0.001) && ice > T(0.1)) compacts |= 1u << p;
    }
  }
  // the melt compaction's snow-covered fraction takes two values: at the
  // top layer, from the pack's mass, and below it, from no mass; each is
  // computed once, where a melting layer of a soil or crop column needs it
  T fsno_top = T(0), fsno_below = T(0);
  if (soil_crop) {
    bool top_melts = false, below_melts = false;
    UNROLL for (int p = 0; p < kSno; ++p) {
      if (((compacts >> p) & 1u) && S.melting(p)) {
        top_melts = top_melts || p == top;
        below_melts = below_melts || p != top;
      }
    }
    const T int_safe = int_snow != T(0) ? int_snow : T(1);
    auto fsno_melt = [&](T wsum) {
      const T x = nmin(wsum / int_safe, T(1));
      return T(1) - tpow(divs(tacos(T(2.0) * x - T(1.0)), K.pi),
                         C.in(iNMelt));
    };
    if (top_melts) {
      T wx_act[kSno];
      UNROLL for (int q = 0; q < kSno; ++q)
        wx_act[q] = q >= top ? P.ice[q] + P.liq[q] : T(0);
      fsno_top = fsno_melt(sum5(wx_act));
    }
    if (below_melts) fsno_below = fsno_melt(T(0));
  }
  // the active layers' running mass from the top
  T c_prev = T(0), c1 = T(0), x_prev = T(0);
  UNROLL for (int p = 0; p < kSno; ++p) {
    const T ice = P.ice[p], liq = P.liq[p], dz = P.S.dz(p);
    const T wx = ice + liq;
    // overburden: exclusive prefix sum of the layer mass from the top
    const T x_act = p >= top ? wx : T(0);
    const T cum = cumsum5_at(p, x_act, x_prev, c_prev, c1);
    const T burden = cum - x_act;
    if (p == 1) c1 = cum;
    c_prev = cum;
    x_prev = x_act;
    if (!((compacts >> p) & 1u)) continue;
    const T dz_safe = dz != T(0) ? dz : T(1);
    const T bi = ice / (fs_safe * dz_safe);
    const T wx_safe = wx != T(0) ? wx : T(1);
    const T td = T(K.tfrz) - S.t(p);
    const T dexpf = texp(T(-0.04) * td);
    T ddz1 = T(-2.777e-6) * dexpf;
    if (bi > T(100.0)) ddz1 = ddz1 * texp(T(-46.0e-3) * (bi - T(100.0)));
    if (liq > (T(0.01) * dz) * fs) ddz1 = ddz1 * T(2.0);
    const T ddz2 = divs((-(burden + divs(wx, 2.0))) *
                            texp(T(-0.08) * td - T(23.e-3) * bi),
                        9.0e+5);
    T ddz3 = T(0);
    if (S.melting(p)) {
      if (soil_crop) {
        // melt compaction: ELM's fractional-area form on soil and crop
        const T swe = load(C.A.lay[lSweOld] + C.i * C.A.lay_stride[lSweOld] + p);
        T ddz3_sc = nmin(nmax((swe - wx) / wx_safe, T(0)), T(1));
        const bool shrunk = (swe - wx) > T(0);
        const T fsno_melt = p == top ? fsno_top : fsno_below;
        ddz3_sc = ddz3_sc - (shrunk ? nmax((fsno_melt - fs) / fs_safe, T(0))
                                    : T(0));
        ddz3 = rdt * ddz3_sc;
      } else {
        const T fi = ice / wx_safe;
        const T fio =
            load(C.A.lay[lFracIceold] + C.i * C.A.lay_stride[lFracIceold] + p);
        const T fio_safe = fio != T(0) ? fio : T(1);
        ddz3 = rdt * nmax((fio - fi) / fio_safe, T(0));
      }
    }
    const T pdzdtc = (ddz1 + ddz2) + ddz3;
    P.S.dz(p) = nmax(dz * (T(1) + pdzdtc * T(dtime)),
                   (divs(ice, K.denice) + divs(liq, K.denh2o)) / fs_safe);
  }
}

// ---- 5: combine_layers (snow_hydrology_impl.hh:648-897) --------------------

// where(on and lo < p <= hi): slot base + p = slot base + p - 1
template <typename T>
HD void shift_down_slots(const Slots<T>& S, int base, bool on, int lo,
                         int hi) {
  UNROLL for (int p = kSno - 1; p >= 1; --p) {
    if (on && p > lo && p <= hi) S[base + p] = S[base + p - 1];
  }
}

template <typename T>
HD void shift_layers(Pack<T>& P, bool on, int lo, int hi) {
  shift_down_slots(P.S, cT, on, lo, hi);
  shift_down(P.liq, on, lo, hi);
  shift_down(P.ice, on, lo, hi);
  shift_down_slots(P.S, cDz, on, lo, hi);
  shift_down_slots(P.S, cRds, on, lo, hi);
  UNROLL for (int k = 0; k < kSpecies; ++k)
    shift_down_slots(P.S, cMss + k * kSno, on, lo, hi);
}

// (step 6 too: the [ncol] results leave before the merges of thin layers,
// which change none of them)
template <typename T>
HD Handed<T> combine(const Column<T>& C, Pack<T>& P, T fse,
                     const Water<T>& W, int snl0) {
  const T frac_sno = W.frac_sno, int_snow = W.int_snow;
  // the merges into the soil row on soil, crop and urban columns
  const bool soil_like = C.A.soil_like[C.i * C.A.soil_like_stride] != 0;
  const double dtime = C.A.dtime;
  const Consts& K = C.A.K;
  const Slots<T>& S = P.S;
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
      if (i + 1 < kSno) {
        P.liq[i + 1] = P.liq[i + 1] + liq_i;
        P.ice[i + 1] = P.ice[i + 1] + ice_i;
      } else {
        S.liq5() = S.liq5() + liq_i;
        S.ice5() = S.ice5() + ice_i;
      }
    }
    T q = T(0);
    if (i == kSno - 1) {
      q = msl ? divs(liq_i + ice_i, dtime) : T(0);
      R.qsl = msl ? q : R.qsl;
    }
    R.mflx = R.mflx + q;
    if (i < kSno - 1 && msl) {
      P.S.dz(i + 1) = P.S.dz(i + 1) + P.S.dz(i);
      UNROLL for (int k = 0; k < kSpecies; ++k)
        S.mss(k, i + 1) = S.mss(k, i + 1) + S.mss(k, i);
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
      d[p] = a ? P.S.dz(p) : T(0);
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
  if (gone) {
    UNROLL for (int k = 0; k < kSpecies; ++k)
      UNROLL for (int p = 0; p < kSno; ++p) S.mss(k, p) = T(0);
  }
  snow_depth = (gone && h2osno <= T(0)) ? T(0) : snow_depth;
  const bool gsl = gone && soil_like;
  P.liq[kSno - 1] = gsl ? T(0) : P.liq[kSno - 1];
  S.liq5() = S.liq5() + (gsl ? zwliq : T(0));
  R.qs2t = gsl ? divs(zwliq, dtime) : R.qs2t;
  R.mflx = R.mflx + (gsl ? divs(zwliq, dtime) : T(0));
  const bool none_left = h2osno <= T(0);
  R.h2osno = h2osno;
  R.snow_depth = none_left ? T(0) : snow_depth;
  R.frac_sno = none_left ? T(0) : frac_sno;
  R.fse = none_left ? T(0) : fse;
  R.int_snow = none_left ? T(0) : int_snow;
  const T f = R.fse;
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
  const long long i = C.i;
  T* const* o = C.A.out;
  K5_STORE(o[oH2osno] + i, R.h2osno);
  K5_STORE(o[oSnowDepth] + i, R.snow_depth);
  K5_STORE(o[oFracSno] + i, R.frac_sno);
  K5_STORE(o[oFse] + i, R.fse);
  K5_STORE(o[oIntSnow] + i, R.int_snow);
  K5_STORE(o[oSlTopSoil] + i, R.qsl);
  K5_STORE(o[oSnow2topsoi] + i, R.qs2t);
  K5_STORE(o[oMflxSnowlyr] + i, R.mflx);
  const Handed<T> out{R.frac_sno, R.h2osno};
  // merge below-minimum layers with a neighbour (impl:813-890)
  const double dzmin[kSno] = {0.010, 0.015, 0.025, 0.055, 0.115};
  const int top_old2 = kSno - P.snl;
  int mssi = 0;
  bool stop = P.snl <= 1;
  UNROLL for (int i = 0; i < kSno; ++i) {
    // (a position that is not merged computes no merge: the plain block's
    // merged values for it are discarded)
    const bool cand = !stop && i >= top_old2;
    bool m = false;
    if (cand) {
      const T dz_i = P.S.dz(i);
      const T fse_dz = f * dz_i;
      const T fse_dz_safe = fse_dz != T(0) ? fse_dz : T(1);
      T dmin = T(dzmin[0]);
      UNROLL for (int k = 1; k < kSno; ++k)
        dmin = mssi == k ? T(dzmin[k]) : dmin;
      m = fse_dz < dmin || (P.ice[i] + P.liq[i]) / fse_dz_safe < T(50.0);
    }
    const int topc = kSno - P.snl;
    if (m) {
      const T dz_i = P.S.dz(i);
      // the first position merges downward, the last upward, the middle
      // ones with the thinner neighbour (impl:823-834): nb: j = i+1, l = i;
      // else j = i, l = i-1
      bool nb;
      if (i == 0) {
        nb = true;
      } else if (i == kSno - 1) {
        nb = false;
      } else {
        nb = i == topc ||
             !((P.S.dz(i - 1) + dz_i) < (P.S.dz(i + 1) + dz_i));
      }
      const int ja = i + 1 < kSno ? i + 1 : i;
      const int lb = i > 0 ? i - 1 : 0;
      const int j = nb ? i + 1 : i;
      const T wl_j = nb ? P.liq[ja] : P.liq[i];
      const T wl_l = nb ? P.liq[i] : P.liq[lb];
      const T wi_j = nb ? P.ice[ja] : P.ice[i];
      const T wi_l = nb ? P.ice[i] : P.ice[lb];
      const T t_j = S.t(nb ? ja : i), t_l = S.t(nb ? i : lb);
      const T dz_j = S.dz(nb ? ja : i), dz_l = S.dz(nb ? i : lb);
      const T r_j = S.rds(nb ? ja : i), r_l = S.rds(nb ? i : lb);
      const T tot = ((wl_j + wi_j) + wl_l) + wi_l;
      const T rds_new = (r_j * (wl_j + wi_j) + r_l * (wl_l + wi_l)) /
                        (tot != T(0) ? tot : T(1));
      const Merged<T> M =
          combine_vals(dz_l, wl_l, wi_l, t_l, dz_j, wl_j, wi_j, t_j, K);
      if (nb) {
        P.liq[ja] = M.wliq;
        P.ice[ja] = M.wice;
        S.t(ja) = M.t;
        P.S.dz(ja) = M.dz;
        S.rds(ja) = rds_new;
        UNROLL for (int k = 0; k < kSpecies; ++k)
          S.mss(k, ja) = S.mss(k, ja) + S.mss(k, i);
      } else {
        P.liq[i] = M.wliq;
        P.ice[i] = M.wice;
        S.t(i) = M.t;
        P.S.dz(i) = M.dz;
        S.rds(i) = rds_new;
        UNROLL for (int k = 0; k < kSpecies; ++k)
          S.mss(k, i) = S.mss(k, i) + S.mss(k, lb);
      }
      // shift the layers above down one (impl:865-879): from j-1 to the
      // top
      shift_layers(P, (j - 1) > topc, topc - 1, j - 1);
    }
    P.snl = m ? P.snl - 1 : P.snl;
    stop = stop || (m && P.snl <= 1);
    mssi = (!stop && i >= top_old2 && !m) ? mssi + 1 : mssi;
  }
  // (the mesh is rebuilt after divide, which sets every active position)
  return out;
}

// ---- 7-8: divide_layers (snow_hydrology_impl.hh:907-1285), then
// prune_snow_layers (t, ice, liq and dz above the top; z and zi when the
// outputs are written)

template <typename T>
HD void divide(Pack<T>& P, T frac_sno, const Consts& K) {
  const Slots<T>& S = P.S;
  const int snl = P.snl;
  const int top = kSno - snl;
  const T fs = frac_sno;
  const T fs_safe = fs != T(0) ? fs : T(1);
  // top-anchored scratch: index k holds layer top + k.  The temperatures'
  // scratch is their own slots, shifted up in place (slot top + k is read
  // before slot k is written, and the old values above the new top are
  // pruned afterwards)
  T dzs[kSno], swice[kSno], swliq[kSno], rds[kSno];
  UNROLL for (int k = 0; k < kSno; ++k) {
    const bool in = k < snl;
    const int src = top + k < kSno - 1 ? top + k : kSno - 1;
    dzs[k] = (in ? S.dz(src) : T(0)) * fs;
    swice[k] = in ? pick(P.ice, src) : T(0);
    swliq[k] = in ? pick(P.liq, src) : T(0);
    S.t(k) = in ? S.t(src) : T(0);
    rds[k] = in ? S.rds(src) : T(0);
  }
  int msno = snl;
  // one layer thicker than 0.03: split it in two (impl:962-986)
  const bool split0 = msno == 1 && dzs[0] > T(0.03);
  if (split0) {
    dzs[0] = dzs[1] = divs(dzs[0], 2.0);
    swice[0] = swice[1] = divs(swice[0], 2.0);
    swliq[0] = swliq[1] = divs(swliq[0], 2.0);
    S.t(1) = S.t(0);
    rds[1] = rds[0];
    msno = 2;
  }
  // the ladder: trim layer k to dmax, push the excess into k+1, then maybe
  // split k+1.  Each rung's proportions and flags are kept for the masses,
  // which follow the same steps one species at a time below.
  const double dmaxs[4] = {0.02, 0.05, 0.11, 0.23};
  const int split_msno[3] = {2, 3, 4};
  const double split_dz[3] = {0.07, 0.18, 0.41};
  unsigned thick_k = 0, split_k = 0;  // a bit a rung
  T propor_x_k[4], propor_k[4];
  UNROLL for (int k = 0; k < 4; ++k) {
    const T dmax = T(dmaxs[k]);
    const T dzs_k = dzs[k];
    const bool thick = msno > k + 1 && dzs_k > dmax;
    // (a rung whose layer is not thick changes nothing: the plain block's
    // values for it are discarded)
    if (!thick) continue;
    thick_k |= 1u << k;
    const T dz_k = dzs_k != T(0) ? dzs_k : T(1);
    const T drr = dzs_k - dmax;
    const T propor_x = drr / dz_k;
    const T zwice = propor_x * swice[k];
    const T zwliq = propor_x * swliq[k];
    const T propor = dmax / dz_k;
    propor_x_k[k] = propor_x;
    propor_k[k] = propor;
    swice[k] = swice[k] * propor;
    swliq[k] = swliq[k] * propor;
    dzs[k] = dmax;
    const T tot = ((swliq[k + 1] + swice[k + 1]) + zwliq) + zwice;
    rds[k + 1] = (rds[k + 1] * (swliq[k + 1] + swice[k + 1]) +
                  rds[k] * (zwliq + zwice)) /
                 (tot != T(0) ? tot : T(1));
    const Merged<T> M =
        combine_vals(drr, zwliq, zwice, S.t(k), dzs[k + 1], swliq[k + 1],
                     swice[k + 1], S.t(k + 1), K);
    dzs[k + 1] = M.dz;
    swliq[k + 1] = M.wliq;
    swice[k + 1] = M.wice;
    S.t(k + 1) = M.t;
    if (k == 3) break;  // the last rung never splits
    // subdivide layer k+1
    const bool split = msno <= split_msno[k] && dzs[k + 1] > T(split_dz[k]);
    if (!split) continue;
    split_k |= 1u << k;
    const T dtdz = (S.t(k) - S.t(k + 1)) / divs(dzs[k] + dzs[k + 1], 2.0);
    const T half_dz = divs(dzs[k + 1], 2.0);
    const T t_up = S.t(k + 1);
    const T hq = divs(dtdz * half_dz, 2.0);
    const T t_low = t_up - hq;
    // the reference's warm check differs across the rungs (impl:1041,
    // 1118, 1194)
    const bool warm = k == 1 ? t_up >= T(K.tfrz) : t_low >= T(K.tfrz);
    dzs[k + 1] = dzs[k + 2] = half_dz;
    swice[k + 1] = swice[k + 2] = divs(swice[k + 1], 2.0);
    swliq[k + 1] = swliq[k + 2] = divs(swliq[k + 1], 2.0);
    S.t(k + 2) = warm ? t_up : t_low;
    S.t(k + 1) = warm ? t_up : t_up + hq;
    rds[k + 2] = rds[k + 1];
    msno = k + 3;
  }
  // back to the bottom-anchored layout (impl:1263-1284); the positions
  // above the new top are pruned (step 8: prune_snow_layers), so no old
  // layer outlives the copy into the scratch
  P.snl = msno;
  const int top_new = kSno - msno;
  UNROLL for (int p = 0; p < kSno; ++p) {
    const int back = p - top_new;
    const bool in = back >= 0;
    P.S.dz(p) = in ? pick(dzs, back) / fs_safe : T(0);
    P.ice[p] = in ? pick(swice, back) : T(0);
    P.liq[p] = in ? pick(swliq, back) : T(0);
    if (in) S.rds(p) = pick(rds, back);
  }
  // (descending: slot p - top_new is read before it is written)
  UNROLL for (int p = kSno - 1; p >= 0; --p) {
    const int back = p - top_new;
    S.t(p) = back >= 0 ? S.t(back) : T(0);
  }
  // the masses: each species through the ladder's steps
  UNROLL for (int s = 0; s < kSpecies; ++s) {
    T ms[kSno];
    UNROLL for (int k = 0; k < kSno; ++k) {
      const int src = top + k < kSno - 1 ? top + k : kSno - 1;
      ms[k] = k < snl ? S.mss(s, src) : T(0);
    }
    if (split0) ms[0] = ms[1] = divs(ms[0], 2.0);
    UNROLL for (int k = 0; k < 4; ++k) {
      if ((thick_k >> k) & 1u) {
        ms[k + 1] = ms[k + 1] + propor_x_k[k] * ms[k];
        ms[k] = ms[k] * propor_k[k];
      }
      if (k < 3 && ((split_k >> k) & 1u))
        ms[k + 1] = ms[k + 2] = divs(ms[k + 1], 2.0);
    }
    UNROLL for (int p = 0; p < kSno; ++p) {
      const int back = p - top_new;
      if (back >= 0) S.mss(s, p) = pick(ms, back);
    }
  }
}

// ---- 10: snow aging (snow_hydrology_impl.hh:80-225) ------------------------

// (each position's radius replaces the old one in its slot)
template <typename T>
HD void aging_pinned(const Pack<T>& P, T h2osno, const Consts& K) {
  const int top = kSno - P.snl;
  const bool layered = P.snl > 0;
  UNROLL for (int p = 0; p < kSno; ++p) {
    const bool active = p >= top && layered;
    P.S.rds(p) = active ? T(K.rds_min) : (layered ? T(0) : P.S.rds(p));
  }
  if (P.snl == 0 && h2osno > T(0)) P.S.rds(kSno - 1) = T(K.rds_min);
}

// (an active layer reads its refreezing rate straight from the input: no
// other needs one)
template <typename T>
HD void aging_elm(const Column<T>& C, const Pack<T>& P, bool cap, T frac_sno,
                  T h2osno) {
  const Args<T>& A = C.A;
  const Consts& K = A.K;
  const double dtime = A.dtime;
  const int top = kSno - P.snl;
  const bool layered = P.snl > 0;
  const T fs = frac_sno;
  const T newsnow =
      nmax((cap ? C.in(iSnwcpIce) : C.in(iSnowGrnd)) * T(dtime), T(0));
  UNROLL for (int p = 0; p < kSno; ++p) {
    // (only an active layer ages: the radius the plain block computes for
    // the others is discarded)
    const bool active = p >= top && layered;
    const T rds = P.S.rds(p);
    if (!active) {
      P.S.rds(p) = layered ? T(0) : rds;
      continue;
    }
    const T liq = P.liq[p], ice = P.ice[p], t = P.S.t(p), dz = P.S.dz(p);
    const T h = liq + ice;
    const T h_safe = h != T(0) ? h : T(1);
    // temperatures at the layer's top and bottom interfaces
    const T t_m1 = P.S.t(p > 0 ? p - 1 : 0);
    const T dz_m1 = P.S.dz(p > 0 ? p - 1 : 0);
    const T t_p1 = P.S.t(p + 1);
    const T dz_p1 = P.S.dz(p + 1);
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
    const T refrz =
        nmax(load(A.lay[lSnofrz] + C.i * A.lay_stride[lSnofrz] + p) *
                 T(dtime),
             T(0));
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
    P.S.rds(p) = r;
  }
  if (P.snl == 0 && h2osno > T(0)) P.S.rds(kSno - 1) = T(K.rds_min);
}

// ---- the block ---------------------------------------------------------------

// Columns i0 .. i0 + B.rows - 1, thread B.tid of B.nt computing column
// i0 + B.tid (if there is one).  Every thread runs every staging pass and
// reaches every barrier.
template <typename T, bool ELM>
HD void run_block(const Tile<T>& B) {
  const Args<T>& A = B.A;
  const Consts& K = A.K;
  const bool live = B.tid < B.rows;
  const long long i = B.i0 + B.tid;
  const Column<T> C{A, i};
  Pack<T> P;
  P.S = Slots<T>{B.slots + B.tid, B.melt + B.tid, B.ld, B.mld};
  const Slots<T>& S = P.S;

  stage_hot(B);
  block_sync();
  if (live) {
    UNROLL for (int p = 0; p < kSno; ++p) {
      P.ice[p] = S[hIce + p];
      P.liq[p] = S[hLiq + p];
    }
  }
  block_sync();
  stage_cold(B);
  block_sync();

  // the [ncol] outputs leave as soon as they are final; what the later
  // steps read stays
  T* const* o = A.out;
  bool cap = false;
  int top = kSno;
  T frac_sno = T(0), h2osno = T(0);
  if (live) {
    P.snl = static_cast<int>(A.snl[i]);
    const int snl0 = P.snl;
    cap = A.do_capsnow[i * A.capsnow_stride] != 0;
    const T fse = C.in(iFse);
    // 1-3: percolation, deposition, BC phase change
    const Water<T> W = snow_water(C, P, cap, fse);
    K5_STORE(o[oSnowMelt] + i, W.snow_melt);
    K5_STORE(o[oTopSoil] + i, W.top_soil);
    K5_STORE(o[oMflxNeg] + i, W.mflx_neg);
    aerosols_in(C, P);
    // 4: compaction
    compaction(C, P, W.frac_sno, W.int_snow);
    // 5-6: combine, then the layerless pass-through
    const Handed<T> H = combine(C, P, fse, W, snl0);
    frac_sno = H.frac_sno;
    h2osno = H.h2osno;
    // 7-8: divide, prune the inactive layers
    divide(P, frac_sno, K);
    top = kSno - P.snl;
  }

  // 10: aging (before 9 here: it reads no aerosol)
  // 9: snow-cap rescaling of the masses (aerosol_physics_impl.hh:63-107)
  T snowmass[kSno];
  if (live) {
    if (ELM) {
      aging_elm(C, P, cap, frac_sno, h2osno);
    } else {
      aging_pinned(P, h2osno, K);
    }
    K5_STORE(A.snl_out + i, static_cast<long long>(P.snl));
    const T cap_add = C.in(iSnwcpIce) * T(A.dtime);
    UNROLL for (int p = 0; p < kSno; ++p) {
      const bool above = p < top;
      snowmass[p] = above ? T(1.0e-12) : P.ice[p] + P.liq[p];
      const T scl = (p == top && cap) ? snowmass[p] / (snowmass[p] + cap_add)
                                      : (above ? T(0) : T(1));
      UNROLL for (int k = 0; k < kSpecies; ++k)
        S.mss(k, p) = S.mss(k, p) * scl;
    }
  }
  block_sync();
  store_masses(B, qMss);
  block_sync();
  // the concentrations (above the top a mass is 0 unless NaN, and 0 over
  // the 1e-12 there is that 0, its sign kept)
  if (live) {
    UNROLL for (int p = 0; p < kSno; ++p) {
      const bool above = p < top;
      UNROLL for (int k = 0; k < kSpecies; ++k) {
        const T m = S.mss(k, p);
        S.mss(k, p) = (above && m == T(0)) ? m : m / snowmass[p];
      }
    }
  }
  block_sync();
  store_masses(B, qCnc);
  block_sync();
  // the layers; z and zi as the last mesh rebuild (after divide) gives
  // them, zero above the top (z(i) = zi(i+1) - dz/2, zi(i) = zi(i+1) - dz
  // from the bottom snow layer up: _rebuild_snow_mesh)
  if (live) {
    UNROLL for (int p = 0; p < kSno; ++p) {
      S[rIce + p] = P.ice[p];
      S[rLiq + p] = P.liq[p];
    }
    S[rIce + kSno] = S.ice5();
    S[rLiq + kSno] = S.liq5();
    T zi_below = S[cZi5];
    UNROLL for (int p = kSno - 1; p >= 0; --p) {
      T z = T(0), zi = T(0);
      if (p >= top) {
        z = zi_below - T(0.5) * P.S.dz(p);
        zi = zi_below - P.S.dz(p);
      }
      S[rZ + p] = z;
      S[rZi + p] = zi;
      zi_below = zi;
    }
  }
  block_sync();
  store_layers(B);
}

// One column on the host: a block of one thread, its slots a plain array
template <typename T, bool ELM>
void run_column(const Args<T>& A, long long i) {
  T slots[kSlots];
  unsigned char melt[kSno];
  run_block<T, ELM>(Tile<T>{A, i, 1, 0, 1, slots, melt, 1, 1});
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

// ---- the launch --------------------------------------------------------------

// Columns (threads) a block, and the stride of a slot in the block's
// shared arrays (see the note at the top)
constexpr int kB = 128;
constexpr int kLd = kB + 13;

// Dynamic shared memory a block: the slots, then imelt's bytes
template <typename T>
constexpr int smem_bytes() {
  return kSlots * kLd * static_cast<int>(sizeof(T)) + kSno * kB;
}

#ifdef __CUDACC__

// Resident blocks an SM asked of ptxas: four in float64 (128 registers a
// thread, 16 warps), six in float32 (80 registers, 24 warps); the slots
// allow them (4 x 57,040 B and 6 x 28,840 B of the SM's 228 KB)
template <typename T>
struct MinBlocks;
template <>
struct MinBlocks<double> {
  static constexpr int value = 4;
};
template <>
struct MinBlocks<float> {
  static constexpr int value = 6;
};

template <typename T, bool ELM>
__global__ void __launch_bounds__(kB, MinBlocks<T>::value)
    snow_kernel(const Args<T> A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long i0 = static_cast<long long>(blockIdx.x) * kB;
  const long long left = A.n - i0;
  const int rows = left < kB ? static_cast<int>(left) : kB;
  run_block<T, ELM>(Tile<T>{A, i0, rows, static_cast<int>(threadIdx.x), kB,
                            reinterpret_cast<T*>(smem),
                            smem + kSlots * kLd * sizeof(T), kLd, kB});
}

constexpr int kMaxDevices = 64;

// Sets the kernel's dynamic shared memory limit, once per device
template <typename T, bool ELM>
int prepare() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(snow_kernel<T, ELM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<T>());
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <typename T, bool ELM>
int launch_as(const Args<T>& A, cudaStream_t s) {
  const int err = prepare<T, ELM>();
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((A.n + kB - 1) / kB);
  snow_kernel<T, ELM><<<grid, kB, smem_bytes<T>(), s>>>(A);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int elm, const Args<T>& A, cudaStream_t s) {
  if (A.n <= 0) return cudaSuccess;
  return elm ? launch_as<T, true>(A, s) : launch_as<T, false>(A, s);
}

// {threads a block, registers a thread, local memory bytes a thread
// (spills), resident blocks an SM, dynamic shared memory bytes a block}
template <typename T, bool ELM>
int layout_of(int* out) {
  cudaError_t err = static_cast<cudaError_t>(prepare<T, ELM>());
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, snow_kernel<T, ELM>);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, snow_kernel<T, ELM>, kB, smem_bytes<T>());
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
// bytes a thread, resident blocks an SM, dynamic shared memory bytes a
// block}.  Returns a CUDA error code.
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
