// K3: SNICAR-AD, the snow's 5-band Delta-Eddington adding-doubling radiative
// transfer with aerosols, for the direct and the diffuse beam of a step in
// one launch: the Mie optics by grain radius, the aerosol mixing (BC, OC,
// dust), the delta transform, the layers' apparent optics with the 8-point
// Gaussian re-integration of the diffuse ones, the top-down and bottom-up
// interface recursions, the interface fluxes, and the weighting of the bands
// into visible and near-infrared albedos and layer absorption (the
// high-zenith near-IR adjustment for the direct beam), with the select
// between snow, thin snow and none.
//
// Replaces: elmkernels_torch/physics/snow_snicar.py:snicar_ad_rt_both_plain,
// _snicar_core and both calls of _radiation_factor (the JAX package's
// physics/snow_snicar.py:_snicar_core, whose two lax.scans over the layers
// the plain path runs as Python loops of full-width [10, 5, ncol] tensors:
// some 900 operations a step, every column computed and most thrown away).
// Reference: snow_snicar_impl.hh:5-771.
//
// A thread takes one column and one beam (direct or diffuse: its 5 band
// rows), so a column's two beams run side by side and a thread holds one
// beam's sums.  A block holds kCols columns: its first kCols threads take
// the direct beam, the next kCols the diffuse one, so each warp runs one
// beam's code.  Work whose result the plain path throws away is not done:
// - A column without active snow (coszen <= 0 or h2osno <= MIN_SNW) writes
//   the plain path's select values (the soil albedo where the snow is
//   thin, else 0; no absorption) and sweeps nothing.  A block none of whose
//   columns is active stages nothing.
// - An active column sweeps only its active layers (snl of them, one for a
//   layerless pack).  Above the top layer the plain recursions carry the
//   identity layer (transmissions 1, reflections 0), whose interfaces hold
//   (1, 1, 1, 0) going down and repeat the top interface's reflectivities
//   going up, bit for bit, so the sweep starts at the top layer and reads
//   the albedo there.  A layer reached with trntdr <= TRMIN is a zero layer
//   (every coefficient 0), and its optics are not computed.
// - The bands 4 and 5 carry no aerosol: their sums are 0.
// Registers and occupancy: a thread's sweep state is one band row at a
// time, and the per-layer coefficients and the interface values of the
// top-down pass, which the bottom-up pass reads at run-time positions, sit
// in the thread's slots of a [slot][thread] array in shared memory (an
// index there costs nothing; in registers it would need selects over the
// unrolled layers, or local memory), with the near-IR sums of the layer
// absorption.  The optics of a layer, with its eight Gaussian points, is
// the register-heavy part (123-128 registers with a float sweep, 190 with
// a double one, no spills), and it is the same for any mapping.  A thread
// a column and beam gives 2 x ncol threads, 16 warps an SM with a float
// sweep: enough to hide the latency of its exp and division chains, with
// both beams of a column in one block sharing its staged inputs.  A thread
// a band row would give 5x the threads but need the band sums (albedo and
// absorption, in PyTorch's orders) across threads, through shared memory
// and barriers, and split a warp between bands with and without aerosols.
// Bytes: a column reads ~60 values (coszen, h2osno, snl, the layers' ice,
// liquid and grain radii, two soil albedos and 40 aerosol masses) and
// writes 28.  The block stages its columns' 40 masses and 15 layer values
// through shared memory, each as one flat coalesced range of the block's
// rows (rounded to the sweep's type on the way, as the step's cast rounds
// them); the Mie tables ([5, 1471] a property and beam) and the small
// aerosol tables are gathered through the read-only cache.
//
// The arithmetic is the plain path's, operation by operation and in its
// order (build with --fmad=false), as PyTorch's elementwise kernels compute
// each operation on the card:
// - a Python number meets a tensor rounded to the tensor's type;
// - tensor / number multiplies by the number's reciprocal, taken in double
//   and rounded, on the card, and divides on the CPU (divs); number /
//   tensor is a reciprocal (1 / x) times the number;
// - x ** 2 is x * x; clamp, minimum and maximum propagate NaN (nmax);
// - exp and sqrt inline; float and double log10 from snicar_math.cu,
//   compiled with contraction on as PyTorch's kernels are;
// - torch.sum over the 8 aerosol species (a contiguous row of 8) adds as
//   eight lanes with halving shuffles, ((x0 + x4) + (x2 + x6)) + ((x1 + x5)
//   + (x3 + x7)); over the 4 near-IR bands, the albedo (rows of a [4,
//   ncol] tensor) adds in order, the layer absorption (a [4, ncol, 6]
//   tensor of stride ncol along the bands and 4 ncol along the interfaces)
//   as (x0 + x2) + (x1 + x3) (measured on the card on the plain path's own
//   tensors: chip_smoke.py:reduction_order); on the CPU, PyTorch adds the
//   species in order in float and as four accumulators, ((x0 + x4) + (x1 +
//   x5)) + (x2 + x6) + (x3 + x7), in double, and the bands in order (sum8,
//   nir_add);
// - the eight Gaussian points' sums are sequential, from 0, as the plain
//   path's Python loop adds them.
// Three types: I, the inputs' and tables' (float64 under the step's
// mixed_radiation, whose float32 cast happens here on load); T, the
// sweep's; W, the band weights' and the outputs' (the plain path's
// promotion of T and W, which is W wherever the wrapper launches).
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
// snicar_math.cu: log10 compiled with contracted multiply-adds
extern __device__ float snicar_log10(float x);
extern __device__ double snicar_log10(double x);
#else
#define HD inline
#define UNROLL
#endif

// A branch of the sweep taken (the host tests count them through this hook)
#ifndef K3_NOTE
#define K3_NOTE(what)
#endif

namespace {

constexpr int kSno = 5;                // NLEVSNO
constexpr int kIface = kSno + 1;       // interfaces, the ground's included
constexpr int kBands = 5;              // NUMRAD_SNW
constexpr int kAerBands = 3;           // bands that carry aerosols
constexpr int kSpecies = 8;            // SNO_NBR_AER
constexpr int kGauss = 8;              // Gaussian points of the diffuse rows
constexpr int kMie = 1471;             // IDX_MIE_SNW_MX
constexpr int kRdsMinTbl = 30;         // SNW_RDS_MIN_TBL
constexpr int kIceRdsMax = 7;          // IDX_BCINT_ICERDS_MAX
constexpr int kNclRds = 1;             // the BC radius index, fixed

// What K3_NOTE counts
enum { kNoteZeroLayer, kNotePuny };

// SnicarTables' fields, in its order
enum {
  tSsOc1, tAsmOc1, tExtOc1, tSsOc2, tAsmOc2, tExtOc2, tSsDst1, tAsmDst1,
  tExtDst1, tSsDst2, tAsmDst2, tExtDst2, tSsDst3, tAsmDst3, tExtDst3,
  tSsDst4, tAsmDst4, tExtDst4, tSsSnwDrc, tAsmSnwDrc, tExtSnwDrc, tSsSnwDfs,
  tAsmSnwDfs, tExtSnwDfs, tSsBc1, tAsmBc1, tExtBc1, tSsBc2, tAsmBc2,
  tExtBc2, tBcenh, kTables
};

// A species' (single-scattering albedo, asymmetry, extinction) tables and
// the offset of the band's entry: the two BC species at radius index
// kNclRds of their [10, 5] tables, the others [5]
struct Species {
  int ss, asm_, ext, offset;
};
HD Species species(int s) {
  switch (s) {
    case 0: return {tSsBc1, tAsmBc1, tExtBc1, kNclRds * kBands};
    case 1: return {tSsBc2, tAsmBc2, tExtBc2, kNclRds * kBands};
    case 2: return {tSsOc1, tAsmOc1, tExtOc1, 0};
    case 3: return {tSsOc2, tAsmOc2, tExtOc2, 0};
    case 4: return {tSsDst1, tAsmDst1, tExtDst1, 0};
    case 5: return {tSsDst2, tAsmDst2, tExtDst2, 0};
    case 6: return {tSsDst3, tAsmDst3, tExtDst3, 0};
    default: return {tSsDst4, tAsmDst4, tExtDst4, 0};
  }
}

// The Python-level numbers of the plain path, as it computes them in double
// (ops/snicar.py:CONSTS, in this order)
struct Consts {
  double min_snw, trmin, puny, exp_min, mu_min, mu_75, rds_min;
  double gpt[kGauss];     // the Gaussian angles, mu_g
  double gpt2[kGauss];    // mu_g * mu_g
  double gmuw[kGauss];    // mu_g * wt_g
  double swt;             // their sum, in order from 0
  double wgt[2][kBands];  // the bands' flux weights, direct then diffuse
  double wgt_sum[2];      // sum(wgt[1:5])
  double sza[6];          // the high-zenith fit's six coefficients
};
constexpr int kConsts = sizeof(Consts) / sizeof(double);

template <typename I, typename W>
struct Args {
  long long n;
  // element of column i: coszen[i * cz_stride], liq[i * liq_stride + p]...
  const I* coszen;
  long long cz_stride;
  const I* h2osno;
  long long h2osno_stride;
  const long long* snl;
  long long snl_stride;
  const I* liq;
  long long liq_stride;
  const I* ice;
  long long ice_stride;
  const I* rds;
  long long rds_stride;
  const I* albsoi;       // [n, 2] with a row stride
  long long albsoi_stride;
  const I* mss;          // [n, 5, 8], contiguous
  const I* tab[kTables];
  W* alb_out[2];         // [n, 2], direct then diffuse
  W* flx_out[2];         // [n, 6, 2]
  unsigned long long* swept;  // columns swept, added to by each launch
  Consts K;
};

// ---- elementwise arithmetic as PyTorch computes it -------------------------

template <typename T>
HD T nmax(T a, T b) { return (a > b || isnan(a)) ? a : b; }

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

// number / tensor: the tensor's reciprocal (then times the number)
template <typename T>
HD T recip(T a) { return T(1) / a; }

HD float texp(float x) { return expf(x); }
HD double texp(double x) { return exp(x); }
HD float tsqrt(float x) { return sqrtf(x); }
HD double tsqrt(double x) { return sqrt(x); }
template <typename T>
HD T tlog10(T x) {
#ifdef __CUDA_ARCH__
  return snicar_log10(x);
#else
  return log10(x);
#endif
}
HD float tround(float x) { return rintf(x); }
HD double tround(double x) { return rint(x); }

// floor division of ints, as // on an integer tensor
HD int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

HD int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

// torch.sum over the 8 species of a layer (see the note at the top)
template <typename T>
HD T sum8(const T (&x)[kSpecies]) {
#ifdef __CUDA_ARCH__
  return ((x[0] + x[4]) + (x[2] + x[6])) + ((x[1] + x[5]) + (x[3] + x[7]));
#else
  if (sizeof(T) == sizeof(double))
    return (((x[0] + x[4]) + (x[1] + x[5])) + (x[2] + x[6])) + (x[3] + x[7]);
  T s = x[0];
  for (int k = 1; k < kSpecies; ++k) s = s + x[k];
  return s;
#endif
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

// ---- a column's inputs -----------------------------------------------------

// A column's slots of the staged inputs: the aerosol masses (layer k,
// species s at sMss + k * 8 + s), the layers' ice, liquid and grain radii
enum { sMss = 0, sIce = sMss + kSno * kSpecies, sLiq = sIce + kSno,
       sRds = sLiq + kSno, kStage = sRds + kSno };

// A thread's sweep slots: each layer's five coefficients (rdir, tdir,
// trnlay, rdif, tdif at cCoef + 5k), three top-down values an interface
// (trndir, trntdr, rdndif for the direct beam; trndif, rdndif for the
// diffuse one), the visible band's layer absorption; in the W slots, the
// near-IR sums of the layer absorption (two halves on the card)
enum { cCoef = 0, cDown = cCoef + 5 * kSno, cVis = cDown + 3 * kIface,
       kTSlots = cVis + kIface };
enum { wNirA = 0, wNirB = wNirA + kIface, kWSlots = wNirB + kIface };

// The per-column scalars, in the sweep's type
template <typename T>
struct Column {
  T coszen, h2osno, alb0, alb1;
  long long snl;
  bool active, thin;
};

template <typename I, typename T, typename W>
HD Column<T> load_column(const Args<I, W>& A, long long i) {
  Column<T> c;
  c.coszen = T(load(A.coszen + i * A.cz_stride));
  c.h2osno = T(load(A.h2osno + i * A.h2osno_stride));
  c.alb0 = T(load(A.albsoi + i * A.albsoi_stride));
  c.alb1 = T(load(A.albsoi + i * A.albsoi_stride + 1));
  c.snl = load(A.snl + i * A.snl_stride);
  const T min_snw = T(A.K.min_snw);
  c.active = c.coszen > T(0) && c.h2osno > min_snw;
  c.thin = c.coszen > T(0) && c.h2osno < min_snw && c.h2osno > T(0);
  return c;
}

// Slot s of the column's staged inputs at stage[s * ld]; the thread's
// sweep slots at t[s * tld] and w[s * tld]
template <typename T, typename W>
struct Lane {
  const T* stage;
  int ld;
  T* t;
  W* w;
  int tld;
  HD T in(int s) const { return stage[s * ld]; }
  HD T& ts(int s) const { return t[s * tld]; }
  HD W& ws(int s) const { return w[s * tld]; }
};

// ---- one layer's optics -----------------------------------------------------

template <typename T>
struct Coef {
  T rdir, tdir, trnlay, rdif, tdif;
};

// The apparent optics of an active layer k in band row `band` of `beam`
// (snow_aerosol_mie_params, the delta transform and the layer part of
// snow_radiative_transfer_solver: impl:105-309, 311-484)
template <typename I, typename T, typename W>
HD Coef<T> layer_optics(const Args<I, W>& A, const Lane<T, W>& L,
                        int beam, int band, int k, bool nosnl, T h2osno,
                        int r, T mu) {
  const Consts& K = A.K;
  const T ice = nosnl ? (k == kSno - 1 ? h2osno : T(0)) : L.in(sIce + k);
  const T liq = nosnl ? T(0) : L.in(sLiq + k);
  const T lsnw = ice + liq;
  const int rds_idx = clampi(r - kRdsMinTbl, 0, kMie - 1);
  const int row = band * kMie + rds_idx;
  const int tss = beam ? tSsSnwDfs : tSsSnwDrc;
  const T ss_snw = T(load(A.tab[tss] + row));
  const T asm_snw = T(load(A.tab[tss + 1] + row));
  const T ext_snw = T(load(A.tab[tss + 2] + row));

  T tau_sum = T(0), om_sum = T(0), g_sum = T(0);
  if (band < kAerBands) {
    int icerds = r < 125 ? floordiv(r, 50) - 1
                         : (r < 175 ? 1 : floordiv(r, 250) + 1);
    icerds = clampi(icerds, 0, kIceRdsMax);
    const T enh = T(load(A.tab[tBcenh] + (icerds * 10 + kNclRds) * kBands +
                         band));
    T tau[kSpecies], om[kSpecies], g[kSpecies];
    UNROLL for (int s = 0; s < kSpecies; ++s) {
      const Species sp = species(s);
      const int at = sp.offset + band;
      T ext = T(load(A.tab[sp.ext] + at));
      if (s == 0) ext = ext * enh;
      const T ss = T(load(A.tab[sp.ss] + at));
      const T asm_ = T(load(A.tab[sp.asm_] + at));
      tau[s] = (lsnw * L.in(sMss + k * kSpecies + s)) * ext;
      om[s] = tau[s] * ss;
      g[s] = om[s] * asm_;
    }
    tau_sum = sum8(tau);
    om_sum = sum8(om);
    g_sum = sum8(g);
  }
  const T tau_snw = lsnw * ext_snw;
  const T tau = tau_sum + tau_snw;
  const T om_num = om_sum + ss_snw * tau_snw;
  const bool tpos = tau > T(0);
  const T omega = tpos ? om_num / tau : T(0);
  const T g_num = g_sum + (asm_snw * ss_snw) * tau_snw;
  const bool gpos = tpos && omega > T(0);
  const T g = gpos ? g_num / (tau * omega) : T(0);

  // delta transform (impl:293-298)
  const T gs = g / (g + T(1));
  const T gg = g * g;
  const T ws = ((T(1) - gg) * omega) / (T(1) - omega * gg);
  const T ts = (T(1) - omega * gg) * tau;

  // Delta-Eddington apparent optics (impl:403-454)
  const T exp_min = T(K.exp_min);
  const T one_ws = T(1) - ws;
  const T one_wg = T(1) - ws * gs;
  const T lm = tsqrt(nmax((T(3) * one_ws) * one_wg, T(0)));
  const T lm_s = lm > T(0) ? lm : T(1);
  const T ue = (T(1.5) * one_wg) / lm_s;
  const T extins = nmax(texp(-lm * ts), exp_min);
  const T up1 = ue + T(1), um1 = ue - T(1);
  const T ne = (up1 * up1) / extins - (um1 * um1) * extins;
  const T rdif_de = ((ue * ue - T(1)) * (recip(extins) - extins)) / ne;
  const T tdif_de = (T(4) * ue) / ne;
  const T trnlay = nmax(texp(-ts / mu), exp_min);
  const T lm2 = lm * lm;
  const T mu2 = mu * mu;
  const T denom0 = T(1) - lm2 * mu2;
  const T gws = T(1) + gs * one_ws;
  const T alp0 = (((T(0.75) * ws) * mu) * gws) / denom0;
  const T gam0 = ((T(0.5) * ws) * (T(1) + ((T(3) * gs) * one_ws) * mu2)) /
                 denom0;
  const T apg0 = alp0 + gam0;
  const T amg0 = alp0 - gam0;
  Coef<T> c;
  c.rdir = apg0 * rdif_de + amg0 * (tdif_de * trnlay - T(1));
  c.tdir = apg0 * tdif_de + ((amg0 * rdif_de - apg0) + T(1)) * trnlay;
  c.trnlay = trnlay;

  // Gaussian angular re-integration of rdif/tdif (impl:456-484)
  const T alp_f = (T(0.75) * ws) * gws;
  const T gam_f1 = T(0.5) * ws;
  const T gam_f2 = ((T(1.5) * ws) * gs) * one_ws;
  const T nts = -ts;
  T s_apg = T(0), s_amg = T(0), t_apg = T(0), t_amg = T(0), t_0 = T(0);
  UNROLL for (int q = 0; q < kGauss; ++q) {
    const T muw = T(K.gmuw[q]);
    const T mg2 = T(K.gpt2[q]);
    const T trn = nmax(texp(divs(nts, K.gpt[q])), exp_min);
    const T inv_d = recip(T(1) - lm2 * mg2);
    const T alp = (alp_f * T(K.gpt[q])) * inv_d;
    const T gam = (gam_f1 + gam_f2 * mg2) * inv_d;
    const T apg = alp + gam;
    const T amg = alp - gam;
    s_apg = s_apg + muw * apg;
    s_amg = s_amg + muw * amg;
    t_apg = t_apg + muw * (apg * trn);
    t_amg = t_amg + muw * (amg * trn);
    t_0 = t_0 + muw * trn;
  }
  c.rdif = divs((rdif_de * s_apg + tdif_de * t_amg) - s_amg, K.swt);
  c.tdif = divs(((tdif_de * s_apg + rdif_de * t_amg) - t_apg) + t_0, K.swt);
  return c;
}

// ---- the near-IR sums ---------------------------------------------------------

// torch.sum over the 4 near-IR bands of the layer absorption: on the card
// (x0 + x2) + (x1 + x3) (bands 1 and 3 into slot A, 2 and 4 into B), on the
// CPU in order (slot A)
template <typename T, typename W>
HD void nir_add(const Lane<T, W>& L, int band, int k, W x) {
#ifdef __CUDA_ARCH__
  W& acc = L.ws((band % 2 ? wNirA : wNirB) + k);
#else
  W& acc = L.ws(wNirA + k);
  (void)band;
#endif
  acc = acc + x;
}

template <typename T, typename W>
HD W nir_total(const Lane<T, W>& L, int k) {
#ifdef __CUDA_ARCH__
  return L.ws(wNirA + k) + L.ws(wNirB + k);
#else
  return L.ws(wNirA + k);
#endif
}

// ---- one beam of a column ---------------------------------------------------------

// The outputs of an inactive column: the soil albedo where the snow is
// thin, else 0; no absorption
template <typename I, typename T, typename W>
HD void write_inactive(const Args<I, W>& A, const Column<T>& c, int beam,
                       long long i) {
  W* alb = A.alb_out[beam] + i * 2;
  alb[0] = c.thin ? W(c.alb0) : W(0);
  alb[1] = c.thin ? W(c.alb1) : W(0);
  W* flx = A.flx_out[beam] + i * 2 * kIface;
  for (int j = 0; j < 2 * kIface; ++j) flx[j] = W(0);
}

// The interface flux of the beam from its top-down values and the
// reflectivities below (impl:560-588), PUNY clamped
template <typename T>
HD T iface_flux(int beam, T d0, T d1, T rdndif, T rupdir, T rupdif,
                T puny) {
  const T refk = recip(T(1) - rdndif * rupdif);
  T f;
  if (beam == 0)  // d0 = trndir, d1 = trntdr
    f = (d0 + ((d1 - d0) * (T(1) - rupdif)) * refk) -
        ((d0 * rupdir) * (T(1) - rdndif)) * refk;
  else            // d0 = trndif
    f = (d0 * (T(1) - rupdif)) * refk;
  if (f < puny) {
    if (f != T(0)) K3_NOTE(kNotePuny);
    f = T(0);
  }
  return f;
}

// Beam `beam` of active column i: the sweep over its five band rows, then
// snow_albedo_radiation_factor (impl:671-771) into its outputs
template <typename I, typename T, typename W>
HD void run_beam(const Args<I, W>& A, const Column<T>& c, const Lane<T, W>& L,
                 int beam, long long i) {
  const Consts& K = A.K;
  const bool nosnl = c.snl == 0;
  const long long snl_lcl = nosnl ? 1 : c.snl;
  const long long top = kSno - snl_lcl;  // the top active layer
  // the layers swept, [k0, 5)
  const int k0 = top < 0 ? 0 : (top > kSno ? kSno : static_cast<int>(top));
  const T mu = nmax(c.coszen, T(K.mu_min));
  const T trmin = T(K.trmin), puny = T(K.puny);
  const int rds_min = static_cast<int>(K.rds_min);

  for (int k = 0; k < kIface; ++k) {
    L.ts(cVis + k) = T(0);
    L.ws(wNirA + k) = W(0);
    L.ws(wNirB + k) = W(0);
  }
  T alb_vis = T(0);
  W alb_nir = W(0);

  for (int band = 0; band < kBands; ++band) {
    // top-down interface recursion (impl:403-510)
    T trndir = T(1), trntdr = T(1), trndif = T(1), rdndif = T(0);
    for (int k = k0; k < kSno; ++k) {
      L.ts(cDown + 3 * k) = beam ? trndif : trndir;
      L.ts(cDown + 3 * k + 1) = trntdr;
      L.ts(cDown + 3 * k + 2) = rdndif;
      Coef<T> f;
      if (trntdr > trmin) {
        const int r = nosnl ? rds_min
                            : static_cast<int>(tround(L.in(sRds + k)));
        f = layer_optics<I, T, W>(A, L, beam, band, k, nosnl, c.h2osno, r,
                                  mu);
      } else {
        K3_NOTE(kNoteZeroLayer);
        f = Coef<T>{T(0), T(0), T(0), T(0), T(0)};
      }
      T* cf = &L.ts(cCoef + 5 * k);
      cf[0] = f.rdir;
      cf[L.tld] = f.tdir;
      cf[2 * L.tld] = f.trnlay;
      cf[3 * L.tld] = f.rdif;
      cf[4 * L.tld] = f.tdif;
      const T refkm1 = recip(T(1) - rdndif * f.rdif);
      const T tdrrdir = trndir * f.rdir;
      const T tdndif = trntdr - trndir;
      const T n_trntdr = trndir * f.tdir +
                         ((tdndif + tdrrdir * rdndif) * refkm1) * f.tdif;
      const T n_trndif = (trndif * refkm1) * f.tdif;
      const T n_rdndif = f.rdif + ((f.tdif * rdndif) * refkm1) * f.tdif;
      trndir = trndir * f.trnlay;
      trntdr = n_trntdr;
      trndif = n_trndif;
      rdndif = n_rdndif;
    }

    // bottom-up reflectivities (impl:526-544) with the interface fluxes
    // and the layers' absorption (impl:560-646), from the ground up
    const T soil = band == 0 ? c.alb0 : c.alb1;
    T rupdir = soil, rupdif = soil;
    T df_below = iface_flux(beam, beam ? trndif : trndir, trntdr, rdndif,
                            rupdir, rupdif, puny);
    const W wgt = W(K.wgt[beam][band]);
    const T f_btm = nmax(df_below, T(0));
    if (band == 0)
      L.ts(cVis + kSno) = f_btm;
    else
      nir_add(L, band, kSno, wgt * W(f_btm));
    for (int k = kSno - 1; k >= k0; --k) {
      const T* cf = &L.ts(cCoef + 5 * k);
      const T rdir = cf[0], tdir = cf[L.tld], trnlay = cf[2 * L.tld];
      const T rdif = cf[3 * L.tld], tdif = cf[4 * L.tld];
      const T refkp1 = recip(T(1) - rdif * rupdif);
      const T n_rupdir =
          rdir + ((trnlay * rupdir + (tdir - trnlay) * rupdif) * refkp1) *
                     tdif;
      rupdif = rdif + ((tdif * rupdif) * refkp1) * tdif;
      rupdir = n_rupdir;
      const T df = iface_flux(beam, L.ts(cDown + 3 * k),
                              L.ts(cDown + 3 * k + 1),
                              L.ts(cDown + 3 * k + 2), rupdir, rupdif, puny);
      const T f_abs = nmax(df - df_below, T(0));
      df_below = df;
      if (band == 0)
        L.ts(cVis + k) = f_abs;
      else
        nir_add(L, band, k, wgt * W(f_abs));
    }
    const T albout = beam ? rupdif : rupdir;
    if (band == 0)
      alb_vis = albout;
    else
      alb_nir = alb_nir + wgt * W(albout);
  }

  // snow_albedo_radiation_factor (impl:671-771)
  const double wgt_sum = K.wgt_sum[beam];
  alb_nir = divs(alb_nir, wgt_sum);
  W* flx = A.flx_out[beam] + i * 2 * kIface;
  W adjust_top = W(0);
  bool adjust = false;
  if (beam == 0) {
    // near-IR direct adjustment for high solar zenith angle (impl:747-760)
    const T mu2 = mu * mu;
    const T c1 = (T(K.sza[0]) - T(K.sza[1]) * mu) + T(K.sza[2]) * mu2;
    const T c0 = (T(K.sza[3]) - T(K.sza[4]) * mu) + T(K.sza[5]) * mu2;
    int r_top = 0;
    if (top >= 0 && top < kSno)
      r_top = nosnl ? rds_min
                    : static_cast<int>(tround(L.in(sRds + top)));
    const T factor = c1 * (tlog10(T(r_top)) - T(6)) + c0;
    adjust = mu < T(K.mu_75);
    adjust_top = (alb_nir * W(factor - T(1))) * W(wgt_sum);
    if (adjust) alb_nir = alb_nir * W(factor);
  }
  W* alb = A.alb_out[beam] + i * 2;
  alb[0] = W(alb_vis);
  alb[1] = alb_nir;
  for (int k = 0; k < kIface; ++k) {
    W nir = divs(nir_total(L, k), wgt_sum);
    if (adjust && k == top) nir = nir - adjust_top;
    flx[2 * k] = W(L.ts(cVis + k));
    flx[2 * k + 1] = nir;
  }
}

// Beam `beam` of column i, active or not
template <typename I, typename T, typename W>
HD void run_column_beam(const Args<I, W>& A, const Column<T>& c,
                        const Lane<T, W>& L, int beam, long long i) {
  if (c.active)
    run_beam<I, T, W>(A, c, L, beam, i);
  else
    write_inactive<I, T, W>(A, c, beam, i);
}

// Column i's staged inputs into its slots (stride ld), in the sweep's type
template <typename I, typename T, typename W>
HD void stage_column(const Args<I, W>& A, long long i, T* stage, int ld) {
  for (int s = 0; s < kSno * kSpecies; ++s)
    stage[(sMss + s) * ld] = T(load(A.mss + i * kSno * kSpecies + s));
  for (int p = 0; p < kSno; ++p) {
    stage[(sIce + p) * ld] = T(load(A.ice + i * A.ice_stride + p));
    stage[(sLiq + p) * ld] = T(load(A.liq + i * A.liq_stride + p));
    stage[(sRds + p) * ld] = T(load(A.rds + i * A.rds_stride + p));
  }
}

// Column i, both beams, on the host (what the CPU tests run)
template <typename I, typename T, typename W>
void run_column(const Args<I, W>& A, long long i) {
  T stage[kStage];
  T t[kTSlots];
  W w[kWSlots];
  const Column<T> c = load_column<I, T, W>(A, i);
  if (c.active) stage_column<I, T, W>(A, i, stage, 1);
  const Lane<T, W> L{stage, 1, t, w, 1};
  for (int beam = 0; beam < 2; ++beam)
    run_column_beam<I, T, W>(A, c, L, beam, i);
}

template <typename I, typename W>
Args<I, W> make_args(long long n, const void* const* in,
                     const long long* stride, const void* snl,
                     long long snl_stride, const void* const* tab,
                     const double* consts, void* const* out, void* swept) {
  Args<I, W> A;
  A.n = n;
  A.coszen = static_cast<const I*>(in[0]);
  A.h2osno = static_cast<const I*>(in[1]);
  A.liq = static_cast<const I*>(in[2]);
  A.ice = static_cast<const I*>(in[3]);
  A.rds = static_cast<const I*>(in[4]);
  A.albsoi = static_cast<const I*>(in[5]);
  A.mss = static_cast<const I*>(in[6]);
  A.cz_stride = stride[0];
  A.h2osno_stride = stride[1];
  A.liq_stride = stride[2];
  A.ice_stride = stride[3];
  A.rds_stride = stride[4];
  A.albsoi_stride = stride[5];
  A.snl = static_cast<const long long*>(snl);
  A.snl_stride = snl_stride;
  for (int k = 0; k < kTables; ++k) A.tab[k] = static_cast<const I*>(tab[k]);
  double* k = reinterpret_cast<double*>(&A.K);
  for (int j = 0; j < kConsts; ++j) k[j] = consts[j];
  for (int b = 0; b < 2; ++b) {
    A.alb_out[b] = static_cast<W*>(out[2 * b]);
    A.flx_out[b] = static_cast<W*>(out[2 * b + 1]);
  }
  A.swept = static_cast<unsigned long long*>(swept);
  return A;
}

// ---- the launch --------------------------------------------------------------

// Columns a block (each with a direct and a diffuse thread), and the stride
// of a staged slot (kCols + 1, so that a thread reading its column's slots
// and the flat staging passes both spread over the banks)
constexpr int kCols = 64;
constexpr int kThreads = 2 * kCols;
constexpr int kLd = kCols + 1;

// Dynamic shared memory a block: the staged inputs, the threads' T slots,
// then their W slots (8-byte aligned)
template <typename T, typename W>
constexpr int smem_bytes() {
  return (kStage * kLd * static_cast<int>(sizeof(T)) +
          kTSlots * kThreads * static_cast<int>(sizeof(T)) + 7) / 8 * 8 +
         kWSlots * kThreads * static_cast<int>(sizeof(W));
}

#ifdef __CUDACC__

// The block's columns' masses and layer values into the staged slots, each
// input as one flat range of the block's rows (consecutive threads read
// consecutive elements), kBatch loads in flight a thread
constexpr int kBatch = 8;

template <typename I, typename T, typename F>
__device__ __forceinline__ void stage_range(int total, int tid, F&& at,
                                            T* stage) {
  for (int k0 = tid; k0 < total; k0 += kBatch * kThreads) {
    I v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u * kThreads;
      if (k < total) v[u] = load(at.src(k));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u * kThreads;
      if (k < total) stage[at.slot(k)] = T(v[u]);
    }
  }
}

template <typename I>
struct MssAt {
  const I* base;
  __device__ const I* src(int k) const { return base + k; }
  __device__ int slot(int k) const {
    return (sMss + k % (kSno * kSpecies)) * kLd + k / (kSno * kSpecies);
  }
};

template <typename I>
struct LayerAt {
  const I* base;
  long long stride;
  int s0;
  __device__ const I* src(int k) const {
    return base + (k / kSno) * stride + k % kSno;
  }
  __device__ int slot(int k) const {
    return (s0 + k % kSno) * kLd + k / kSno;
  }
};

template <typename I, typename T, typename W>
__device__ void stage_block(const Args<I, W>& A, long long i0, int rows,
                            int tid, T* stage) {
  stage_range<I, T>(rows * kSno * kSpecies, tid,
                    MssAt<I>{A.mss + i0 * kSno * kSpecies}, stage);
  stage_range<I, T>(rows * kSno, tid,
                    LayerAt<I>{A.ice + i0 * A.ice_stride, A.ice_stride, sIce},
                    stage);
  stage_range<I, T>(rows * kSno, tid,
                    LayerAt<I>{A.liq + i0 * A.liq_stride, A.liq_stride, sLiq},
                    stage);
  stage_range<I, T>(rows * kSno, tid,
                    LayerAt<I>{A.rds + i0 * A.rds_stride, A.rds_stride, sRds},
                    stage);
}

// Resident blocks an SM asked of ptxas: four (16 warps) with a float
// sweep, two with a double one, which the shared memory allows (4 x
// 51,680 B with float64 weights, 2 x 91,064 B, of the SM's 228 KB)
template <typename T>
struct MinBlocks {
  static constexpr int value = sizeof(T) == 4 ? 4 : 2;
};

template <typename I, typename T, typename W>
__global__ void __launch_bounds__(kThreads, MinBlocks<T>::value)
    snicar_kernel(const Args<I, W> A) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);
  T* tslots = stage + kStage * kLd;
  W* wslots = reinterpret_cast<W*>(
      smem + (kStage * kLd * sizeof(T) + kTSlots * kThreads * sizeof(T) + 7) /
                 8 * 8);
  const int tid = threadIdx.x;
  const int beam = tid / kCols;
  const int r = tid % kCols;
  const long long i0 = static_cast<long long>(blockIdx.x) * kCols;
  const long long left = A.n - i0;
  const int rows = left < kCols ? static_cast<int>(left) : kCols;
  const long long i = i0 + r;
  Column<T> c{};
  if (r < rows) c = load_column<I, T, W>(A, i);
  if (__syncthreads_or(c.active)) {
    stage_block<I, T, W>(A, i0, rows, tid, stage);
    __syncthreads();
  }
  // the columns swept, one atomic a warp of the direct beam
  const unsigned swept = __ballot_sync(0xffffffffu, c.active && beam == 0);
  if ((tid & 31) == 0 && swept)
    atomicAdd(A.swept, static_cast<unsigned long long>(__popc(swept)));
  if (r >= rows) return;
  const Lane<T, W> L{stage + r, kLd, tslots + tid, wslots + tid, kThreads};
  run_column_beam<I, T, W>(A, c, L, beam, i);
}

constexpr int kMaxDevices = 64;

// Sets the kernel's dynamic shared memory limit, once per device
template <typename I, typename T, typename W>
int prepare() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(snicar_kernel<I, T, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<T, W>());
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <typename I, typename T, typename W>
int launch(const Args<I, W>& A, cudaStream_t s) {
  if (A.n <= 0) return cudaSuccess;
  const int err = prepare<I, T, W>();
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((A.n + kCols - 1) / kCols);
  snicar_kernel<I, T, W><<<grid, kThreads, smem_bytes<T, W>(), s>>>(A);
  return static_cast<int>(cudaGetLastError());
}

// {threads a block, registers a thread, local memory bytes a thread
// (spills), resident blocks an SM, dynamic shared memory bytes a block}
template <typename I, typename T, typename W>
int layout_of(int* out) {
  cudaError_t err = static_cast<cudaError_t>(prepare<I, T, W>());
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, snicar_kernel<I, T, W>);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, snicar_kernel<I, T, W>, kThreads, smem_bytes<T, W>());
  if (err != cudaSuccess) return err;
  out[0] = kThreads;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = per_sm;
  out[4] = smem_bytes<T, W>();
  return cudaSuccess;
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// in: coszen, h2osno, h2osoi_liq, h2osoi_ice, snw_rds, albsoi, mss_cnc_aer
// (type I) and their strides in elements (a row's for the layered ones;
// mss_cnc_aer contiguous [n, 5, 8]); snl int64 with its stride; tab: the
// kTables SnicarTables fields (type I, contiguous); consts: kConsts doubles
// (ops/snicar.py:CONSTS); out: albout [n, 2] and flx_abs [n, 6, 2] of the
// direct, then the diffuse beam (type W, contiguous); swept: an unsigned
// 64-bit counter the launch adds its swept columns to.  Launches on
// `stream`; returns the first CUDA error.
#define SNICAR_ENTRY(NAME, I, T, W)                                          \
  extern "C" int NAME(long long n, const void* const* in,                    \
                      const long long* stride, const void* snl,              \
                      long long snl_stride, const void* const* tab,          \
                      const double* consts, void* const* out, void* swept,   \
                      void* stream) {                                        \
    const Args<I, W> A = make_args<I, W>(n, in, stride, snl, snl_stride,     \
                                         tab, consts, out, swept);           \
    return launch<I, T, W>(A, static_cast<cudaStream_t>(stream));            \
  }                                                                          \
  extern "C" int NAME##_layout(int* out) { return layout_of<I, T, W>(out); }
SNICAR_ENTRY(snicar_f64_f32_f64, double, float, double)
SNICAR_ENTRY(snicar_f32_f32_f64, float, float, double)
SNICAR_ENTRY(snicar_f64_f64_f64, double, double, double)
SNICAR_ENTRY(snicar_f32_f32_f32, float, float, float)
#undef SNICAR_ENTRY

#endif  // __CUDACC__
