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
// One thread per leaf runs that leaf's whole solve, solve_leaf (in
// ci_leaf.cuh, beside the resumable machine K1-T and K2 run): the sequence
// the leaf follows in the masked batch loop, to its own end.  Compiled for
// float and double; build with --fmad=false so the arithmetic is the plain
// version's, operation by operation (a re-fused ci solve drifted ~1e-4
// after 40 secant iterations in the JAX package's history).
//
// The tangent version (K1-T) runs the same solve on Dual<double>, a
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
// K1 (one thread a leaf, solve_leaf to its end) is bound by bytes: a leaf
// reads 21 values and writes 8 for ~4 residual evaluations of ~70 flops.
// K1-T reads 41 and writes 15 (437 B), and each evaluation on duals is a
// chain of ~30 dependent f64 divisions and 3 square roots.  Run as K1 is,
// one thread a leaf, it held a leaf's 38 env doubles in registers (168-184
// a thread, 8 warps an SM) and each warp ran as long as its slowest leaf,
// which left 0.26-0.28 of its lanes' evaluation slots used on its test
// problems.
// So K1-T runs solve_leaf's sequence as a resumable per-leaf machine, one
// residual evaluation a step (leaf_begin and leaf_after in ci_leaf.cuh,
// shared with K2; leaf_eval below), on warps whose
// lanes take a new leaf as soon as theirs ends (ci_jvp_kernel, below): the
// env sits in shared memory and is read where ci_func uses it, and every
// lane evaluates until the leaves run out.  The arithmetic is solve_leaf's,
// operation by operation; only the schedule differs.  Its bound is bytes
// where no leaf needs an evaluation (it then moves only its 437 B a leaf);
// where leaves do, what holds it is the slowest leaf's chain of dependent
// evaluations and the lanes that idle once the chunks run out, not the
// f64 pipe (PERF.md, the table of kernels and K1-T's redesign).

#include "ci_leaf.cuh"

namespace {

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

template <typename R>
struct Real<Dual<R>> { using type = R; };

// K1-T's env: a leaf's 19 fields in a [field][lane] array in shared memory
// (EnvRef, ci_leaf.cuh), read where ci_func uses them.
template <typename T>
HD EnvRef<T> env_ref(const T (*f)[kLanes], int lane) {
  return {f[0][lane],  f[1][lane],  f[2][lane],  f[3][lane],  f[4][lane],
          f[5][lane],  f[6][lane],  f[7][lane],  f[8][lane],  f[9][lane],
          f[10][lane], f[11][lane], f[12][lane], f[13][lane], f[14][lane],
          f[15][lane], f[16][lane], f[17][lane], f[18][lane]};
}

// One step of the machine: the residual at leaf_point(s) with the leaf's
// env `e`, its rates committed to rates[k][lane] and its gs_mol to s;
// then leaf_after.
template <typename T, int MODE, typename E>
HD bool leaf_eval(Leaf<T>& s, const E& e, T (*rates)[kLanes], int lane,
                  T& xfin) {
  Out<T> o;
  o.gs = s.gs;
  const T f = ci_func<T, MODE>(leaf_point(s), o, e);
  s.gs = o.gs;
  rates[0][lane] = o.ac;
  rates[1][lane] = o.aj;
  rates[2][lane] = o.ap;
  rates[3][lane] = o.ag;
  rates[4][lane] = o.an;
  return leaf_after(s, f, xfin);
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

// ---- K1-T: the tangent solve on a persistent grid --------------------------
//
// Each warp is on its own: it claims chunks of 32 consecutive leaves from
// the launch's counter (one atomic a chunk), stages a chunk's env values and
// tangents, x0 and enabled flags into shared memory by cp.async (one
// group; coalesced: lane l copies leaf l of every field), and hands the
// chunk's leaves out in order to the lanes that have none.  A lane copies
// its leaf's 19 (value, tangent) fields from the stage into its own column
// of the warp's [field][lane] env and runs leaf_eval on it, one residual
// evaluation a step, reading the fields where ci_func uses them.  A lane
// whose leaf ends writes the leaf's 7 values, 7 tangents and count to
// device memory and takes the next leaf before the next step, so the
// warp's lanes all evaluate until the leaves run out.  When the stage is
// spent it is restaged at once with the next chunk; lanes that still need
// a leaf then wait one step for it, while the others evaluate.
//
// Shared memory, not registers, is what bounds the resident warps: a
// warp's stage, env and rates take 22,560 B, so an SM holds 10 warps (5
// blocks of 2), at ~123 registers a thread.  A second stage (one chunk
// staged ahead) would leave 6 warps an SM; each dual evaluation is a chain
// of dependent f64 divisions whose latency only more warps hide, so the
// warps count for more than the step a few lanes wait once a chunk.

using D = Dual<double>;

constexpr int kJvpWarps = 2;  // warps a block
constexpr int kRates = 5;     // ac, aj, ap, ag, an

struct Chunk {
  D env[kEnv][kLanes];
  D x0[kLanes];
  unsigned char en[kLanes];
};

struct WarpSmem {
  Chunk stage;              // the chunk being handed out, or its successor
  D env[kEnv][kLanes];      // each lane's leaf
  D rates[kRates][kLanes];  // its last committed evaluation's rates
};
constexpr unsigned kJvpSmemBytes = kJvpWarps * sizeof(WarpSmem);
static_assert(sizeof(WarpSmem) % 16 == 0, "warp areas 16-B aligned");

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

struct OutPtrs {
  double* v[7];
  double* t[7];
};

struct JvpArgs {
  long long n;
  Ptrs<double> P, Pt;
  const double* x0;
  const double* x0_t;
  const unsigned char* enabled;
  bool en_aligned;  // enabled is 4-B aligned: full chunks copy it by 4 B
  OutPtrs O;
  int* iters;
  // the launch's own zeroed counters: [0] the next chunk to claim, [1] the
  // sum of the warps' evaluation steps (a step: one evaluation by every
  // lane that holds a leaf)
  unsigned long long* sched;
};

// Stages chunk c into S: one cp.async group of the lane's copies.
__device__ __forceinline__ void stage_chunk(Chunk& S, long long c,
                                            const JvpArgs& A, int lane) {
  const long long base = c * kLanes, i = base + lane;
  if (i < A.n) {
#pragma unroll
    for (int k = 0; k < kEnv; ++k) {
      cp_async(&S.env[k][lane].v, A.P.env[k] + i, 8);
      cp_async(&S.env[k][lane].d, A.Pt.env[k] + i, 8);
    }
    cp_async(&S.x0[lane].v, A.x0 + i, 8);
    cp_async(&S.x0[lane].d, A.x0_t + i, 8);
  }
  if (A.en_aligned && base + kLanes <= A.n) {
    if (lane < kLanes / 4)
      cp_async(&S.en[4 * lane], A.enabled + base + 4 * lane, 4);
  } else if (i < A.n) {
    S.en[lane] = A.enabled[i];
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ long long claim_chunk(const JvpArgs& A,
                                                 int lane) {
  unsigned long long c = 0;
  if (lane == 0) c = atomicAdd(&A.sched[0], 1ULL);
  return static_cast<long long>(__shfl_sync(0xffffffffu, c, 0));
}

// The results of leaf i: ci, gs_mol, the rates (zero for a disabled leaf)
// and the secant iterations.
__device__ __forceinline__ void write_leaf(const JvpArgs& A, long long i,
                                           const D& ci, const D& gs,
                                           const D (*rates)[kLanes], int lane,
                                           bool zero_rates, int it) {
  A.O.v[0][i] = ci.v;
  A.O.t[0][i] = ci.d;
  A.O.v[1][i] = gs.v;
  A.O.t[1][i] = gs.d;
#pragma unroll
  for (int k = 0; k < kRates; ++k) {
    const D r = zero_rates ? D(0.0) : rates[k][lane];
    A.O.v[2 + k][i] = r.v;
    A.O.t[2 + k][i] = r.d;
  }
  A.iters[i] = it;
}

template <int MODE>
__global__ void __launch_bounds__(kJvpWarps * kLanes)
    ci_jvp_kernel(const JvpArgs A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WarpSmem& W = reinterpret_cast<WarpSmem*>(smem_raw)[threadIdx.x / kLanes];
  const int lane = threadIdx.x % kLanes;
  const unsigned full = 0xffffffffu;
  const long long nchunks = (A.n + kLanes - 1) / kLanes;

  // the warp's queue: chunk `cur` in the stage, handed out up to `pos`;
  // the next chunk is staged when this one is spent, and lanes that still
  // need a leaf then wait a step for it
  long long cur = claim_chunk(A, lane);
  if (cur >= nchunks) return;
  stage_chunk(W.stage, cur, A, lane);
  bool loading = true, exhausted = false;
  int pos = 0;
  int valid = static_cast<int>(min(static_cast<long long>(kLanes),
                                   A.n - cur * kLanes));

  Leaf<D> st;
  long long leaf = 0;
  bool has = false;
  unsigned long long steps = 0;
  for (;;) {
    // hand the stage's leaves to the lanes that have none
    unsigned need = __ballot_sync(full, !has);
    if (need && loading) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncwarp();
      loading = false;
    }
    while (need && !loading && pos < valid) {
      const int rank = __popc(need & ((1u << lane) - 1u));
      const int taken = min(valid - pos, __popc(need));
      if (!has && rank < taken) {
        const int p = pos + rank;
#pragma unroll
        for (int k = 0; k < kEnv; ++k) W.env[k][lane] = W.stage.env[k][p];
        leaf = cur * kLanes + p;
        D xfin;
        has = leaf_begin(st, W.stage.x0[p], W.stage.en[p] != 0, xfin);
        if (!has) write_leaf(A, leaf, xfin, D(0.0), W.rates, lane, true, 0);
      }
      pos += taken;
      need = __ballot_sync(full, !has);
    }
    if (!loading && !exhausted && pos == valid) {
      // the stage is spent: its reads are done before it is restaged
      __syncwarp();
      cur = claim_chunk(A, lane);
      if (cur < nchunks) {
        stage_chunk(W.stage, cur, A, lane);
        loading = true;
        pos = 0;
        valid = static_cast<int>(min(static_cast<long long>(kLanes),
                                     A.n - cur * kLanes));
      } else {
        exhausted = true;
      }
    }
    if (!__any_sync(full, has)) {
      if (exhausted) break;
      continue;
    }
    ++steps;
    if (has) {
      D xfin;
      if (!leaf_eval<D, MODE>(st, env_ref(W.env, lane), W.rates, lane,
                              xfin)) {
        write_leaf(A, leaf, xfin, st.gs, W.rates, lane, false, st.it);
        has = false;
      }
    }
  }
  if (lane == 0) atomicAdd(&A.sched[1], steps);
}

// Resident blocks a SM of the K1-T kernel in `mode` on the current device
// (its shared memory limit set first), and the SMs; cached per device.
constexpr int kMaxDevices = 64;

template <int MODE>
int jvp_resident(int* sms_out, int* per_sm_out) {
  static int sms[kMaxDevices], per_sm[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(ci_jvp_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kJvpSmemBytes);
    if (err != cudaSuccess) return err;
    int n = 0, k = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &k, ci_jvp_kernel<MODE>, kJvpWarps * kLanes, kJvpSmemBytes);
    if (err != cudaSuccess) return err;
    if (k < 1) return cudaErrorInvalidConfiguration;
    sms[dev] = n;
    per_sm[dev] = k;
  }
  *sms_out = sms[dev];
  *per_sm_out = per_sm[dev];
  return cudaSuccess;
}

template <int MODE>
int launch_jvp(const JvpArgs& A, cudaStream_t s) {
  int sms = 0, per_sm = 0;
  cudaError_t err = static_cast<cudaError_t>(jvp_resident<MODE>(&sms, &per_sm));
  if (err != cudaSuccess) return err;
  const long long chunks = (A.n + kLanes - 1) / kLanes;
  const long long need = (chunks + kJvpWarps - 1) / kJvpWarps;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const unsigned grid = static_cast<unsigned>(need < cap ? need : cap);
  ci_jvp_kernel<MODE><<<grid, kJvpWarps * kLanes, kJvpSmemBytes, s>>>(A);
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

// The tangent version (K1-T), float64 only.  env/env_t: 19 device
// pointers each (values and tangents, CiEnv order); out: the seven results
// and the iteration count as for ci_hybrid_solve_f64; out_t: the seven
// results' tangents.  sched: two zeroed 8-B counters on the device, the
// launch's own (the chunks it hands out; its warps' evaluation steps, read
// back after the launch).  mode as above.  Launches on `stream`; returns
// the first CUDA error.
extern "C" int ci_hybrid_solve_jvp_f64(int mode, long long n,
                                       const void* const* env,
                                       const void* const* env_t,
                                       const void* x0, const void* x0_t,
                                       const void* enabled, void* const* out,
                                       void* const* out_t, void* sched,
                                       void* stream) {
  if (n <= 0) return 0;
  JvpArgs A;
  A.n = n;
  A.P = ptrs<double>(env);
  A.Pt = ptrs<double>(env_t);
  A.x0 = static_cast<const double*>(x0);
  A.x0_t = static_cast<const double*>(x0_t);
  A.enabled = static_cast<const unsigned char*>(enabled);
  A.en_aligned = reinterpret_cast<uintptr_t>(enabled) % 4 == 0;
  for (int k = 0; k < 7; ++k) {
    A.O.v[k] = static_cast<double*>(out[k]);
    A.O.t[k] = static_cast<double*>(out_t[k]);
  }
  A.iters = static_cast<int*>(out[7]);
  A.sched = static_cast<unsigned long long*>(sched);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kC3:
      return launch_jvp<kC3>(A, s);
    case kC4:
      return launch_jvp<kC4>(A, s);
    case kMixed:
      return launch_jvp<kMixed>(A, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// What K1-T's launch chooses on the current device ("mixed"): out =
// {threads a block, dynamic shared memory bytes a block, resident blocks
// a SM, SMs}.  Returns a CUDA error code.
extern "C" int ci_hybrid_solve_jvp_layout(int* out) {
  int sms = 0, per_sm = 0;
  const int err = jvp_resident<kMixed>(&sms, &per_sm);
  if (err != cudaSuccess) return err;
  out[0] = kJvpWarps * kLanes;
  out[1] = static_cast<int>(kJvpSmemBytes);
  out[2] = per_sm;
  out[3] = sms;
  return cudaSuccess;
}

#endif  // __CUDACC__
