// Batched pentadiagonal solve for the 21-row soil/snow temperature system.
//
// Replaces: elmkernels_tpu/physics/soil_temperature.py:pdma_solve (lines
// 282-337), two lax.scans over the rows (the reference's
// pentadiagonal_solver_impl.hh:14-76, Askar & Karawia 2015).  Rows above a
// column's top active layer are identity rows, which give A = B = Z = 0,
// so every column starts its recurrence at row 0.
//
// One thread per column runs the forward elimination and the back
// substitution in the operation order of the plain version
// (elmkernels_torch/physics/soil_temperature.py:pdma_solve_plain).  Build
// with --fmad=false so no multiply-add is contracted and the results equal
// the plain version's to the last bit.
//
// The solve is one template over the element type T, instantiated for
// float64 (pdma_solve_f64) and float32 (pdma_solve_f32, the model's
// all-float32 mode).  Sizes below are for float64, float32's in brackets.
//
// Bound: bytes.  Per column the solve reads 105 + 21 elements and writes
// 21 (1176 B [588 B]) for ~400 flops, far below the card's flop/byte
// balance.  A column's bands and right-hand side are contiguous, so a tile
// of kTile consecutive columns is one contiguous range of lhs
// (kTile x 840 B [420 B]) and one of rhs (kTile x 168 B [84 B]).  The design moves those ranges with
// Hopper's bulk asynchronous copy and leaves the recurrence per thread:
//
// - A persistent grid: (SMs x resident blocks per SM) blocks, both read at
//   run time, capped at the number of tiles; block b walks tiles b,
//   b + gridDim.x, ...  No part-empty last wave.
// - A ring of kStages stages in dynamic shared memory, each one tile's lhs
//   and rhs with its own mbarrier.  Thread 0 issues the bulk loads of the
//   next kStages tiles while the block solves the current one.
// - The recurrence reads its rows from shared memory.  Column strides of
//   105 and 21 elements are odd: a float32 warp's 4-byte accesses hit 32
//   distinct banks, and each half-warp phase of a float64 warp's 8-byte
//   accesses hits 16 distinct bank pairs, so neither conflicts.  A[i] and B[i] overwrite row i's super-diagonal bands and Z[i]
//   the row's right-hand side, as each row is read once; x overwrites Z in
//   the back substitution.  No per-column arrays live in registers.
// - x leaves by one bulk store from the stage's rhs slot, after
//   fence.proxy.async makes the threads' writes visible to the copy engine.
//
// Tile and stages: the solve of a tile is a serial chain of 21 divisions
// per thread, so the card needs many columns solving at once, and every
// column solving holds its 1008 B [504 B] in shared memory.  kTile = 32
// (one warp) and kStages = 2 make a block of 64,528 B [32,272 B], three
// [six] of which fit on an SM (228 KB): 96 [192] columns solve at once and
// up to six 32 KB [twelve 16 KB] loads are in flight per SM, well above
// the ~25 KB that 3.35 TB/s over 132 SMs needs at ~1 us of latency.  For
// float64 a 64-column tile fits one block per SM (two stages), cutting the
// columns that solve at once from 96 to 64.
//
// Alignment: a bulk copy needs 16-B aligned addresses and sizes.  A run
// of kBulkCols columns is a multiple of 16 B in lhs and rhs: 2 columns
// for float64 (1680 B, 336 B), 4 for float32 (1680 B, 336 B).  Tiles start
// at multiples of kTile columns (kTile x 840 B [420 B] and kTile x 168 B
// [84 B] are multiples of 16) and move by bulk copy when they hold a
// multiple of kBulkCols columns.  The one tile that does not, the last
// one when ncol is not such a multiple, is loaded and stored by the
// block's threads with plain coalesced accesses.  The base pointers must
// be 16-B aligned (the wrapper, ops/pdma.py, makes them so); the entry
// points refuse others.

#include <cuda_runtime.h>

#include <cstdint>

#include "pdma_row.cuh"

namespace {

constexpr int kRows = 21;
constexpr int kBands = 5;
constexpr int kLhsCol = kRows * kBands;  // elements of lhs per column
constexpr int kTile = 32;                // columns per tile = threads per block
constexpr int kStages = 2;

constexpr unsigned gcd(unsigned a, unsigned b) { return b ? gcd(b, a % b) : a; }

// Shared-memory layout and bulk-copy granule of the solve in type T.
template <typename T>
struct Layout {
  static constexpr unsigned kLhsTileBytes = kTile * kLhsCol * sizeof(T);
  static constexpr unsigned kRhsTileBytes = kTile * kRows * sizeof(T);
  static constexpr unsigned kStageBytes = kLhsTileBytes + kRhsTileBytes;
  static constexpr unsigned kSmemBytes =
      kStages * kStageBytes + kStages * sizeof(unsigned long long);
  // fewest columns whose lhs and rhs are both whole multiples of 16 B
  static constexpr unsigned kLhsCols = 16 / gcd(16, kLhsCol * sizeof(T));
  static constexpr unsigned kRhsCols = 16 / gcd(16, kRows * sizeof(T));
  static constexpr int kBulkCols = kLhsCols > kRhsCols ? kLhsCols : kRhsCols;
  static_assert(kTile % kBulkCols == 0 && kLhsTileBytes % 16 == 0 &&
                    kRhsTileBytes % 16 == 0 && kStageBytes % 16 == 0,
                "stages must keep 16-B alignment for the bulk copies");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

// One arrival, and the bytes the stage's bulk loads will bring.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// One column in shared memory: d [21][5] bands, r [21] right-hand side.
// On return r holds x; d's bands 0 and 1 hold B and A.  The recurrence is
// pdma_row.cuh's, which K7 sweeps too.
template <typename T>
__device__ __forceinline__ void solve_column(T* d, T* r) {
  PdmaAbz<T> p2 = pdma_row0(d[0], d[1], d[2], r[0]);  // row i - 2
  d[1] = p2.a;
  d[0] = p2.b;
  r[0] = p2.z;

  PdmaAbz<T> p1 = pdma_row1(d[kBands + 0], d[kBands + 1], d[kBands + 2],
                            d[kBands + 3], r[1], p2);  // row i - 1
  d[kBands + 1] = p1.a;
  d[kBands + 0] = p1.b;
  r[1] = p1.z;

#pragma unroll
  for (int i = 2; i < kRows; ++i) {
    T* di = d + i * kBands;
    const PdmaAbz<T> p = pdma_row(di[0], di[1], di[2], di[3], di[4], r[i],
                                  p2, p1);
    di[1] = p.a;
    di[0] = p.b;
    r[i] = p.z;
    p2 = p1;
    p1 = p;
  }

  // x[20] = Z[20] (already in r[20]); x[19] = Z[19] - A[19] x[20]
  T xp2 = p1.z;
  T xp1 = pdma_back1(p2, xp2);
  r[kRows - 2] = xp1;
#pragma unroll
  for (int i = kRows - 3; i >= 0; --i) {
    const T xi = pdma_back(PdmaAbz<T>{d[i * kBands + 1], d[i * kBands], r[i]},
                           xp1, xp2);
    r[i] = xi;
    xp2 = xp1;
    xp1 = xi;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTile)
    pdma_kernel(long long ncol, const T* __restrict__ lhs,
                const T* __restrict__ rhs, T* __restrict__ x) {
  using L = Layout<T>;
  constexpr unsigned kStageBytes = L::kStageBytes;
  constexpr unsigned kLhsTileBytes = L::kLhsTileBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem + kStages * kStageBytes);
  const int tid = threadIdx.x;
  const long long ntiles = (ncol + kTile - 1) / kTile;
  auto count = [ncol](long long t) {
    const long long c = ncol - t * kTile;
    return c < kTile ? static_cast<int>(c) : kTile;
  };
  // Thread 0: start the bulk loads of tile t into stage s.  A tile whose
  // count is not a multiple of kBulkCols is left to the threads.
  auto issue = [&](long long t, int s) {
    const int cnt = count(t);
    if (cnt % L::kBulkCols) return;
    unsigned char* st = smem + s * kStageBytes;
    const uint32_t bar = smem_addr(&bars[s]);
    const uint32_t lb = cnt * kLhsCol * sizeof(T);
    const uint32_t rb = cnt * kRows * sizeof(T);
    mbar_expect_tx(bar, lb + rb);
    bulk_load(smem_addr(st), lhs + t * kTile * kLhsCol, lb, bar);
    bulk_load(smem_addr(st + kLhsTileBytes), rhs + t * kTile * kRows, rb,
              bar);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_addr(&bars[s]));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < kStages; ++s) {
      const long long t = blockIdx.x + static_cast<long long>(s) * gridDim.x;
      if (t < ntiles) issue(t, s);
    }
  }
  __syncthreads();

  uint32_t phase = 0;  // bit s: parity of stage s's next completion
  int s = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    T* sl = reinterpret_cast<T*>(smem + s * kStageBytes);
    T* sr = reinterpret_cast<T*>(smem + s * kStageBytes + kLhsTileBytes);
    const int cnt = count(t);
    const long long c0 = t * kTile;
    const bool bulk = cnt % L::kBulkCols == 0;
    if (bulk) {
      mbar_wait(smem_addr(&bars[s]), (phase >> s) & 1u);
      phase ^= 1u << s;
    } else {
      for (int j = tid; j < cnt * kLhsCol; j += kTile)
        sl[j] = lhs[c0 * kLhsCol + j];
      for (int j = tid; j < cnt * kRows; j += kTile)
        sr[j] = rhs[c0 * kRows + j];
      __syncthreads();
    }
    if (tid < cnt) solve_column(sl + tid * kLhsCol, sr + tid * kRows);
    // the threads' writes to the stage become visible to the copy engine,
    // which reads x from it next and then loads a new tile over it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (bulk) {
      if (tid == 0) {
        bulk_store(x + c0 * kRows, smem_addr(sr),
                   cnt * kRows * sizeof(T));
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
        const long long next = t + static_cast<long long>(kStages) * gridDim.x;
        if (next < ntiles) issue(next, s);
      }
    } else {
      for (int j = tid; j < cnt * kRows; j += kTile) x[c0 * kRows + j] = sr[j];
    }
    s = s + 1 == kStages ? 0 : s + 1;
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

constexpr int kMaxDevices = 64;

// Blocks of pdma_kernel<T> resident on the current device: SMs x blocks
// per SM at Layout<T>::kSmemBytes of dynamic shared memory.  Sets the
// kernel's shared memory limit first (float64's needs more than the
// default 48 KB).  Cached per device and type.
template <typename T>
int resident_blocks(int* sms_out, int* per_sm_out) {
  constexpr unsigned kSmemBytes = Layout<T>::kSmemBytes;
  static int sms[kMaxDevices], per_sm[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(pdma_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    int n = 0, k = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &k, pdma_kernel<T>, kTile, kSmemBytes);
    if (err != cudaSuccess) return err;
    if (k < 1) return cudaErrorInvalidConfiguration;
    sms[dev] = n;
    per_sm[dev] = k;
  }
  *sms_out = sms[dev];
  *per_sm_out = per_sm[dev];
  return cudaSuccess;
}

template <typename T>
int launch(long long ncol, const void* lhs, const void* rhs, void* x,
           void* stream) {
  if (ncol <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(lhs) | reinterpret_cast<uintptr_t>(rhs) |
       reinterpret_cast<uintptr_t>(x)) % 16)
    return cudaErrorMisalignedAddress;
  int sms = 0, per_sm = 0;
  const int err = resident_blocks<T>(&sms, &per_sm);
  if (err != cudaSuccess) return err;
  const long long ntiles = (ncol + kTile - 1) / kTile;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const long long grid = ntiles < cap ? ntiles : cap;
  pdma_kernel<T><<<static_cast<unsigned>(grid), kTile, Layout<T>::kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      ncol, static_cast<const T*>(lhs), static_cast<const T*>(rhs),
      static_cast<T*>(x));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int layout(int* out) {
  int sms = 0, per_sm = 0;
  const int err = resident_blocks<T>(&sms, &per_sm);
  if (err != cudaSuccess) return err;
  out[0] = kTile;
  out[1] = kStages;
  out[2] = static_cast<int>(Layout<T>::kSmemBytes);
  out[3] = per_sm;
  out[4] = sms;
  return cudaSuccess;
}

}  // namespace

// lhs [ncol, 21, 5], rhs [ncol, 21], x [ncol, 21]: contiguous float64
// (float32) on the device, each 16-B aligned.  Launches on `stream` and
// returns the first CUDA error (cudaErrorMisalignedAddress for an
// unaligned pointer).
extern "C" int pdma_solve_f64(long long ncol, const void* lhs, const void* rhs,
                              void* x, void* stream) {
  return launch<double>(ncol, lhs, rhs, x, stream);
}

extern "C" int pdma_solve_f32(long long ncol, const void* lhs, const void* rhs,
                              void* x, void* stream) {
  return launch<float>(ncol, lhs, rhs, x, stream);
}

// What the launch of the solve in elements of `elem_bytes` bytes (8 or 4)
// chooses on the current device: out = {columns per tile, stages, dynamic
// shared memory bytes per block, resident blocks per SM, SMs}.  Returns a
// CUDA error code.
extern "C" int pdma_solve_layout(int elem_bytes, int* out) {
  if (elem_bytes == 8) return layout<double>(out);
  if (elem_bytes == 4) return layout<float>(out);
  return cudaErrorInvalidValue;
}
