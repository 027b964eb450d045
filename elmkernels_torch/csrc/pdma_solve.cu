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
// Bound: bytes.  Per column the solve reads 105 + 21 doubles and writes
// 21 (1176 B) for ~400 flops, far below the card's flop/byte balance.
// A column's bands and right-hand side are contiguous, so a tile of
// kTile consecutive columns is one contiguous range of lhs (kTile x 840 B)
// and one of rhs (kTile x 168 B).  The design moves those ranges with
// Hopper's bulk asynchronous copy and leaves the recurrence per thread:
//
// - A persistent grid: (SMs x resident blocks per SM) blocks, both read at
//   run time, capped at the number of tiles; block b walks tiles b,
//   b + gridDim.x, ...  No part-empty last wave.
// - A ring of kStages stages in dynamic shared memory, each one tile's lhs
//   and rhs with its own mbarrier.  Thread 0 issues the bulk loads of the
//   next kStages tiles while the block solves the current one.
// - The recurrence reads its rows from shared memory (column strides of
//   105 and 21 doubles are odd, so a warp's 8-byte accesses hit distinct
//   banks).  A[i] and B[i] overwrite row i's super-diagonal bands and Z[i]
//   the row's right-hand side, as each row is read once; x overwrites Z in
//   the back substitution.  No per-column arrays live in registers.
// - x leaves by one bulk store from the stage's rhs slot, after
//   fence.proxy.async makes the threads' writes visible to the copy engine.
//
// Tile and stages: the solve of a tile is a serial chain of 21 divisions
// per thread, so the card needs many columns solving at once, and every
// column solving holds its 1008 B in shared memory.  kTile = 32 (one warp)
// and kStages = 2 make a block of 64,528 B, three of which fit on an SM
// (228 KB): 96 columns solve at once and up to six 32 KB loads are in
// flight per SM, well above the ~25 KB that 3.35 TB/s over 132 SMs needs
// at ~1 us of latency.  A 64-column tile fits one block per SM (two
// stages), cutting the columns that solve at once from 96 to 64.
//
// Alignment: a bulk copy needs 16-B aligned addresses and sizes.  Tiles
// start at even columns and move by bulk copy when they hold an even
// number of columns (kTile x 840 B and kTile x 168 B are multiples of 16).
// The one tile that holds an odd count, the last one for odd ncol, is
// loaded and stored by the block's threads with plain coalesced accesses.
// The base pointers must be 16-B aligned (the wrapper, ops/pdma.py, makes
// them so); pdma_solve_f64 refuses others.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 21;
constexpr int kBands = 5;
constexpr int kLhsCol = kRows * kBands;  // doubles of lhs per column
constexpr int kTile = 32;                // columns per tile = threads per block
constexpr int kStages = 2;
constexpr unsigned kLhsTileBytes = kTile * kLhsCol * sizeof(double);
constexpr unsigned kRhsTileBytes = kTile * kRows * sizeof(double);
constexpr unsigned kStageBytes = kLhsTileBytes + kRhsTileBytes;
constexpr unsigned kSmemBytes =
    kStages * kStageBytes + kStages * sizeof(unsigned long long);
static_assert(kTile % 2 == 0 && kLhsTileBytes % 16 == 0 &&
                  kRhsTileBytes % 16 == 0,
              "stages must keep 16-B alignment for the bulk copies");

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
// On return r holds x; d's bands 0 and 1 hold B and A.
__device__ __forceinline__ void solve_column(double* d, double* r) {
  double U = 1.0 / d[2];
  double a2 = d[1] * U;  // A[i-2], B[i-2], Z[i-2] as i advances
  double b2 = d[0] * U;
  double z2 = r[0] * U;
  d[1] = a2;
  d[0] = b2;
  r[0] = z2;

  double Y = d[kBands + 3];
  U = 1.0 / (d[kBands + 2] - a2 * Y);
  double a1 = (d[kBands + 1] - b2 * Y) * U;  // A[i-1], B[i-1], Z[i-1]
  double b1 = d[kBands + 0] * U;
  double z1 = (r[1] - z2 * Y) * U;
  d[kBands + 1] = a1;
  d[kBands + 0] = b1;
  r[1] = z1;

#pragma unroll
  for (int i = 2; i < kRows; ++i) {
    double* di = d + i * kBands;
    Y = di[3] - a2 * di[4];
    U = 1.0 / (di[2] - b2 * di[4] - a1 * Y);
    const double a = (di[1] - b1 * Y) * U;
    const double b = di[0] * U;
    const double z = (r[i] - z2 * di[4] - z1 * Y) * U;
    di[1] = a;
    di[0] = b;
    r[i] = z;
    a2 = a1;
    a1 = a;
    b2 = b1;
    b1 = b;
    z2 = z1;
    z1 = z;
  }

  // x[20] = Z[20] (already in r[20]); x[19] = Z[19] - A[19] x[20]
  double xp2 = z1;
  double xp1 = z2 - a2 * xp2;
  r[kRows - 2] = xp1;
#pragma unroll
  for (int i = kRows - 3; i >= 0; --i) {
    const double xi = r[i] - d[i * kBands + 1] * xp1 - d[i * kBands] * xp2;
    r[i] = xi;
    xp2 = xp1;
    xp1 = xi;
  }
}

__global__ void __launch_bounds__(kTile)
    pdma_kernel(long long ncol, const double* __restrict__ lhs,
                const double* __restrict__ rhs, double* __restrict__ x) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(smem + kStages * kStageBytes);
  const int tid = threadIdx.x;
  const long long ntiles = (ncol + kTile - 1) / kTile;
  auto count = [ncol](long long t) {
    const long long c = ncol - t * kTile;
    return c < kTile ? static_cast<int>(c) : kTile;
  };
  // Thread 0: start the bulk loads of tile t into stage s.  A tile of odd
  // count is left to the threads.
  auto issue = [&](long long t, int s) {
    const int cnt = count(t);
    if (cnt % 2) return;
    unsigned char* st = smem + s * kStageBytes;
    const uint32_t bar = smem_addr(&bars[s]);
    const uint32_t lb = cnt * kLhsCol * sizeof(double);
    const uint32_t rb = cnt * kRows * sizeof(double);
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
    double* sl = reinterpret_cast<double*>(smem + s * kStageBytes);
    double* sr =
        reinterpret_cast<double*>(smem + s * kStageBytes + kLhsTileBytes);
    const int cnt = count(t);
    const long long c0 = t * kTile;
    const bool bulk = cnt % 2 == 0;
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
                   cnt * kRows * sizeof(double));
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

// Blocks of pdma_kernel resident on the current device: SMs x blocks per
// SM at kSmemBytes of dynamic shared memory.  Sets the kernel's shared
// memory limit first (it needs more than the default 48 KB).  Cached per
// device.
int resident_blocks(int* sms_out, int* per_sm_out) {
  static int sms[kMaxDevices], per_sm[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(pdma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    int n = 0, k = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, pdma_kernel, kTile,
                                                        kSmemBytes);
    if (err != cudaSuccess) return err;
    if (k < 1) return cudaErrorInvalidConfiguration;
    sms[dev] = n;
    per_sm[dev] = k;
  }
  *sms_out = sms[dev];
  *per_sm_out = per_sm[dev];
  return cudaSuccess;
}

}  // namespace

// lhs [ncol, 21, 5], rhs [ncol, 21], x [ncol, 21]: contiguous float64 on
// the device, each 16-B aligned.  Launches on `stream` and returns the
// first CUDA error (cudaErrorMisalignedAddress for an unaligned pointer).
extern "C" int pdma_solve_f64(long long ncol, const void* lhs, const void* rhs,
                              void* x, void* stream) {
  if (ncol <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(lhs) | reinterpret_cast<uintptr_t>(rhs) |
       reinterpret_cast<uintptr_t>(x)) % 16)
    return cudaErrorMisalignedAddress;
  int sms = 0, per_sm = 0;
  const int err = resident_blocks(&sms, &per_sm);
  if (err != cudaSuccess) return err;
  const long long ntiles = (ncol + kTile - 1) / kTile;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const long long grid = ntiles < cap ? ntiles : cap;
  pdma_kernel<<<static_cast<unsigned>(grid), kTile, kSmemBytes,
                static_cast<cudaStream_t>(stream)>>>(
      ncol, static_cast<const double*>(lhs), static_cast<const double*>(rhs),
      static_cast<double*>(x));
  return static_cast<int>(cudaGetLastError());
}

// What the launch chooses on the current device: out = {columns per tile,
// stages, dynamic shared memory bytes per block, resident blocks per SM,
// SMs}.  Returns a CUDA error code.
extern "C" int pdma_solve_layout(int* out) {
  int sms = 0, per_sm = 0;
  const int err = resident_blocks(&sms, &per_sm);
  if (err != cudaSuccess) return err;
  out[0] = kTile;
  out[1] = kStages;
  out[2] = static_cast<int>(kSmemBytes);
  out[3] = per_sm;
  out[4] = sms;
  return cudaSuccess;
}
