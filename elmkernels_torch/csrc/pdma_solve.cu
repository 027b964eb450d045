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
// 21 (1176 B) for ~300 flops, far below the card's flop/byte balance.
// This first version reads each column's rows with one thread (strided
// across the warp); staging the rows through shared memory so that loads
// coalesce is left for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 21;
constexpr int kBands = 5;

__global__ void pdma_kernel(long long ncol, const double* __restrict__ lhs,
                            const double* __restrict__ rhs,
                            double* __restrict__ x) {
  const long long col =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= ncol) return;
  const double* d = lhs + col * (kRows * kBands);
  const double* r = rhs + col * kRows;
  double A[kRows], B[kRows], Z[kRows];

  double U = 1.0 / d[2];
  A[0] = d[1] * U;
  B[0] = d[0] * U;
  Z[0] = r[0] * U;

  double Y = d[kBands + 3];
  U = 1.0 / (d[kBands + 2] - A[0] * Y);
  A[1] = (d[kBands + 1] - B[0] * Y) * U;
  B[1] = d[kBands + 0] * U;
  Z[1] = (r[1] - Z[0] * Y) * U;

#pragma unroll
  for (int i = 2; i < kRows; ++i) {
    const double* di = d + i * kBands;
    Y = di[3] - A[i - 2] * di[4];
    U = 1.0 / (di[2] - B[i - 2] * di[4] - A[i - 1] * Y);
    A[i] = (di[1] - B[i - 1] * Y) * U;
    B[i] = di[0] * U;
    Z[i] = (r[i] - Z[i - 2] * di[4] - Z[i - 1] * Y) * U;
  }

  double* xo = x + col * kRows;
  double xp2 = Z[kRows - 1];
  double xp1 = Z[kRows - 2] - A[kRows - 2] * xp2;
  xo[kRows - 1] = xp2;
  xo[kRows - 2] = xp1;
#pragma unroll
  for (int i = kRows - 3; i >= 0; --i) {
    const double xi = Z[i] - A[i] * xp1 - B[i] * xp2;
    xo[i] = xi;
    xp2 = xp1;
    xp1 = xi;
  }
}

}  // namespace

// lhs [ncol, 21, 5], rhs [ncol, 21], x [ncol, 21]: contiguous float64 on
// the device.  Launches on `stream` and returns cudaGetLastError().
extern "C" int pdma_solve_f64(long long ncol, const void* lhs, const void* rhs,
                              void* x, void* stream) {
  if (ncol <= 0) return 0;
  const int threads = 128;
  const long long blocks = (ncol + threads - 1) / threads;
  pdma_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      ncol, static_cast<const double*>(lhs), static_cast<const double*>(rhs),
      static_cast<double*>(x));
  return static_cast<int>(cudaGetLastError());
}
