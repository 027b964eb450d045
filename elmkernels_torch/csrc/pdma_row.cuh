// The pentadiagonal solve's row recurrence (Askar & Karawia 2015), as
// elmkernels_torch/physics/soil_temperature.py:pdma_solve_plain computes
// it, operation by operation: shared by K4 (pdma_solve.cu), which reads the
// system from memory, and K7 (soil_temperature.cu), which assembles each
// row as it sweeps, so that the two cannot drift apart.
//
// Row i of the system holds bands d0 (2nd super-diagonal), d1 (super),
// d2 (diagonal), d3 (sub) and d4 (2nd sub) and right-hand side r.  The
// forward elimination turns row i into (A[i], B[i], Z[i]) from rows i - 1
// and i - 2; the back substitution gives x[i] from x[i + 1] and x[i + 2].
// An identity row (d2 = 1, the rest and r 0) gives A = B = Z = 0, so the
// recurrence runs from row 0 through a column's identity rows.  Built with
// --fmad=false, so that no multiply-add is contracted.

#pragma once

#ifdef __CUDACC__
#define PDMA_HD __host__ __device__ __forceinline__
#else
#define PDMA_HD inline
#endif

template <typename T>
struct PdmaAbz {
  T a, b, z;  // A[i], B[i], Z[i]
};

// row 0
template <typename T>
PDMA_HD PdmaAbz<T> pdma_row0(T d0, T d1, T d2, T r) {
  const T U = T(1) / d2;
  return {d1 * U, d0 * U, r * U};
}

// row 1, from row 0
template <typename T>
PDMA_HD PdmaAbz<T> pdma_row1(T d0, T d1, T d2, T d3, T r,
                             const PdmaAbz<T>& p1) {
  const T Y = d3;
  const T U = T(1) / (d2 - p1.a * Y);
  return {(d1 - p1.b * Y) * U, d0 * U, (r - p1.z * Y) * U};
}

// row i >= 2, from rows i - 2 (p2) and i - 1 (p1)
template <typename T>
PDMA_HD PdmaAbz<T> pdma_row(T d0, T d1, T d2, T d3, T d4, T r,
                            const PdmaAbz<T>& p2, const PdmaAbz<T>& p1) {
  const T Y = d3 - p2.a * d4;
  const T U = T(1) / (d2 - p2.b * d4 - p1.a * Y);
  return {(d1 - p1.b * Y) * U, d0 * U, (r - p2.z * d4 - p1.z * Y) * U};
}

// x[N - 2] from x[N - 1] (x[N - 1] is Z[N - 1])
template <typename T>
PDMA_HD T pdma_back1(const PdmaAbz<T>& p, T x1) {
  return p.z - p.a * x1;
}

// x[i] from x[i + 1] and x[i + 2]
template <typename T>
PDMA_HD T pdma_back(const PdmaAbz<T>& p, T x1, T x2) {
  return p.z - p.a * x1 - p.b * x2;
}
