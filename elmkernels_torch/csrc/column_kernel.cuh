// What the one-thread-a-column kernels share: K5 (snow_hydrology.cu) and
// K7 (soil_temperature.cu).
//
// - PyTorch's elementwise arithmetic on the card, operation by operation,
//   so that a kernel built with --fmad=false repeats its plain version's
//   results bit for bit: NaN-propagating minimum and maximum (clamp,
//   torch.minimum, torch.maximum), tensor / Python number (divs), the
//   float64 tensor power of snow_math.cu (tpow) and torch.sum over 5
//   positions (sum5).
// - A block's staging of [ncol, L] rows through shared memory: the block's
//   threads walk a tile as one flat range (TileWalk), so that consecutive
//   threads read consecutive addresses wherever the row stride is the
//   width; loads go to shared memory by cp.async (async_copy, then
//   async_wait once a phase), stores through registers (tile_pass).
//
// Every function is HD inline: the same source built by a host compiler is
// what the CPU tests run (async_copy is then a plain copy, block_sync
// nothing, and divs and the sums are the CPU's).

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#define UNROLL _Pragma("unroll")
// snow_math.cu: float64 pow compiled with contracted multiply-adds
extern __device__ double snow_pow(double x, double p);
#else
#define HD inline
#define UNROLL
#endif

namespace {

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

// a tensor power: float64 from snow_math.cu (an out-of-line call), float32
// inline
HD double tpow(double x, double p) {
#ifdef __CUDA_ARCH__
  return snow_pow(x, p);
#else
  return pow(x, p);
#endif
}
HD float tpow(float x, float p) { return powf(x, p); }

// torch.sum(x, dim=1) over 5 positions: on the card four lanes of
// PyTorch's reduction take x0 + x4, x1, x2 and x3, and two shuffles at
// halving offsets add lane 2 to lane 0 and lane 3 to lane 1, then lane 1
// to lane 0 (measured against every association of the five)
template <typename T>
HD T sum5(const T (&x)[5]) {
#ifdef __CUDA_ARCH__
  return ((x[0] + x[4]) + x[2]) + (x[1] + x[3]);
#else
  return (((x[0] + x[1]) + x[2]) + x[3]) + x[4];
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

HD void block_sync() {
#ifdef __CUDA_ARCH__
  __syncthreads();
#endif
}

// ---- the block's tiles -------------------------------------------------------

// A block's threads walk a tile, positions [p0, p0 + w) of rows [0, rows),
// as one flat range whose element k is row k / w, position p0 + k % w;
// thread tid of nt takes k = tid, tid + nt, ...
struct TileWalk {
  int total, dr, dq, w, r, q;
  HD TileWalk(int tid, int nt, int rows, int w_)
      : total(rows * w_), dr(nt / w_), dq(nt % w_), w(w_), r(tid / w_),
        q(tid % w_) {}
  HD void next() {
    r += dr;
    q += dq;
    if (q >= w) {
      q -= w;
      ++r;
    }
  }
};

// f(r, p) for this thread's elements of the tile
template <typename F>
HD void for_tile(int tid, int nt, int rows, int p0, int w, F&& f) {
  TileWalk t(tid, nt, rows, w);
  for (int k = tid; k < t.total; k += nt) {
    f(t.r, p0 + t.q);
    t.next();
  }
}

// A copy through registers: dst(r, p, src(r, p)) for this thread's
// elements, kBatch loads in flight before their stores
constexpr int kBatch = 8;

template <typename T, typename Src, typename Dst>
HD void tile_pass(int tid, int nt, int rows, int p0, int w, Src&& src,
                  Dst&& dst) {
  TileWalk t(tid, nt, rows, w);
  for (int k0 = tid; k0 < t.total; k0 += kBatch * nt) {
    T v[kBatch];
    const TileWalk at = t;
    UNROLL for (int u = 0; u < kBatch; ++u) {
      if (k0 + u * nt < t.total) v[u] = src(t.r, p0 + t.q);
      t.next();
    }
    TileWalk back = at;
    UNROLL for (int u = 0; u < kBatch; ++u) {
      if (k0 + u * nt < t.total) dst(back.r, p0 + back.q, v[u]);
      back.next();
    }
  }
}

// *dst = *src from device to shared memory without passing through a
// register (cp.async): a thread issues all of a phase's copies, then waits
// once (async_wait) before the block's barrier
template <typename T>
HD void async_copy(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)));
#else
  *dst = *src;
#endif
}

HD void async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

}  // namespace
