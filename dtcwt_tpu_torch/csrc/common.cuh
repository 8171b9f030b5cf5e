// Shared pieces of the 2-D DTCWT level kernels (CUDA C++, sm_90a).
//
// Every kernel works on a [B, rows, cols] batch with the batch on
// blockIdx.z, runs the column (down the rows) stage into shared memory and
// the row stage into registers, and writes its outputs once.  Storage
// types are float, __nv_bfloat16 and double; float and bfloat16 accumulate
// in float, double in double.  The tilings of the level-1 kernels are in
// l1tile.cuh, of the qshift forward in l2tile.cuh; the qshift inverse
// (ilevel2.cu) stages its input tile plus a reflected halo and uses the
// block shape QX x QY and launch() below.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace dtcwt {

constexpr int MAX_TAPS = 32;  // qshift_32, the longest published family
constexpr int QX = 32;        // block width in output quads (= blockDim.x)
constexpr int QY = 8;         // block height in output quads (= blockDim.y)
constexpr int NT = QX * QY;   // threads per block

// dtype codes of the C interface
enum { DT_F32 = 0, DT_BF16 = 1, DT_F64 = 2 };

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ double load(const double* p) { return *p; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(double* p, double v) { *p = v; }

// Symmetric reflection with repeated end samples, folded as often as the
// distance needs (the triangle-wave map of utils.reflect with bounds -0.5 and
// n - 0.5), so filters longer than the signal work.
__device__ __forceinline__ int reflect(int i, int n) {
  const int n2 = 2 * n;
  int t = i % n2;
  if (t < 0) t += n2;
  return t < n ? t : n2 - 1 - t;
}

// In-axis index of sample j of a length-n axis, reflected symmetrically.
// One fold costs two compares; reflect()'s modulo is left to axes shorter
// than the reach.
__device__ __forceinline__ int fold(int j, int n) {
  if (j >= 0 && j < n) return j;
  const int f = j < 0 ? -1 - j : 2 * n - 1 - j;
  return f >= 0 && f < n ? f : reflect(j, n);
}

// N consecutive values of T as one aligned vector access.
template <typename T, int N> struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// Position of degree band d in PLANE_BAND_ORDER = (0, 5, 1, 4, 2, 3).
__device__ __forceinline__ int plane_pos(int d) {
  return d == 0 ? 0 : d == 1 ? 2 : d == 2 ? 4 : d == 3 ? 5 : d == 4 ? 3 : 1;
}

// Interpolating dual-tree pair: Y[4i + s] = sum_{k < m2} t[s][k] x[2i + c[s] + 2k].
template <typename A> struct IPair {
  int m2;
  int c[4];
  A t[4][MAX_TAPS / 2];
};

// taps: [4 streams][m2]; offs: [4]
template <typename A>
inline bool make_ipair(IPair<A>* d, const double* taps, const int* offs,
                       int m2) {
  if (m2 < 1 || m2 > MAX_TAPS / 2) return false;
  d->m2 = m2;
  for (int s = 0; s < 4; ++s) {
    d->c[s] = offs[s];
    for (int k = 0; k < m2; ++k)
      d->t[s][k] = static_cast<A>(taps[s * m2 + k]);
  }
  return true;
}

// q2c of one quad (a b / c d), rows then columns: the band pair
// (p - q, p + q) with p = (a + jb)/sqrt2, q = (d - jc)/sqrt2.
template <typename A>
__device__ __forceinline__ void q2c(A a, A b, A c, A d, A& re0, A& im0,
                                    A& re1, A& im1) {
  const A s = static_cast<A>(0.70710678118654752440);
  re0 = (a - d) * s;
  im0 = (b + c) * s;
  re1 = (a + d) * s;
  im1 = (b - c) * s;
}

// c2q of the band pair (w0, w1) at quad-image pixel parity (pr, pc):
// rows (Re p, Im p) over (Im q, -Re q), p = (w0 + w1)/sqrt2, q = (w0 - w1)/sqrt2.
template <typename A>
__device__ __forceinline__ A c2q(A r0, A i0, A r1, A i1, int pr, int pc) {
  const A s = static_cast<A>(0.70710678118654752440);
  if (pr == 0) return pc == 0 ? r0 * s + r1 * s : i0 * s + i1 * s;
  return pc == 0 ? i0 * s - i1 * s : r1 * s - r0 * s;
}

// Read the six subbands (degree order) at (b, y, x) of an h x w grid:
// interleaved complex [B, h, w, 6, 2] in the accumulator type, or
// band-major planes [B, 6, h, w] in PLANE_BAND_ORDER in the storage type.
template <typename T, bool PLANES, typename A>
__device__ __forceinline__ void load_bands(const void* in_a, const void* in_b,
                                           int b, int y, int x, int h, int w,
                                           A re[6], A im[6]) {
  if constexpr (PLANES) {
    const T* pr = static_cast<const T*>(in_a);
    const T* pi = static_cast<const T*>(in_b);
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const int64_t off =
          ((static_cast<int64_t>(b) * 6 + plane_pos(d)) * h + y) * w + x;
      re[d] = load(pr + off);
      im[d] = load(pi + off);
    }
  } else {
    const A* z = static_cast<const A*>(in_a) +
                 ((static_cast<int64_t>(b) * h + y) * w + x) * 12;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      re[d] = z[2 * d];
      im[d] = z[2 * d + 1];
    }
  }
}

// Raise the dynamic shared memory limit to what this launch needs (beyond
// the 48 KB default), launch, and report the launch's error code.
template <typename Kernel, typename... Args>
inline cudaError_t launch(Kernel kernel, dim3 grid, size_t smem,
                          cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, dim3(QX, QY, 1), smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace dtcwt
