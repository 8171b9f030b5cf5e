// Shared pieces of the 2-D DTCWT level kernels (CUDA C++, sm_90a).
//
// Every kernel works on a [B, rows, cols] batch with the batch on
// blockIdx.z, runs the column (down the rows) stage into shared memory and
// the row stage into registers, and writes its outputs once.  Storage
// types are float, __nv_bfloat16 and double; float and bfloat16 accumulate
// in float, double in double.  The tilings of the level-1 kernels are in
// l1tile.cuh, of the qshift levels in l2tile.cuh; the two inverse kernels
// (ilevel1.cu, ilevel2.cu) build their quad images with stage_quads below.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace dtcwt {

constexpr int MAX_TAPS = 32;  // qshift_32, the longest published family

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

// Values of T in one 16-byte vector.
template <typename T> __host__ __device__ constexpr int vec16() {
  return 16 / sizeof(T);
}
// A column vector of the 1-D filters' columns paths (filter.cu,
// streamtile.cuh): 16 bytes of float32 / float64, 8 of bfloat16.
template <typename T> __host__ __device__ constexpr int col_vec() {
  return sizeof(T) == 8 ? 2 : 4;
}

// N values of storage type T at p (aligned to the vector) stored from /
// loaded into the accumulator type, as one vector access.
template <typename T, typename A, int N>
__device__ __forceinline__ void store_pack(T* p, const A* v) {
  Vec<T, N> pk;
#pragma unroll
  for (int i = 0; i < N; ++i) store(&pk.v[i], v[i]);
  *reinterpret_cast<Vec<T, N>*>(p) = pk;
}

template <typename T, typename A, int N>
__device__ __forceinline__ void load_pack(const T* p, A* v) {
  const Vec<T, N> pk = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = load(&pk.v[i]);
}

// 16 bytes from device memory into shared memory, asynchronously; the
// caller waits with cp_async_wait_all().
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// In-axis index of sample j of a length-n_in axis, or -1 where the sample
// reads as zero (refl = 0: outside a pre-extended buffer; only padded taps
// reach there).  One fold costs two compares; the modulo of reflect() is
// left to axes shorter than the reach.
__device__ __forceinline__ int source(int j, int n_in, int refl) {
  if (j >= 0 && j < n_in) return j;
  if (!refl) return -1;
  const int f = j < 0 ? -1 - j : 2 * n_in - 1 - j;
  return f >= 0 && f < n_in ? f : reflect(j, n_in);
}

// Position of degree band d in PLANE_BAND_ORDER = (0, 5, 1, 4, 2, 3).
__device__ __forceinline__ int plane_pos(int d) {
  return d == 0 ? 0 : d == 1 ? 2 : d == 2 ? 4 : d == 3 ? 5 : d == 4 ? 3 : 1;
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

// The six subbands (degree order) of quad (b, i, j) of an h x w grid:
// interleaved as 16-byte pieces (vq) or twelve values, or planes.
template <typename T, bool PLANES, typename A>
__device__ __forceinline__ void load_quad(const void* in_a, const void* in_b,
                                          int b, int i, int j, int h, int w,
                                          int vq, A re[6], A im[6]) {
  if constexpr (!PLANES) {
    if (vq) {
      constexpr int VN = 16 / sizeof(A);
      const Vec<A, VN>* z = reinterpret_cast<const Vec<A, VN>*>(
          static_cast<const A*>(in_a) +
          ((static_cast<int64_t>(b) * h + i) * w + j) * 12);
      A v[12];
#pragma unroll
      for (int e = 0; e < 12 / VN; ++e) {
        const Vec<A, VN> pk = z[e];
#pragma unroll
        for (int u = 0; u < VN; ++u) v[e * VN + u] = pk.v[u];
      }
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        re[d] = v[2 * d];
        im[d] = v[2 * d + 1];
      }
      return;
    }
  }
  load_bands<T, PLANES>(in_a, in_b, b, i, j, h, w, re, im);
}

// The 2 x 2 pixels c2q makes of the band pair (w0, w1), written at o (row
// stride xc) as two pairs; rows swapped where fr, columns where fc (a quad
// reflected onto its source).
template <typename A>
__device__ __forceinline__ void put_quad(A* o, int xc, bool fr, bool fc,
                                         A r0, A i0, A r1, A i1) {
  const A a00 = c2q(r0, i0, r1, i1, 0, 0), a01 = c2q(r0, i0, r1, i1, 0, 1);
  const A a10 = c2q(r0, i0, r1, i1, 1, 0), a11 = c2q(r0, i0, r1, i1, 1, 1);
  const A t0 = fr ? a10 : a00, t1 = fr ? a11 : a01;  // staged row 0
  const A u0 = fr ? a00 : a10, u1 = fr ? a01 : a11;  // staged row 1
  Vec<A, 2> top, bot;
  top.v[0] = fc ? t1 : t0;
  top.v[1] = fc ? t0 : t1;
  bot.v[0] = fc ? u1 : u0;
  bot.v[1] = fc ? u0 : u1;
  *reinterpret_cast<Vec<A, 2>*>(o) = top;
  *reinterpret_cast<Vec<A, 2>*>(o + xc) = bot;
}

// The quad images lh, hl, hh of nr x nc quads from quad (i0, j0) of an
// H x W image (pixel rows 2 i0 .. 2 (i0 + nr) - 1, columns likewise) into
// qs[3][2 nr][xc], image after image qn apart, one quad an item of THREADS
// threads.  H and W are even, so symmetric reflection maps a quad onto a
// whole quad, with its parities swapped where the reflected index is odd:
// one fold of the quad's first pixel (two compares; the modulo of
// reflect() only for axes shorter than the reach) gives the source quad
// and the swap.  Each quad's six complex values are read once and give
// its 2 x 2 pixels of every image from the same registers.
template <int THREADS, typename T, bool PLANES, typename A>
__device__ __forceinline__ void stage_quads(const void* band_a,
                                            const void* band_b, A* qs, int b,
                                            int H, int W, int i0, int j0,
                                            int nr, int nc, int xc, int qn,
                                            int vq) {
  const int items = nr * nc;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const int sr = it / nc, sc = it - sr * nc;
    const int tr = fold(2 * (i0 + sr), H), tc = fold(2 * (j0 + sc), W);
    A re[6], im[6];
    load_quad<T, PLANES>(band_a, band_b, b, tr >> 1, tc >> 1, H / 2, W / 2,
                         vq, re, im);
    const bool fr = tr & 1, fc = tc & 1;
    A* o = qs + 2 * sr * xc + 2 * sc;
    put_quad(o, xc, fr, fc, re[0], im[0], re[5], im[5]);           // lh
    put_quad(o + qn, xc, fr, fc, re[2], im[2], re[3], im[3]);      // hl
    put_quad(o + 2 * qn, xc, fr, fc, re[1], im[1], re[4], im[4]);  // hh
  }
}

}  // namespace dtcwt
