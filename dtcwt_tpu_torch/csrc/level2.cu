// One decimating (qshift, level >= 2) forward level of the 2-D DTCWT in one
// kernel.
//
// Replaces the Pallas kernel dtcwt_tpu/ops/pallas_level2.py:fwd_level2
// (built by _build_level2).  With the dual-tree decimator
// dfilt(x, ha, hb): Y[2i + s] = sum_k t[s][k] x[4i + c[s] + 2k] (streams and
// their order fixed on the host from the sign of sum(ha*hb)):
//
//   lo = coldfilt(x, h0b, h0a)   hi = coldfilt(x, h1b, h1a)   -> [R/2, C]
//   lolo = rowdfilt(lo, h0b, h0a)                             -> [R/2, C/2]
//   q2c(rowdfilt(hi, h0b, h0a)) -> bands 0, 5
//   q2c(rowdfilt(lo, h1b, h1a)) -> bands 2, 3                 -> [R/4, C/4, 6]
//   q2c(rowdfilt(hi, h1b, h1a)) -> bands 1, 4
//
// The bandpass families (qshift_b_bp) add a third pair h2a/h2b of the same
// even length, the third stream (template flag BP): bands 1, 4 become
// q2c(rowdfilt(coldfilt(x, h2b, h2a), h2b, h2a)), from a third decimated
// column stage; the host orders its streams as it does the main pairs'.
//
// Bound on the H100: device memory bytes (one read of the input, half of it
// written back as lowpass and subbands, ~m multiply-adds per output, a
// quarter more with the third stream).  The design reads a 32 x 128 input
// tile plus a reflected halo of len(h) (one length for every pair) once
// into shared memory, keeps the decimated column stages there, and computes
// the row stage and the quad pack in registers; one thread owns one
// output quad, whose corners are exactly the (row stream, column stream)
// pairs of the decimator, so no strided access reaches device memory.
#include "common.cuh"

namespace dtcwt {

template <typename T, bool PLANES, bool BP>
__global__ void __launch_bounds__(NT)
    fwd_level2_kernel(const T* __restrict__ x, T* __restrict__ lolo,
                      void* out_a, void* out_b, int R, int C,
                      DPair<typename AccOf<T>::type> p0,
                      DPair<typename AccOf<T>::type> p1,
                      DPair<typename AccOf<T>::type> p2) {
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TH = 4 * QY, TW = 4 * QX;  // input pixels per block
  const int m = p0.m;
  const int XH = TH + 2 * m, XW = TW + 2 * m;
  A* xs = reinterpret_cast<A*>(smem_raw);  // [XH][XW] input + halo
  A* lo = xs + XH * XW;                    // [2 QY][XW] column stage, h0
  A* hi = lo + 2 * QY * XW;                // [2 QY][XW] column stage, h1
  A* bq = hi + 2 * QY * XW;                // [2 QY][XW] column stage, h2 (BP)

  const int tid = threadIdx.y * QX + threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const T* xb = x + static_cast<int64_t>(b) * R * C;

  for (int idx = tid; idx < XH * XW; idx += NT) {
    const int lr = idx / XW, lc = idx - lr * XW;
    const int gr = reflect(r0 - m + lr, R), gc = reflect(c0 - m + lc, C);
    xs[idx] = load(xb + static_cast<int64_t>(gr) * C + gc);
  }
  __syncthreads();

  // decimated rows 2 li + s of the tile; input row 4 li + c[s] + 2k + m
  for (int idx = tid; idx < 2 * QY * XW; idx += NT) {
    const int lr = idx / XW, lc = idx - lr * XW;
    const int li = lr >> 1, s = lr & 1;
    const A* s0 = xs + (4 * li + p0.c[s] + m) * XW + lc;
    const A* s1 = xs + (4 * li + p1.c[s] + m) * XW + lc;
    A a0 = 0, a1 = 0;
    for (int k = 0; k < m; ++k) {
      a0 += p0.t[s][k] * s0[2 * k * XW];
      a1 += p1.t[s][k] * s1[2 * k * XW];
    }
    lo[idx] = a0;
    hi[idx] = a1;
    if constexpr (BP) {
      const A* s2 = xs + (4 * li + p2.c[s] + m) * XW + lc;
      A a2 = 0;
      for (int k = 0; k < m; ++k) a2 += p2.t[s][k] * s2[2 * k * XW];
      bq[idx] = a2;
    }
  }
  __syncthreads();

  const int i = blockIdx.y * QY + threadIdx.y;  // output quad
  const int j = blockIdx.x * QX + threadIdx.x;
  const int h = R / 4, w = C / 4;
  if (i >= h || j >= w) return;

  A ll[2][2], y05[2][2], y23[2][2], y14[2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int row = (2 * threadIdx.y + s) * XW + 4 * threadIdx.x + m;
      const A* l0 = lo + row + p0.c[t];
      const A* g0 = hi + row + p0.c[t];
      const A* l1 = lo + row + p1.c[t];
      const A* g1 = hi + row + p1.c[t];
      const A* b2 = bq + row + p2.c[t];
      A a = 0, bb = 0, c = 0, d = 0;
      for (int k = 0; k < m; ++k) {
        a += p0.t[t][k] * l0[2 * k];
        bb += p0.t[t][k] * g0[2 * k];
        c += p1.t[t][k] * l1[2 * k];
        if constexpr (BP)
          d += p2.t[t][k] * b2[2 * k];
        else
          d += p1.t[t][k] * g1[2 * k];
      }
      ll[s][t] = a;
      y05[s][t] = bb;
      y23[s][t] = c;
      y14[s][t] = d;
    }
  }

  const int Cl = C / 2;
  T* lb = lolo + static_cast<int64_t>(b) * (R / 2) * Cl +
          static_cast<int64_t>(2 * i) * Cl + 2 * j;
  store(lb, ll[0][0]);
  store(lb + 1, ll[0][1]);
  store(lb + Cl, ll[1][0]);
  store(lb + Cl + 1, ll[1][1]);

  A re[6], im[6];
  q2c(y05[0][0], y05[0][1], y05[1][0], y05[1][1], re[0], im[0], re[5],
      im[5]);
  q2c(y23[0][0], y23[0][1], y23[1][0], y23[1][1], re[2], im[2], re[3],
      im[3]);
  q2c(y14[0][0], y14[0][1], y14[1][0], y14[1][1], re[1], im[1], re[4],
      im[4]);
  store_bands<T, PLANES>(out_a, out_b, b, i, j, h, w, re, im);
}

template <typename T, bool PLANES, bool BP>
cudaError_t run_level2(const void* x, void* lolo, void* out_a, void* out_b,
                       int B, int R, int C, const double* taps,
                       const int* offs, const double* taps2,
                       const int* offs2, int m, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  DPair<A> p0, p1, p2{};
  if (!make_dpair(&p0, taps, offs, m) ||
      !make_dpair(&p1, taps + 2 * m, offs + 2, m) ||
      (BP && !make_dpair(&p2, taps2, offs2, m)))
    return cudaErrorInvalidValue;
  const int XH = 4 * QY + 2 * m, XW = 4 * QX + 2 * m;
  const size_t smem =
      sizeof(A) * static_cast<size_t>(XH + (BP ? 6 : 4) * QY) * XW;
  const dim3 grid((C / 4 + QX - 1) / QX, (R / 4 + QY - 1) / QY, B);
  return launch(fwd_level2_kernel<T, PLANES, BP>, grid, smem, stream,
                static_cast<const T*>(x), static_cast<T*>(lolo), out_a,
                out_b, R, C, p0, p1, p2);
}

template <bool BP>
cudaError_t level2_dtype(const void* x, void* lolo, void* out_a, void* out_b,
                         int B, int R, int C, const double* taps,
                         const int* offs, const double* taps2,
                         const int* offs2, int m, int dtype, int planes,
                         cudaStream_t s) {
  switch (dtype) {
    case DT_F32:
      return planes ? run_level2<float, true, BP>(x, lolo, out_a, out_b, B,
                                                  R, C, taps, offs, taps2,
                                                  offs2, m, s)
                    : run_level2<float, false, BP>(x, lolo, out_a, out_b, B,
                                                   R, C, taps, offs, taps2,
                                                   offs2, m, s);
    case DT_BF16:
      if (!planes) return cudaErrorInvalidValue;
      return run_level2<__nv_bfloat16, true, BP>(x, lolo, out_a, out_b, B, R,
                                                 C, taps, offs, taps2, offs2,
                                                 m, s);
    case DT_F64:
      return planes ? run_level2<double, true, BP>(x, lolo, out_a, out_b, B,
                                                   R, C, taps, offs, taps2,
                                                   offs2, m, s)
                    : run_level2<double, false, BP>(x, lolo, out_a, out_b, B,
                                                    R, C, taps, offs, taps2,
                                                    offs2, m, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace dtcwt

// taps: [pair (h0b/h0a, h1b/h1a)][stream][m]; offs: [pair][stream].
// taps2 / offs2: the bandpass families' third pair (h2b/h2a) as
// [stream][m] / [stream]; null for no third stream.  planes = 0: out_a is
// the interleaved complex [B, R/4, C/4, 6] as real pairs; planes = 1:
// out_a / out_b are the re / im planes [B, 6, R/4, C/4].
extern "C" int dtcwt_level2(const void* x, void* lolo, void* out_a,
                            void* out_b, int B, int R, int C,
                            const double* taps, const int* offs,
                            const double* taps2, const int* offs2, int m,
                            int dtype, int planes, void* stream) {
  using namespace dtcwt;
  if (R % 4 || C % 4 || R < 4 || C < 4 || B < 1 || B > 65535 ||
      (taps2 == nullptr) != (offs2 == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return taps2 ? level2_dtype<true>(x, lolo, out_a, out_b, B, R, C, taps,
                                    offs, taps2, offs2, m, dtype, planes, s)
               : level2_dtype<false>(x, lolo, out_a, out_b, B, R, C, taps,
                                     offs, taps2, offs2, m, dtype, planes, s);
}
