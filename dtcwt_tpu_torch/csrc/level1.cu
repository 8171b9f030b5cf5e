// Level-1 forward of the 2-D DTCWT in one kernel.
//
// Replaces the Pallas kernel dtcwt_tpu/ops/pallas_level1.py:fwd_level1
// (built by _build_level1).  Computes, with odd biorthogonal filters h0o, h1o
// and symmetric extension:
//
//   lo = colfilter(x, h0)   hi = colfilter(x, h1)
//   lolo = rowfilter(lo, h0)                         -> [B, R, C]
//   q2c(rowfilter(hi, h0)) -> bands 0, 5
//   q2c(rowfilter(lo, h1)) -> bands 2, 3             -> [B, R/2, C/2, 6]
//   q2c(rowfilter(hi, h1)) -> bands 1, 4                complex, or planes
//
// Bound on the H100: device memory bytes.  Per input sample it reads 1
// value and writes 4 (the lowpass plus 6 complex subbands at quarter
// resolution) for ~(m0 + m1) * 3 multiply-adds: far below the card's ratio
// of operations to bytes.  The design reads the input once per tile (a
// 16 x 64 tile plus a reflected halo of len(h)//2 in shared memory, so
// neighbouring tiles re-read only the halo, mostly from L2), keeps the column
// stage in shared memory and the row stage and the quad pack in registers:
// no intermediate image reaches device memory.  One thread owns one output
// quad, so the q2c corners are its own four row-stage sums.
#include "common.cuh"

namespace dtcwt {

template <typename T, bool PLANES>
__global__ void __launch_bounds__(NT)
    fwd_level1_kernel(const T* __restrict__ x, T* __restrict__ lolo,
                      void* out_a, void* out_b, int R, int C,
                      Fir<typename AccOf<T>::type> f0,
                      Fir<typename AccOf<T>::type> f1) {
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TH = 2 * QY, TW = 2 * QX;  // output pixels per block
  const int P = f0.p > f1.p ? f0.p : f1.p;
  const int XH = TH + 2 * P, XW = TW + 2 * P;
  A* xs = reinterpret_cast<A*>(smem_raw);  // [XH][XW] input + halo
  A* lo = xs + XH * XW;                    // [TH][XW] column stage, h0
  A* hi = lo + TH * XW;                    // [TH][XW] column stage, h1

  const int tid = threadIdx.y * QX + threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const T* xb = x + static_cast<int64_t>(b) * R * C;

  for (int idx = tid; idx < XH * XW; idx += NT) {
    const int lr = idx / XW, lc = idx - lr * XW;
    const int gr = reflect(r0 - P + lr, R), gc = reflect(c0 - P + lc, C);
    xs[idx] = load(xb + static_cast<int64_t>(gr) * C + gc);
  }
  __syncthreads();

  for (int idx = tid; idx < TH * XW; idx += NT) {
    const int lr = idx / XW, lc = idx - lr * XW;
    const A* s0 = xs + (lr + P - f0.p) * XW + lc;
    const A* s1 = xs + (lr + P - f1.p) * XW + lc;
    A a0 = 0, a1 = 0;
    for (int k = 0; k < f0.m; ++k) a0 += f0.t[k] * s0[k * XW];
    for (int k = 0; k < f1.m; ++k) a1 += f1.t[k] * s1[k * XW];
    lo[idx] = a0;
    hi[idx] = a1;
  }
  __syncthreads();

  const int i = blockIdx.y * QY + threadIdx.y;  // output quad
  const int j = blockIdx.x * QX + threadIdx.x;
  const int h = R / 2, w = C / 2;
  if (i >= h || j >= w) return;

  A ll[2][2], y05[2][2], y23[2][2], y14[2][2];
#pragma unroll
  for (int dr = 0; dr < 2; ++dr) {
#pragma unroll
    for (int dc = 0; dc < 2; ++dc) {
      const int o = (2 * threadIdx.y + dr) * XW + 2 * threadIdx.x + dc + P;
      const A* l0 = lo + o - f0.p;
      const A* g0 = hi + o - f0.p;
      const A* l1 = lo + o - f1.p;
      const A* g1 = hi + o - f1.p;
      A a = 0, bb = 0, c = 0, d = 0;
      for (int k = 0; k < f0.m; ++k) {
        a += f0.t[k] * l0[k];
        bb += f0.t[k] * g0[k];
      }
      for (int k = 0; k < f1.m; ++k) {
        c += f1.t[k] * l1[k];
        d += f1.t[k] * g1[k];
      }
      ll[dr][dc] = a;
      y05[dr][dc] = bb;
      y23[dr][dc] = c;
      y14[dr][dc] = d;
    }
  }

  T* lb = lolo + static_cast<int64_t>(b) * R * C +
          static_cast<int64_t>(2 * i) * C + 2 * j;
  store(lb, ll[0][0]);
  store(lb + 1, ll[0][1]);
  store(lb + C, ll[1][0]);
  store(lb + C + 1, ll[1][1]);

  A re[6], im[6];
  q2c(y05[0][0], y05[0][1], y05[1][0], y05[1][1], re[0], im[0], re[5],
      im[5]);
  q2c(y23[0][0], y23[0][1], y23[1][0], y23[1][1], re[2], im[2], re[3],
      im[3]);
  q2c(y14[0][0], y14[0][1], y14[1][0], y14[1][1], re[1], im[1], re[4],
      im[4]);
  store_bands<T, PLANES>(out_a, out_b, b, i, j, h, w, re, im);
}

template <typename T, bool PLANES>
cudaError_t run_level1(const void* x, void* lolo, void* out_a, void* out_b,
                       int B, int R, int C, const double* t0, int m0,
                       const double* t1, int m1, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  Fir<A> f0, f1;
  if (!make_fir(&f0, t0, m0) || !make_fir(&f1, t1, m1))
    return cudaErrorInvalidValue;
  const int P = f0.p > f1.p ? f0.p : f1.p;
  const int XH = 2 * QY + 2 * P, XW = 2 * QX + 2 * P;
  const size_t smem = sizeof(A) * static_cast<size_t>(XH + 2 * (2 * QY)) * XW;
  const dim3 grid((C / 2 + QX - 1) / QX, (R / 2 + QY - 1) / QY, B);
  return launch(fwd_level1_kernel<T, PLANES>, grid, smem, stream,
                static_cast<const T*>(x), static_cast<T*>(lolo), out_a,
                out_b, R, C, f0, f1);
}

}  // namespace dtcwt

// t0, t1: reversed taps of h0o, h1o.  planes = 0: out_a is the interleaved
// complex [B, R/2, C/2, 6] as real pairs; planes = 1: out_a / out_b are the
// re / im planes [B, 6, R/2, C/2].
extern "C" int dtcwt_level1(const void* x, void* lolo, void* out_a,
                            void* out_b, int B, int R, int C, const double* t0,
                            int m0, const double* t1, int m1, int dtype,
                            int planes, void* stream) {
  using namespace dtcwt;
  if (R % 2 || C % 2 || R < 2 || C < 2 || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return planes ? run_level1<float, true>(x, lolo, out_a, out_b, B, R, C,
                                              t0, m0, t1, m1, s)
                    : run_level1<float, false>(x, lolo, out_a, out_b, B, R, C,
                                               t0, m0, t1, m1, s);
    case DT_BF16:
      if (!planes) return cudaErrorInvalidValue;
      return run_level1<__nv_bfloat16, true>(x, lolo, out_a, out_b, B, R, C,
                                             t0, m0, t1, m1, s);
    case DT_F64:
      return planes ? run_level1<double, true>(x, lolo, out_a, out_b, B, R, C,
                                               t0, m0, t1, m1, s)
                    : run_level1<double, false>(x, lolo, out_a, out_b, B, R,
                                                C, t0, m0, t1, m1, s);
  }
  return cudaErrorInvalidValue;
}
