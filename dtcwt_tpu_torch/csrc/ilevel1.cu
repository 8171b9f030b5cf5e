// Level-1 inverse of the 2-D DTCWT in one kernel.
//
// Replaces the Pallas kernel dtcwt_tpu/ops/pallas_ilevel1.py:inv_level1
// (built by _build_ilevel1).  With odd biorthogonal synthesis filters g0o,
// g1o and symmetric extension:
//
//   lh, hl, hh = c2q(bands 0, 5), c2q(bands 2, 3), c2q(bands 1, 4)  [H, W]
//   y1 = colfilter(z, g0) + colfilter(lh, g1)
//   y2 = colfilter(hl, g0) + colfilter(hh, g1)
//   out = rowfilter(y1, g0) + rowfilter(y2, g1)                    [H, W]
//
// Bound on the H100: device memory bytes (per output sample it reads the
// lowpass sample and three quarter-resolution complex values, ~4 (m0 + m1)
// multiply-adds).  The design builds the quad images with c2q while staging
// a 16 x 64 tile plus a reflected halo of len(g)//2 in shared memory (the
// quad images never reach device memory), runs the column stage into shared
// memory and the row stage into registers; one thread writes one 2 x 2
// output quad.
#include "common.cuh"

namespace dtcwt {

template <typename T, bool PLANES>
__global__ void __launch_bounds__(NT)
    inv_level1_kernel(const T* __restrict__ z, const void* band_a,
                      const void* band_b, T* __restrict__ out, int H, int W,
                      Fir<typename AccOf<T>::type> f0,
                      Fir<typename AccOf<T>::type> f1) {
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TH = 2 * QY, TW = 2 * QX;  // output pixels per block
  const int P = f0.p > f1.p ? f0.p : f1.p;
  const int XH = TH + 2 * P, XW = TW + 2 * P;
  const int XN = XH * XW;
  A* zs = reinterpret_cast<A*>(smem_raw);  // [4][XH][XW]: z, lh, hl, hh
  A* y1 = zs + 4 * XN;                     // [TH][XW] column stage
  A* y2 = y1 + TH * XW;

  const int tid = threadIdx.y * QX + threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int h = H / 2, w = W / 2;
  const T* zb = z + static_cast<int64_t>(b) * H * W;

  for (int idx = tid; idx < XN; idx += NT) {
    const int lr = idx / XW, lc = idx - lr * XW;
    const int gr = reflect(r0 - P + lr, H), gc = reflect(c0 - P + lc, W);
    zs[idx] = load(zb + static_cast<int64_t>(gr) * W + gc);
    A re[6], im[6];
    load_bands<T, PLANES>(band_a, band_b, b, gr >> 1, gc >> 1, h, w, re, im);
    const int pr = gr & 1, pc = gc & 1;
    zs[XN + idx] = c2q(re[0], im[0], re[5], im[5], pr, pc);
    zs[2 * XN + idx] = c2q(re[2], im[2], re[3], im[3], pr, pc);
    zs[3 * XN + idx] = c2q(re[1], im[1], re[4], im[4], pr, pc);
  }
  __syncthreads();

  for (int idx = tid; idx < TH * XW; idx += NT) {
    const int lr = idx / XW, lc = idx - lr * XW;
    const int o0 = (lr + P - f0.p) * XW + lc;
    const int o1 = (lr + P - f1.p) * XW + lc;
    A a1 = 0, a2 = 0, b1 = 0, b2 = 0;
    for (int k = 0; k < f0.m; ++k) {
      a1 += f0.t[k] * zs[o0 + k * XW];
      a2 += f0.t[k] * zs[2 * XN + o0 + k * XW];
    }
    for (int k = 0; k < f1.m; ++k) {
      b1 += f1.t[k] * zs[XN + o1 + k * XW];
      b2 += f1.t[k] * zs[3 * XN + o1 + k * XW];
    }
    y1[idx] = a1 + b1;
    y2[idx] = a2 + b2;
  }
  __syncthreads();

  const int i = blockIdx.y * QY + threadIdx.y;  // output quad
  const int j = blockIdx.x * QX + threadIdx.x;
  if (i >= h || j >= w) return;
  T* ob = out + static_cast<int64_t>(b) * H * W;
#pragma unroll
  for (int dr = 0; dr < 2; ++dr) {
#pragma unroll
    for (int dc = 0; dc < 2; ++dc) {
      const int o = (2 * threadIdx.y + dr) * XW + 2 * threadIdx.x + dc + P;
      const A* q1 = y1 + o - f0.p;
      const A* q2 = y2 + o - f1.p;
      A v1 = 0, v2 = 0;
      for (int k = 0; k < f0.m; ++k) v1 += f0.t[k] * q1[k];
      for (int k = 0; k < f1.m; ++k) v2 += f1.t[k] * q2[k];
      store(ob + static_cast<int64_t>(2 * i + dr) * W + 2 * j + dc, v1 + v2);
    }
  }
}

template <typename T, bool PLANES>
cudaError_t run_ilevel1(const void* z, const void* band_a, const void* band_b,
                        void* out, int B, int H, int W, const double* t0,
                        int m0, const double* t1, int m1,
                        cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  Fir<A> f0, f1;
  if (!make_fir(&f0, t0, m0) || !make_fir(&f1, t1, m1))
    return cudaErrorInvalidValue;
  const int P = f0.p > f1.p ? f0.p : f1.p;
  const int XH = 2 * QY + 2 * P, XW = 2 * QX + 2 * P;
  const size_t smem =
      sizeof(A) * (4 * static_cast<size_t>(XH) + 2 * (2 * QY)) * XW;
  const dim3 grid((W / 2 + QX - 1) / QX, (H / 2 + QY - 1) / QY, B);
  return launch(inv_level1_kernel<T, PLANES>, grid, smem, stream,
                static_cast<const T*>(z), band_a, band_b, static_cast<T*>(out),
                H, W, f0, f1);
}

}  // namespace dtcwt

// z, out: [B, H, W]; planes = 0: band_a is the interleaved complex
// [B, H/2, W/2, 6] as real pairs; planes = 1: band_a / band_b are the re /
// im planes [B, 6, H/2, W/2].  t0, t1: reversed taps of g0o, g1o.
extern "C" int dtcwt_ilevel1(const void* z, const void* band_a,
                             const void* band_b, void* out, int B, int H,
                             int W, const double* t0, int m0,
                             const double* t1, int m1, int dtype, int planes,
                             void* stream) {
  using namespace dtcwt;
  if (H % 2 || W % 2 || H < 2 || W < 2 || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return planes ? run_ilevel1<float, true>(z, band_a, band_b, out, B, H,
                                               W, t0, m0, t1, m1, s)
                    : run_ilevel1<float, false>(z, band_a, band_b, out, B, H,
                                                W, t0, m0, t1, m1, s);
    case DT_BF16:
      if (!planes) return cudaErrorInvalidValue;
      return run_ilevel1<__nv_bfloat16, true>(z, band_a, band_b, out, B, H, W,
                                              t0, m0, t1, m1, s);
    case DT_F64:
      return planes ? run_ilevel1<double, true>(z, band_a, band_b, out, B, H,
                                                W, t0, m0, t1, m1, s)
                    : run_ilevel1<double, false>(z, band_a, band_b, out, B,
                                                 H, W, t0, m0, t1, m1, s);
  }
  return cudaErrorInvalidValue;
}

// Message of a CUDA error code returned by the functions above.
extern "C" const char* dtcwt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
