// One interpolating (qshift, level >= 2) inverse level of the 2-D DTCWT in
// one kernel.
//
// Replaces the Pallas kernel dtcwt_tpu/ops/pallas_ilevel2.py:inv_level2
// (built by _build_ilevel2).  With the dual-tree interpolator
// ifilt(x, ha, hb): Y[4i + s] = sum_k t[s][k] x[2i + c[s] + 2k] (four
// streams fixed on the host from m/2 parity and the sign of sum(ha*hb)):
//
//   lh, hl, hh = c2q(bands 0, 5), c2q(bands 2, 3), c2q(bands 1, 4)  [H, W]
//   y1 = colifilt(z, g0b, g0a) + colifilt(lh, g1b, g1a)            [2H, W]
//   y2 = colifilt(hl, g0b, g0a) + colifilt(hh, g1b, g1a)
//   out = rowifilt(y1, g0b, g0a) + rowifilt(y2, g1b, g1a)          [2H, 2W]
//
// Bound on the H100: device memory bytes (it reads the lowpass and six
// complex subbands, 4 values per output sample's quarter, and writes the
// output once, ~m multiply-adds per output).  The design builds the three
// quad images with c2q while staging the input tile plus a reflected halo of
// len(g)/2 in shared memory (the quad images never reach device memory),
// runs the column stage into shared memory and the row stage into
// registers; one thread writes one 4 x 4 output block, four contiguous
// samples per row.
#include "common.cuh"

namespace dtcwt {

template <typename T, bool PLANES>
__global__ void __launch_bounds__(NT)
    inv_level2_kernel(const T* __restrict__ z, const void* band_a,
                      const void* band_b, T* __restrict__ out, int H, int W,
                      IPair<typename AccOf<T>::type> p0,
                      IPair<typename AccOf<T>::type> p1) {
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int TH = 2 * QY, TW = 2 * QX;  // input pixels per block
  const int m2 = p0.m2;
  const int XH = TH + 2 * m2, XW = TW + 2 * m2;
  const int XN = XH * XW;
  A* zs = reinterpret_cast<A*>(smem_raw);  // [4][XH][XW]: z, lh, hl, hh
  A* y1 = zs + 4 * XN;                     // [4 QY][XW] column stage
  A* y2 = y1 + 4 * QY * XW;

  const int tid = threadIdx.y * QX + threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int h = H / 2, w = W / 2;
  const T* zb = z + static_cast<int64_t>(b) * H * W;

  for (int idx = tid; idx < XN; idx += NT) {
    const int lr = idx / XW, lc = idx - lr * XW;
    const int gr = reflect(r0 - m2 + lr, H), gc = reflect(c0 - m2 + lc, W);
    zs[idx] = load(zb + static_cast<int64_t>(gr) * W + gc);
    A re[6], im[6];
    load_bands<T, PLANES>(band_a, band_b, b, gr >> 1, gc >> 1, h, w, re, im);
    const int pr = gr & 1, pc = gc & 1;
    zs[XN + idx] = c2q(re[0], im[0], re[5], im[5], pr, pc);
    zs[2 * XN + idx] = c2q(re[2], im[2], re[3], im[3], pr, pc);
    zs[3 * XN + idx] = c2q(re[1], im[1], re[4], im[4], pr, pc);
  }
  __syncthreads();

  // output rows 4 li + s of the tile; input row 2 li + c[s] + 2k + m2
  for (int idx = tid; idx < 4 * QY * XW; idx += NT) {
    const int lr = idx / XW, lc = idx - lr * XW;
    const int li = lr >> 2, s = lr & 3;
    const int o0 = (2 * li + p0.c[s] + m2) * XW + lc;
    const int o1 = (2 * li + p1.c[s] + m2) * XW + lc;
    A a1 = 0, a2 = 0;
    for (int k = 0; k < m2; ++k) {
      const int d0 = o0 + 2 * k * XW, d1 = o1 + 2 * k * XW;
      a1 += p0.t[s][k] * zs[d0] + p1.t[s][k] * zs[XN + d1];
      a2 += p0.t[s][k] * zs[2 * XN + d0] + p1.t[s][k] * zs[3 * XN + d1];
    }
    y1[idx] = a1;
    y2[idx] = a2;
  }
  __syncthreads();

  const int i = blockIdx.y * QY + threadIdx.y;
  const int j = blockIdx.x * QX + threadIdx.x;
  if (i >= h || j >= w) return;
  T* ob = out + static_cast<int64_t>(b) * (2 * H) * (2 * W);
#pragma unroll
  for (int sr = 0; sr < 4; ++sr) {
    const int row = (4 * threadIdx.y + sr) * XW + 2 * threadIdx.x + m2;
    T* orow = ob + static_cast<int64_t>(4 * i + sr) * (2 * W) + 4 * j;
#pragma unroll
    for (int sc = 0; sc < 4; ++sc) {
      const A* q1 = y1 + row + p0.c[sc];
      const A* q2 = y2 + row + p1.c[sc];
      A v1 = 0, v2 = 0;
      for (int k = 0; k < m2; ++k) {
        v1 += p0.t[sc][k] * q1[2 * k];
        v2 += p1.t[sc][k] * q2[2 * k];
      }
      store(orow + sc, v1 + v2);
    }
  }
}

template <typename T, bool PLANES>
cudaError_t run_ilevel2(const void* z, const void* band_a, const void* band_b,
                        void* out, int B, int H, int W, const double* taps,
                        const int* offs, int m2, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  IPair<A> p0, p1;
  if (!make_ipair(&p0, taps, offs, m2) ||
      !make_ipair(&p1, taps + 4 * m2, offs + 4, m2))
    return cudaErrorInvalidValue;
  const int XH = 2 * QY + 2 * m2, XW = 2 * QX + 2 * m2;
  const size_t smem =
      sizeof(A) * (4 * static_cast<size_t>(XH) + 8 * QY) * XW;
  const dim3 grid((W / 2 + QX - 1) / QX, (H / 2 + QY - 1) / QY, B);
  return launch(inv_level2_kernel<T, PLANES>, grid, smem, stream,
                static_cast<const T*>(z), band_a, band_b, static_cast<T*>(out),
                H, W, p0, p1);
}

}  // namespace dtcwt

// z: [B, H, W]; planes = 0: band_a is the interleaved complex
// [B, H/2, W/2, 6] as real pairs; planes = 1: band_a / band_b are the re /
// im planes [B, 6, H/2, W/2].  out: [B, 2H, 2W].  taps: [pair (g0b/g0a,
// g1b/g1a)][stream][m2]; offs: [pair][stream].
extern "C" int dtcwt_ilevel2(const void* z, const void* band_a,
                             const void* band_b, void* out, int B, int H,
                             int W, const double* taps, const int* offs,
                             int m2, int dtype, int planes, void* stream) {
  using namespace dtcwt;
  if (H % 2 || W % 2 || H < 2 || W < 2 || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return planes ? run_ilevel2<float, true>(z, band_a, band_b, out, B, H,
                                               W, taps, offs, m2, s)
                    : run_ilevel2<float, false>(z, band_a, band_b, out, B, H,
                                                W, taps, offs, m2, s);
    case DT_BF16:
      if (!planes) return cudaErrorInvalidValue;
      return run_ilevel2<__nv_bfloat16, true>(z, band_a, band_b, out, B, H, W,
                                              taps, offs, m2, s);
    case DT_F64:
      return planes ? run_ilevel2<double, true>(z, band_a, band_b, out, B, H,
                                                W, taps, offs, m2, s)
                    : run_ilevel2<double, false>(z, band_a, band_b, out, B,
                                                 H, W, taps, offs, m2, s);
  }
  return cudaErrorInvalidValue;
}
