// The two-sided (H, W) stage-pair kernels of the 3-D DTCWT, one depth slice
// per image (CUDA C++, sm_90a):
//
//   filter_hw22      out[j][k] = F_H(h_j) F_W(h_k) x with the two
//                    non-decimating level-1 filters: [N, H, W] -> four
//                    [N, H, W]
//   dfilt_hw22       the same with the two decimating qshift pairs: four
//                    [N, H/2, W/2]
//   filter_sum_hw22  y = sum_{j,k} F_H(g_j) F_W(g_k) v[j][k]: four [N, H, W]
//                    -> [N, H, W]
//   ifilt_sum_hw22   the same with the two interpolating qshift pairs:
//                    four [N, H, W] -> [N, 2H, 2W]
//
// Replace the Pallas kernels of dtcwt_tpu/ops/pallas_hw.py (_build_hw22,
// entries filter_hw22 and dfilt_hw22; _build_sum_hw22, entries
// filter_sum_hw22 and ifilt_sum_hw22).  They run each (H, W) stage pair of
// the depth-sharded 3-D transform (dtcwt_tpu_torch/parallel) on a shard,
// and the (H, W) merge of its replicated inverse levels >= 2.
//
// The TPU kernel multiplies each slice by dense operator matrices from
// both sides (about 7% non-zero at 256).  Here the same map is a direct
// FIR on the stream plans of hwstage.cuh, the (H, W) stage pair of the
// level kernels in pack3d.cu without the (un)pack: filter (P, D, S) =
// (1, 1, 1), dfilt (2, 4, 2), ifilt (4, 2, 2).  x is read at symmetric
// reflection (reflect() of common.cuh), so any H and W work, those shorter
// than the filter included.  Storage types float, bfloat16 and double;
// float and bfloat16 accumulate in float, double in double, and each output
// is rounded to storage once.
//
// Bound on the H100: device memory bytes.  Analysis reads a slice once and
// writes four (~20 bytes a float32 input sample) for ~3 m multiply-adds a
// sample (m taps), under the card's ~20 float32 operations per byte.  The
// design: one block per (slice, OH x OW output tile) stages its input tile
// with the reflected halo in shared memory, runs the W stage of both
// branches into shared memory and the H stage in registers, and writes
// every output once.  Synthesis stages the four inputs one after another
// and keeps the two W-stage sums (one per H branch) in shared memory.
#include "hwstage.cuh"

namespace dtcwt {

// Stage the XR x XC input tile starting at (rstart, cstart) of one H x W
// slice, reflected at its edges.
template <typename T, typename A>
__device__ __forceinline__ void stage_tile(const T* src, int H, int W,
                                           int rstart, int cstart, int XR,
                                           int XC, A* xs) {
  for (int idx = threadIdx.x; idx < XR * XC; idx += PACK_THREADS) {
    const int r = idx / XC, col = idx - r * XC;
    xs[idx] = load(src + static_cast<int64_t>(reflect(rstart + r, H)) * W +
                   reflect(cstart + col, W));
  }
}

// analysis: x [N, H, W] -> o_jk [N, Ho, Wo]
template <typename T, int P, int D, int S>
__global__ void __launch_bounds__(PACK_THREADS)
    hw22_kernel(const T* __restrict__ x, T* __restrict__ o00,
                T* __restrict__ o01, T* __restrict__ o10, T* __restrict__ o11,
                int H, int W, int Ho, int Wo, int OH, int OW, int XR, int XC,
                int cmin, int n_th, int n_tw,
                PackPlan<typename AccOf<T>::type, P> plan) {
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ PackPlan<A, P> sp;
  A* xs = reinterpret_cast<A*>(smem_raw);  // [XR][XC] the input tile
  A* wi = xs + XR * XC;                    // [2 k][XR][OW] the W stage

  int64_t blk = blockIdx.x;
  const int tw = static_cast<int>(blk % n_tw);
  blk /= n_tw;
  const int th = static_cast<int>(blk % n_th);
  const int64_t n = blk / n_th;
  const int o0r = th * OH, o0c = tw * OW;

  stage_plan(plan, &sp);
  stage_tile(x + n * H * static_cast<int64_t>(W), H, W,
             D * (o0r / P) + cmin, D * (o0c / P) + cmin, XR, XC, xs);
  __syncthreads();
  for (int idx = threadIdx.x; idx < 2 * XR * OW; idx += PACK_THREADS) {
    const int k = idx / (XR * OW), rem = idx - k * XR * OW;
    const int r = rem / OW, ow = rem - r * OW;
    wi[idx] = fir<A, P, D, S>(sp, k, ow, xs + r * XC, 1);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < OH * OW; idx += PACK_THREADS) {
    const int orow = idx / OW, ocol = idx - orow * OW;
    const int gor = o0r + orow, goc = o0c + ocol;
    if (gor >= Ho || goc >= Wo) continue;
    const int64_t off = (n * Ho + gor) * static_cast<int64_t>(Wo) + goc;
    const A* w0 = wi + ocol;
    const A* w1 = wi + XR * OW + ocol;
    store(o00 + off, fir<A, P, D, S>(sp, 0, orow, w0, OW));
    store(o01 + off, fir<A, P, D, S>(sp, 0, orow, w1, OW));
    store(o10 + off, fir<A, P, D, S>(sp, 1, orow, w0, OW));
    store(o11 + off, fir<A, P, D, S>(sp, 1, orow, w1, OW));
  }
}

// synthesis: v_jk [N, H, W] -> y [N, Ho, Wo]
template <typename T, int P, int D, int S>
__global__ void __launch_bounds__(PACK_THREADS)
    sum_hw22_kernel(const T* __restrict__ v00, const T* __restrict__ v01,
                    const T* __restrict__ v10, const T* __restrict__ v11,
                    T* __restrict__ y, int H, int W, int Ho, int Wo, int OH,
                    int OW, int XR, int XC, int cmin, int n_th, int n_tw,
                    PackPlan<typename AccOf<T>::type, P> plan) {
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ PackPlan<A, P> sp;
  A* xs = reinterpret_cast<A*>(smem_raw);  // [XR][XC] one input tile
  A* vw = xs + XR * XC;  // [2 j][XR][OW] sum_k F_W(g_k) v[j][k]

  int64_t blk = blockIdx.x;
  const int tw = static_cast<int>(blk % n_tw);
  blk /= n_tw;
  const int th = static_cast<int>(blk % n_th);
  const int64_t n = blk / n_th;
  const int o0r = th * OH, o0c = tw * OW;
  const int64_t slice = n * H * static_cast<int64_t>(W);
  const int VN = XR * OW;

  stage_plan(plan, &sp);
#pragma unroll 1
  for (int jk = 0; jk < 4; ++jk) {
    const int j = jk >> 1, k = jk & 1;
    const T* src = jk == 0 ? v00 : jk == 1 ? v01 : jk == 2 ? v10 : v11;
    __syncthreads();  // the plan is staged / the last W stage read xs
    stage_tile(src + slice, H, W, D * (o0r / P) + cmin,
               D * (o0c / P) + cmin, XR, XC, xs);
    __syncthreads();
    for (int idx = threadIdx.x; idx < VN; idx += PACK_THREADS) {
      const int r = idx / OW, ow = idx - r * OW;
      const A t = fir<A, P, D, S>(sp, k, ow, xs + r * XC, 1);
      A* dst = vw + j * VN + idx;
      *dst = k ? *dst + t : t;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < OH * OW; idx += PACK_THREADS) {
    const int orow = idx / OW, ocol = idx - orow * OW;
    const int gor = o0r + orow, goc = o0c + ocol;
    if (gor >= Ho || goc >= Wo) continue;
    store(y + (n * Ho + gor) * static_cast<int64_t>(Wo) + goc,
          fir<A, P, D, S>(sp, 0, orow, vw + ocol, OW) +
              fir<A, P, D, S>(sp, 1, orow, vw + VN + ocol, OW));
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, int P, int D, int S, bool FWD>
cudaError_t run_hw22(const void* const* in, void* const* out, int N, int H,
                     int W, int Ho, int Wo, const double* taps,
                     const int* lens, const int* offs, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  PackPlan<A, P> plan;
  int cmin, span, OH, OW, XR, XC;
  size_t smem;
  if (!make_pack_plan<A, P, S>(&plan, taps, lens, offs, &cmin, &span))
    return cudaErrorInvalidValue;
  if (!pick_tile<A, P, D>(span, 1, 2, P > 2 ? P : 2, &OH, &OW, &XR, &XC,
                          &smem))
    return cudaErrorInvalidValue;
  const int n_th = (Ho + OH - 1) / OH, n_tw = (Wo + OW - 1) / OW;
  const int64_t blocks = static_cast<int64_t>(N) * n_th * n_tw;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t e;
  if constexpr (FWD) {
    auto kernel = hw22_kernel<T, P, D, S>;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kernel<<<static_cast<unsigned>(blocks), PACK_THREADS, smem, stream>>>(
        static_cast<const T*>(in[0]), static_cast<T*>(out[0]),
        static_cast<T*>(out[1]), static_cast<T*>(out[2]),
        static_cast<T*>(out[3]), H, W, Ho, Wo, OH, OW, XR, XC, cmin, n_th,
        n_tw, plan);
  } else {
    auto kernel = sum_hw22_kernel<T, P, D, S>;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kernel<<<static_cast<unsigned>(blocks), PACK_THREADS, smem, stream>>>(
        static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
        static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
        static_cast<T*>(out[0]), H, W, Ho, Wo, OH, OW, XR, XC, cmin, n_th,
        n_tw, plan);
  }
  return cudaGetLastError();
}

template <int P, int D, int S, bool FWD>
int dispatch_hw22(const void* const* in, void* const* out, int N, int H,
                  int W, int Ho, int Wo, const double* taps, const int* lens,
                  const int* offs, int dtype, void* stream) {
  if (N < 1 || H < 1 || W < 1 || Ho < 1 || Wo < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return run_hw22<float, P, D, S, FWD>(in, out, N, H, W, Ho, Wo, taps,
                                           lens, offs, st);
    case DT_BF16:
      return run_hw22<__nv_bfloat16, P, D, S, FWD>(in, out, N, H, W, Ho, Wo,
                                                   taps, lens, offs, st);
    case DT_F64:
      return run_hw22<double, P, D, S, FWD>(in, out, N, H, W, Ho, Wo, taps,
                                            lens, offs, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace dtcwt

// Common C interface of the four kernels, all tensors of the storage type:
//   analysis:  in0 = x [N, H, W]; out0..out3 = o00, o01, o10, o11
//              [N, Ho, Wo]; in1..in3 unused.
//   synthesis: in0..in3 = v00, v01, v10, v11 [N, H, W]; out0 = y
//              [N, Ho, Wo]; out1..out3 unused.
// taps: host float64 [2 branches][P streams][MAX_TAPS]; lens, offs: host
// [2][P].  Returns the launch's CUDA error code.
#define DTCWT_HW_EXPORT(name, P, D, S, FWD)                                  \
  extern "C" int name(const void* in0, const void* in1, const void* in2,    \
                      const void* in3, void* out0, void* out1, void* out2,  \
                      void* out3, int N, int H, int W, int Ho, int Wo,      \
                      const double* taps, const int* lens, const int* offs, \
                      int dtype, void* stream) {                            \
    const void* in[4] = {in0, in1, in2, in3};                               \
    void* out[4] = {out0, out1, out2, out3};                                \
    return dtcwt::dispatch_hw22<P, D, S, FWD>(in, out, N, H, W, Ho, Wo,     \
                                              taps, lens, offs, dtype,      \
                                              stream);                      \
  }

DTCWT_HW_EXPORT(dtcwt_filter_hw22, 1, 1, 1, true)
DTCWT_HW_EXPORT(dtcwt_dfilt_hw22, 2, 4, 2, true)
DTCWT_HW_EXPORT(dtcwt_filter_sum_hw22, 1, 1, 1, false)
DTCWT_HW_EXPORT(dtcwt_ifilt_sum_hw22, 4, 2, 2, false)
