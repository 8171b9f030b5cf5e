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
// FIR on the stream plans of hwstage.cuh: filter (P, D, S) = (1, 1, 1),
// dfilt (2, 4, 2), ifilt (4, 2, 2).  x is read at symmetric reflection
// (reflect() of common.cuh), so any H and W work, those shorter than the
// filter included.  Storage types float, bfloat16 and double; float and
// bfloat16 accumulate in float, double in double, and each output is
// rounded to storage once.
//
// Bound on the H100: device memory bytes.  Analysis reads a slice once and
// writes four (~20 bytes a float32 input sample) for ~3 m multiply-adds a
// sample (m taps), under the card's ~20 float32 operations per byte.
// Analysis (hw22_kernel, the first port's design): one block per (slice,
// OH x OW output tile, pick_tile) stages its input tile with the reflected
// halo in shared memory, runs the W stage of both branches into shared
// memory (hwstage.cuh fir()) and the H stage in registers, and writes every
// output once.  Synthesis (sum_hw22_kernel) is the design of hwsum.cuh:
// the four inputs staged together, taps by value under a compile-time
// bound, register windows, its tile from the host.
#include "hwsum.cuh"

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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// analysis, its tile from pick_tile
template <typename T, int P, int D, int S>
cudaError_t run_hw22(const T* x, T* const* out, int N, int H, int W, int Ho,
                     int Wo, const double* taps, const int* lens,
                     const int* offs, cudaStream_t stream) {
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
  auto kernel = hw22_kernel<T, P, D, S>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), PACK_THREADS, smem, stream>>>(
      x, out[0], out[1], out[2], out[3], H, W, Ho, Wo, OH, OW, XR, XC, cmin,
      n_th, n_tw, plan);
  return cudaGetLastError();
}

template <int P, int D, int S>
int dispatch_hw22(const void* x, void* const* out, int N, int H, int W,
                  int Ho, int Wo, const double* taps, const int* lens,
                  const int* offs, int dtype, void* stream) {
  if (N < 1 || H < 1 || W < 1 || Ho < 1 || Wo < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DTCWT_RUN_HW22(T)                                                   \
  run_hw22<T, P, D, S>(static_cast<const T*>(x),                            \
                       reinterpret_cast<T* const*>(out), N, H, W, Ho, Wo,   \
                       taps, lens, offs, st)
  switch (dtype) {
    case DT_F32:
      return DTCWT_RUN_HW22(float);
    case DT_BF16:
      return DTCWT_RUN_HW22(__nv_bfloat16);
    case DT_F64:
      return DTCWT_RUN_HW22(double);
  }
#undef DTCWT_RUN_HW22
  return cudaErrorInvalidValue;
}

// The synthesis tile the host chose (ops/hw.py _sum_hw22_geometry): OH x
// OW output samples, the tap bound MT, the staged area XR x XC and the
// dynamic shared memory in bytes.
struct SumTile {
  int oh, ow, mt, xr, xc, smem;
};

// synthesis at tap bound MT: the instance's tile and no other
template <typename T, int P, int MT>
cudaError_t run_sum_hw22(const T* const* v, T* y, int N, int H, int W,
                         int Ho, int Wo,
                         const HsTaps<typename AccOf<T>::type, P>& tp,
                         const SumTile& tile, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  using G = HsGeo<A, P, MT>;
  constexpr size_t smem = G::SMEM;
  if (tile.oh != HS_TILE || tile.ow != HS_TILE || tile.xr != G::X ||
      tile.xc != G::X || static_cast<size_t>(tile.smem) != smem)
    return cudaErrorInvalidValue;
  const int n_th = (Ho + HS_TILE - 1) / HS_TILE;
  const int n_tw = (Wo + HS_TILE - 1) / HS_TILE;
  const int64_t blocks = static_cast<int64_t>(N) * n_th * n_tw;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = sum_hw22_kernel<T, P, MT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), PACK_THREADS, smem, stream>>>(
      v[0], v[1], v[2], v[3], y, H, W, Ho, Wo, n_th, n_tw, tp);
  return cudaGetLastError();
}

// The plan's taps at the least tap bound of the instance set that holds
// them, which must be the host's; then that instance.
template <typename T, int P>
cudaError_t sum_hw22_mt(const void* const* in, void* out, int N, int H,
                        int W, int Ho, int Wo, const double* taps,
                        const int* lens, const int* offs,
                        const SumTile& tile, cudaStream_t st) {
  using A = typename AccOf<T>::type;
  HsTaps<A, P> tp{};
  int mt = 0;
  for (int e = 0; e < HS_BOUNDS && !mt; ++e)
    if (make_hs_taps<A, P>(&tp, taps, lens, offs, hs_bound<P>(e)))
      mt = hs_bound<P>(e);
  if (!mt || tile.mt != mt) return cudaErrorInvalidValue;
  const T* const v[4] = {
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3])};
  T* y = static_cast<T*>(out);
#define DTCWT_RUN_SUM(E)                                                   \
  if (mt == hs_bound<P>(E))                                                 \
  return run_sum_hw22<T, P, hs_bound<P>(E)>(v, y, N, H, W, Ho, Wo, tp, tile, \
                                            st)
  DTCWT_RUN_SUM(0);
  DTCWT_RUN_SUM(1);
  DTCWT_RUN_SUM(2);
  DTCWT_RUN_SUM(3);
  DTCWT_RUN_SUM(4);
#undef DTCWT_RUN_SUM
  return cudaErrorInvalidValue;
}

template <int P, int D>
int dispatch_sum_hw22(const void* const* in, void* out, int N, int H, int W,
                      int Ho, int Wo, const double* taps, const int* lens,
                      const int* offs, int dtype, const SumTile& tile,
                      void* stream) {
  // filter keeps the size, ifilt doubles it (H and W even)
  if (N < 1 || H < 1 || W < 1 || Ho != D * H || Wo != D * W ||
      (D == 2 && (H % 2 || W % 2)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return sum_hw22_mt<float, P>(in, out, N, H, W, Ho, Wo, taps, lens,
                                   offs, tile, st);
    case DT_BF16:
      return sum_hw22_mt<__nv_bfloat16, P>(in, out, N, H, W, Ho, Wo, taps,
                                           lens, offs, tile, st);
    case DT_F64:
      return sum_hw22_mt<double, P>(in, out, N, H, W, Ho, Wo, taps, lens,
                                    offs, tile, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace dtcwt

// C interface of the four kernels, all tensors of the storage type.
// taps: host float64 [2 branches][P streams][MAX_TAPS]; lens, offs: host
// [2][P].  Each returns the launch's CUDA error code.
//   analysis:  in0 = x [N, H, W]; out0..out3 = o00, o01, o10, o11
//              [N, Ho, Wo]; in1..in3 unused.
#define DTCWT_HW_EXPORT(name, P, D, S)                                      \
  extern "C" int name(const void* in0, const void* in1, const void* in2,    \
                      const void* in3, void* out0, void* out1, void* out2,  \
                      void* out3, int N, int H, int W, int Ho, int Wo,      \
                      const double* taps, const int* lens, const int* offs, \
                      int dtype, void* stream) {                            \
    void* out[4] = {out0, out1, out2, out3};                                \
    return dtcwt::dispatch_hw22<P, D, S>(in0, out, N, H, W, Ho, Wo, taps,   \
                                         lens, offs, dtype, stream);        \
  }
//   synthesis: v00, v01, v10, v11 [N, H, W] -> y [N, Ho, Wo]; oh .. smem
//              the host's tile (SumTile), refused unless it is the
//              kernel's.
#define DTCWT_SUM_HW_EXPORT(name, P, D)                                     \
  extern "C" int name(const void* v00, const void* v01, const void* v10,    \
                      const void* v11, void* y, int N, int H, int W, int Ho, \
                      int Wo, const double* taps, const int* lens,          \
                      const int* offs, int dtype, int oh, int ow, int mt,   \
                      int xr, int xc, int smem, void* stream) {             \
    const void* in[4] = {v00, v01, v10, v11};                              \
    return dtcwt::dispatch_sum_hw22<P, D>(                                  \
        in, y, N, H, W, Ho, Wo, taps, lens, offs, dtype,                    \
        dtcwt::SumTile{oh, ow, mt, xr, xc, smem}, stream);                  \
  }

DTCWT_HW_EXPORT(dtcwt_filter_hw22, 1, 1, 1)
DTCWT_HW_EXPORT(dtcwt_dfilt_hw22, 2, 4, 2)
DTCWT_SUM_HW_EXPORT(dtcwt_filter_sum_hw22, 1, 1)
DTCWT_SUM_HW_EXPORT(dtcwt_ifilt_sum_hw22, 4, 2)
