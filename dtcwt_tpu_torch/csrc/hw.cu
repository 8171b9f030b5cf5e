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
// FIR on the host's stream plans (filter: one stream a stage; dfilt: two,
// level2.dfilt_streams; ifilt: four, ilevel2.ifilt_streams).  x is read at
// symmetric reflection (fold() of common.cuh), so any H and W work, those
// shorter than the filter included.  Storage types float, bfloat16 and
// double; float and bfloat16 accumulate in float, double in double, and
// each output is rounded to storage once.
//
// Both kernels are one design run both ways (hwtile.cuh holds the pieces
// they share): 32 x 32 output tiles, the staged area through maps folded
// once a block and 16-byte cp.async copies, taps by value under a
// compile-time bound, register windows in both stages.  Analysis
// (hw22_kernel) is in hwana.cuh, synthesis (sum_hw22_kernel) in hwsum.cuh.
// The host chooses the tile, the tap bound and the shared memory
// (ops/hw.py _hw22_geometry, _sum_hw22_geometry) and passes them in; each
// C entry refuses any other with a CUDA error and launches nothing.
#include "hwana.cuh"
#include "hwsum.cuh"

namespace dtcwt {

// analysis: the host's tap bound (dfilt's taps by parity), then that
// instance
template <typename T, int P>
cudaError_t hw22_mt(const void* in, void* const* out, int N, int H, int W,
                    int Ho, int Wo, const double* taps, const int* lens,
                    const int* offs, const HwTile& tile, cudaStream_t st) {
  using A = typename AccOf<T>::type;
  HsTaps<A, P> tp{};
  const int mt = hs_fill<A, P>(&tp, taps, lens, offs, tile);
  if (!mt) return cudaErrorInvalidValue;
  hs_taps_by_parity(&tp);
  const T* x = static_cast<const T*>(in);
  T* const* o = reinterpret_cast<T* const*>(out);
#define DTCWT_RUN_HW22(E)                                                   \
  if (mt == hs_bound<P>(E))                                                 \
  return launch_tiles<HaGeo<A, P, hs_bound<P>(E)>>(                         \
      hw22_kernel<T, P, hs_bound<P>(E)>, tile, N, Ho, Wo, st, tp, x, o[0],    \
      o[1], o[2], o[3], H, W, Ho, Wo)
  DTCWT_RUN_HW22(0);
  DTCWT_RUN_HW22(1);
  DTCWT_RUN_HW22(2);
  DTCWT_RUN_HW22(3);
  DTCWT_RUN_HW22(4);
#undef DTCWT_RUN_HW22
  return cudaErrorInvalidValue;
}

// synthesis: the host's tap bound, then that instance
template <typename T, int P>
cudaError_t sum_hw22_mt(const void* const* in, void* out, int N, int H,
                        int W, int Ho, int Wo, const double* taps,
                        const int* lens, const int* offs, const HwTile& tile,
                        cudaStream_t st) {
  using A = typename AccOf<T>::type;
  HsTaps<A, P> tp{};
  const int mt = hs_fill<A, P>(&tp, taps, lens, offs, tile);
  if (!mt) return cudaErrorInvalidValue;
  const T* const v[4] = {
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3])};
  T* y = static_cast<T*>(out);
#define DTCWT_RUN_SUM(E)                                                    \
  if (mt == hs_bound<P>(E))                                                 \
  return launch_tiles<HsGeo<A, P, hs_bound<P>(E)>>(                         \
      sum_hw22_kernel<T, P, hs_bound<P>(E)>, tile, N, Ho, Wo, st, tp, v[0], \
      v[1], v[2], v[3], y, H, W, Ho, Wo)
  DTCWT_RUN_SUM(0);
  DTCWT_RUN_SUM(1);
  DTCWT_RUN_SUM(2);
  DTCWT_RUN_SUM(3);
  DTCWT_RUN_SUM(4);
#undef DTCWT_RUN_SUM
  return cudaErrorInvalidValue;
}

// analysis: filter (P = 1) keeps the size, dfilt (P = 2) halves it (H and
// W multiples of 4)
template <int P>
int dispatch_hw22(const void* x, void* const* out, int N, int H, int W,
                  int Ho, int Wo, const double* taps, const int* lens,
                  const int* offs, int dtype, const HwTile& tile,
                  void* stream) {
  if (N < 1 || H < 1 || W < 1 || Ho * P != H || Wo * P != W ||
      (P == 2 && (H % 4 || W % 4)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return hw22_mt<float, P>(x, out, N, H, W, Ho, Wo, taps, lens, offs,
                               tile, st);
    case DT_BF16:
      return hw22_mt<__nv_bfloat16, P>(x, out, N, H, W, Ho, Wo, taps, lens,
                                       offs, tile, st);
    case DT_F64:
      return hw22_mt<double, P>(x, out, N, H, W, Ho, Wo, taps, lens, offs,
                                tile, st);
  }
  return cudaErrorInvalidValue;
}

template <int P, int D>
int dispatch_sum_hw22(const void* const* in, void* out, int N, int H, int W,
                      int Ho, int Wo, const double* taps, const int* lens,
                      const int* offs, int dtype, const HwTile& tile,
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
// [2][P]; oh .. smem: the host's tile (HwTile), refused unless it is the
// kernel's.  Each returns the launch's CUDA error code.
//   analysis:  in0 = x [N, H, W]; out0..out3 = o00, o01, o10, o11
//              [N, Ho, Wo]; in1..in3 unused.
#define DTCWT_HW_EXPORT(name, P)                                            \
  extern "C" int name(const void* in0, const void* in1, const void* in2,    \
                      const void* in3, void* out0, void* out1, void* out2,  \
                      void* out3, int N, int H, int W, int Ho, int Wo,      \
                      const double* taps, const int* lens, const int* offs, \
                      int dtype, int oh, int ow, int mt, int xr, int xc,    \
                      int smem, void* stream) {                             \
    void* out[4] = {out0, out1, out2, out3};                                \
    return dtcwt::dispatch_hw22<P>(                                         \
        in0, out, N, H, W, Ho, Wo, taps, lens, offs, dtype,                 \
        dtcwt::HwTile{oh, ow, mt, xr, xc, smem}, stream);                   \
  }
//   synthesis: v00, v01, v10, v11 [N, H, W] -> y [N, Ho, Wo].
#define DTCWT_SUM_HW_EXPORT(name, P, D)                                     \
  extern "C" int name(const void* v00, const void* v01, const void* v10,    \
                      const void* v11, void* y, int N, int H, int W, int Ho, \
                      int Wo, const double* taps, const int* lens,          \
                      const int* offs, int dtype, int oh, int ow, int mt,   \
                      int xr, int xc, int smem, void* stream) {             \
    const void* in[4] = {v00, v01, v10, v11};                              \
    return dtcwt::dispatch_sum_hw22<P, D>(                                  \
        in, y, N, H, W, Ho, Wo, taps, lens, offs, dtype,                    \
        dtcwt::HwTile{oh, ow, mt, xr, xc, smem}, stream);                   \
  }

DTCWT_HW_EXPORT(dtcwt_filter_hw22, 1)
DTCWT_HW_EXPORT(dtcwt_dfilt_hw22, 2)
DTCWT_SUM_HW_EXPORT(dtcwt_filter_sum_hw22, 1, 1)
DTCWT_SUM_HW_EXPORT(dtcwt_ifilt_sum_hw22, 4, 2)
