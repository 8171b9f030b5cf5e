// The two 3-D analysis level kernels, one per depth-slice pair (CUDA C++,
// sm_90a):
//
//   fwd_level1_pack  level-1 analysis: both biort filters along W and H of
//                    the four depth-filtered slices + the cube2c pack
//   fwd_level2_pack  the same with the decimating qshift pairs (dfilt)
//
// Replace the Pallas kernels of dtcwt_tpu/ops/pallas_pack3d.py
// (_build_pack_pairs, _build_pack_pairs2; entries fwd_level1_pack,
// fwd_level2_pack).  The depth stage of each level runs before them on the
// dual-stream kernels of dual.cu along axis -3; the synthesis kernels are
// pack3d.cu's.  What they compute, what bounds them and their design:
// fpack.cuh (fwd_pack_kernel, on hw22_kernel's stages of hwana.cuh and the
// pieces of hwtile.cuh).  x is read at symmetric reflection (fold() of
// common.cuh, folded as often as needed, so H or W shorter than the filter
// works).  Storage types float (planes or interleaved), bfloat16 (planes)
// and double (both); the inputs are in the compute type (float for float
// and bfloat16, double for double), each output rounded to storage once.
// The host chooses the tap bound and the tile (ops/hwtile.py
// _fwd_pack_geometry) and passes them in; the C entry refuses any other
// with a CUDA error and launches nothing.
#include "fpack.cuh"

namespace dtcwt {

// The host's tap bound (level 2's taps by parity), then that instance over
// the B Dn / 2 depth-slice pairs, a block for each depth branch of a pair.
template <typename T, bool PLANES, int P>
cudaError_t run_fwd_pack(const void* lo, const void* hi, void* lll,
                         void* band_a, void* band_b, int B, int Dn, int H,
                         int W, int Ho, int Wo, const double* taps,
                         const int* lens, const int* offs,
                         const HwTile& tile, cudaStream_t st) {
  using A = typename AccOf<T>::type;
  HsTaps<A, P> tp{};
  const int mt = hs_fill<A, P>(&tp, taps, lens, offs, tile);
  // the LLL's 2-vectors and the 16-byte pieces of the interleaved subbands
  // need their outputs aligned
  if (!mt || reinterpret_cast<uintptr_t>(lll) % (2 * sizeof(T)) ||
      (!PLANES && reinterpret_cast<uintptr_t>(band_a) % 16))
    return cudaErrorInvalidValue;
  hs_taps_by_parity(&tp);
  const int64_t slabs = static_cast<int64_t>(B) * Dn;  // pairs x branches
  if (slabs > INT_MAX) return cudaErrorInvalidValue;
#define DTCWT_RUN_FWD(E)                                                    \
  if (mt == hs_bound<P>(E))                                                 \
  return launch_tiles<FpGeo<A, PLANES, P, hs_bound<P>(E)>>(                 \
      fwd_pack_kernel<T, PLANES, P, hs_bound<P>(E)>, tile,                  \
      static_cast<int>(slabs), Ho, Wo, st, tp, static_cast<const A*>(lo),   \
      static_cast<const A*>(hi), static_cast<T*>(lll), band_a, band_b, Dn,  \
      H, W, Ho, Wo)
  DTCWT_RUN_FWD(0);
  DTCWT_RUN_FWD(1);
  DTCWT_RUN_FWD(2);
  DTCWT_RUN_FWD(3);
  DTCWT_RUN_FWD(4);
#undef DTCWT_RUN_FWD
  return cudaErrorInvalidValue;
}

// level 1 (P = 1) keeps H and W, level 2 (P = 2) halves them (multiples of
// 4); the output sides are even
template <int P>
int dispatch_fwd_pack(const void* lo, const void* hi, void* lll,
                      void* band_a, void* band_b, int B, int Dn, int H,
                      int W, int Ho, int Wo, const double* taps,
                      const int* lens, const int* offs, int dtype,
                      int planes, const HwTile& tile, void* stream) {
  if (B < 1 || Dn < 2 || Dn % 2 || Ho < 2 || Wo < 2 || Ho % 2 || Wo % 2 ||
      Ho * P != H || Wo * P != W || (P == 2 && (H % 4 || W % 4)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DTCWT_RUN_PACK(T, PL)                                               \
  run_fwd_pack<T, PL, P>(lo, hi, lll, band_a, band_b, B, Dn, H, W, Ho, Wo,  \
                         taps, lens, offs, tile, st)
  switch (dtype) {
    case DT_F32:
      return planes ? DTCWT_RUN_PACK(float, true)
                    : DTCWT_RUN_PACK(float, false);
    case DT_BF16:
      if (!planes) return cudaErrorInvalidValue;
      return DTCWT_RUN_PACK(__nv_bfloat16, true);
    case DT_F64:
      return planes ? DTCWT_RUN_PACK(double, true)
                    : DTCWT_RUN_PACK(double, false);
  }
#undef DTCWT_RUN_PACK
  return cudaErrorInvalidValue;
}

}  // namespace dtcwt

// C interface of the two kernels.  dtype: the storage type.  in_a / in_b =
// lo / hi [B, Dn, H, W] (compute type); out_a = lll [B, Dn, Ho, Wo]
// (storage type); out_b / out_c = re / im planes [B, 28, Dn/2, Ho/2, Wo/2]
// (planes = 1) or out_b = the interleaved complex [B, Dn/2, Ho/2, Wo/2, 28]
// (planes = 0); bands_a / bands_b unused (the synthesis entries' places).
// taps: host float64 [2 branches][P streams][MAX_TAPS]; lens, offs: host
// [2][P]; oh .. smem: the host's tile (HwTile), refused unless it is the
// instance's.  Returns the launch's CUDA error code.
#define DTCWT_FWD_PACK_EXPORT(name, P)                                         \
  extern "C" int name(const void* in_a, const void* in_b,                     \
                      const void* bands_a, const void* bands_b, void* out_a,  \
                      void* out_b, void* out_c, int B, int Dn, int H, int W,  \
                      int Ho, int Wo, const double* taps, const int* lens,    \
                      const int* offs, int dtype, int planes, int oh, int ow, \
                      int mt, int xr, int xc, int smem, void* stream) {       \
    (void)bands_a;                                                            \
    (void)bands_b;                                                            \
    return dtcwt::dispatch_fwd_pack<P>(                                       \
        in_a, in_b, out_a, out_b, out_c, B, Dn, H, W, Ho, Wo, taps, lens,     \
        offs, dtype, planes, dtcwt::HwTile{oh, ow, mt, xr, xc, smem},         \
        stream);                                                              \
  }

DTCWT_FWD_PACK_EXPORT(dtcwt_fwd_level1_pack, 1)
DTCWT_FWD_PACK_EXPORT(dtcwt_fwd_level2_pack, 2)
