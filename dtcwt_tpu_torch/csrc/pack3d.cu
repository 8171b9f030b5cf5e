// The two 3-D synthesis level kernels, one per depth-slice pair (CUDA C++,
// sm_90a):
//
//   inv_level1_pack  level-1 synthesis: c2cube unpack + both biort
//                    synthesis filters along W and H, summed per branch
//   inv_level2_pack  the same with the interpolating qshift pairs (ifilt)
//
// Replace the Pallas kernels of dtcwt_tpu/ops/pallas_pack3d.py
// (_build_unpack_pairs, _build_unpack_pairs2; entries inv_level1_pack,
// inv_level2_pack).  The depth stage of each level runs after these kernels
// on the dual-stream kernels of dual.cu along axis -3; the analysis kernels
// (fwd_level1_pack, fwd_level2_pack) are fpack.cu's.
//
// What they compute.  The kernel reads the 28 subbands and the LLL slice
// pair of the depth-slice pair u, forms the 7 octants' corners with c2cube
// while staging them, and writes, per depth branch i and parity c,
// U_i[2u + c] = sum_{j,k} F_H(g_j) F_W(g_k) octant(i, j, k)[2u + c].
// Every filter is a set of P output streams (host plans, ops/pack3d.py)
// applied along W and along H as taps by value (ipack.cuh), so the kernel
// holds no parity logic.  x is read at symmetric reflection (reflect() of
// common.cuh, folded as often as needed, so H or W shorter than the filter
// works).
//
// Layouts: the subbands are band-major planes [B, 28, Dn/2, Hb, Wb] of the
// storage type (float, bfloat16 or double), or interleaved complex
// band-minor [B, Dn/2, Hb, Wb, 28] (float or double pairs), read directly,
// so that layout costs no extra pass.  U_0, U_1 are in the compute type
// (float for float and bfloat16 storage, double for double).  All offsets
// into device memory are 64-bit.
//
// Bound on the H100: device memory bytes.  The design (ipack.cuh: corners
// built once per band location, taps by value under a compile-time bound,
// register windows) takes its tile from the host (ops/pack3d.py
// _inv_pack_geometry) and refuses any other.
#include "ipack.cuh"

namespace dtcwt {

// The synthesis tile the host chose (ops/pack3d.py _inv_pack_geometry):
// OH x OW output samples, the tap bound MT, the staged area XR x XC, the
// dynamic shared memory in bytes, and vq = 1 for the interleaved subbands
// read as 16-byte pieces.
struct InvTile {
  int oh, ow, mt, xr, xc, smem, vq;
};

template <typename T, bool PLANES, int P, int MT>
cudaError_t run_inv_pack(const void* lll, const void* band_a,
                         const void* band_b, void* out_a, void* out_b, int B,
                         int Dn, int H, int W, int Ho, int Wo,
                         const IpTaps<typename AccOf<T>::type, P>& tp,
                         const InvTile& tile, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  using G = IpGeo<P, MT>;
  constexpr size_t smem = ip_smem<A, P, MT>();
  // the instance's tile and no other
  if (tile.oh != IP_TILE || tile.ow != IP_TILE || tile.xr != G::X ||
      tile.xc != G::X || static_cast<size_t>(tile.smem) != smem ||
      smem > PACK_SMEM_MAX)
    return cudaErrorInvalidValue;
  const int n_th = (Ho + IP_TILE - 1) / IP_TILE;
  const int n_tw = (Wo + IP_TILE - 1) / IP_TILE;
  const int64_t blocks =
      static_cast<int64_t>(B) * (Dn / 2) * n_th * static_cast<int64_t>(n_tw);
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;
  auto launch = [&](auto kernel) -> cudaError_t {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kernel<<<static_cast<unsigned>(blocks), PACK_THREADS, smem, stream>>>(
        static_cast<const T*>(lll), band_a, band_b, static_cast<A*>(out_a),
        static_cast<A*>(out_b), Dn, H, W, Ho, Wo, n_th, n_tw, tile.vq, tp);
    return cudaGetLastError();
  };
  if constexpr (ip_capped<T, PLANES, P>())
    return launch(inv_pack_kernel_capped<T, PLANES, P, MT>);
  else
    return launch(inv_pack_kernel<T, PLANES, P, MT>);
}

// The plan's taps at the least tap bound of the instance set that holds
// them, which must be the host's; then that instance.
template <typename T, bool PLANES, int P>
cudaError_t inv_pack_mt(const void* lll, const void* band_a,
                        const void* band_b, void* out_a, void* out_b, int B,
                        int Dn, int H, int W, int Ho, int Wo,
                        const double* taps, const int* lens, const int* offs,
                        const InvTile& tile, cudaStream_t st) {
  using A = typename AccOf<T>::type;
  IpTaps<A, P> tp{};
  int mt = 0;
  for (int e = 0; e < ip_bound_count<A, P>() && !mt; ++e)
    if (make_ip_taps<A, P>(&tp, taps, lens, offs, ip_bound<A, P>(e)))
      mt = ip_bound<A, P>(e);
  if (!mt || tile.mt != mt ||
      (tile.vq && (PLANES || reinterpret_cast<uintptr_t>(band_a) % 16)))
    return cudaErrorInvalidValue;
#define DTCWT_RUN_INV(MT_)                                                  \
  return run_inv_pack<T, PLANES, P, MT_>(lll, band_a, band_b, out_a, out_b, \
                                         B, Dn, H, W, Ho, Wo, tp, tile, st)
  if constexpr (sizeof(A) == 8) {
    DTCWT_RUN_INV((P == 1 ? IP_K1 : IP_K2));
  } else if constexpr (P == 1) {
    if (mt == 9) DTCWT_RUN_INV(9);
    if (mt == 21) DTCWT_RUN_INV(21);
    DTCWT_RUN_INV(33);
  } else {
    if (mt == 5) DTCWT_RUN_INV(5);
    if (mt == 7) DTCWT_RUN_INV(7);
    if (mt == 9) DTCWT_RUN_INV(9);
    DTCWT_RUN_INV(17);
  }
#undef DTCWT_RUN_INV
}

template <int P>
int dispatch_inv_pack(const void* lll, const void* bands_a,
                      const void* bands_b, void* out_a, void* out_b, int B,
                      int Dn, int H, int W, int Ho, int Wo,
                      const double* taps, const int* lens, const int* offs,
                      int dtype, int planes, const InvTile& tile,
                      void* stream) {
  if (B < 1 || Dn < 2 || Dn % 2 || H < 2 || W < 2 || Ho < 2 || Wo < 2 ||
      Ho % 2 || Wo % 2 || H % 2 || W % 2)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DTCWT_RUN_PACK(T, PL)                                               \
  inv_pack_mt<T, PL, P>(lll, bands_a, bands_b, out_a, out_b, B, Dn, H, W,   \
                        Ho, Wo, taps, lens, offs, tile, st)
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

// C interface of the two kernels.  dtype: the storage type.  in_a = lll
// [B, Dn, H, W] (storage type); bands_a / bands_b = re / im planes [B, 28,
// Dn/2, H/2, W/2] (planes = 1) or bands_a = the interleaved complex level
// (planes = 0); out_a / out_b = U_0 / U_1 [B, Dn, Ho, Wo] (compute type);
// in_b and out_c unused (the analysis entries' places); oh .. vq the host's
// tile (InvTile), refused unless it is the kernel's.  taps: host float64
// [2 branches][P streams][MAX_TAPS]; lens, offs: host [2][P].  Returns the
// launch's CUDA error code.
#define DTCWT_INV_PACK_EXPORT(name, P)                                         \
  extern "C" int name(const void* in_a, const void* in_b,                     \
                      const void* bands_a, const void* bands_b, void* out_a,  \
                      void* out_b, void* out_c, int B, int Dn, int H, int W,  \
                      int Ho, int Wo, const double* taps, const int* lens,    \
                      const int* offs, int dtype, int planes, int oh, int ow, \
                      int mt, int xr, int xc, int smem, int vq,               \
                      void* stream) {                                         \
    (void)in_b;                                                               \
    (void)out_c;                                                              \
    return dtcwt::dispatch_inv_pack<P>(                                       \
        in_a, bands_a, bands_b, out_a, out_b, B, Dn, H, W, Ho, Wo, taps,      \
        lens, offs, dtype, planes,                                            \
        dtcwt::InvTile{oh, ow, mt, xr, xc, smem, vq}, stream);                \
  }

DTCWT_INV_PACK_EXPORT(dtcwt_inv_level1_pack, 1)
DTCWT_INV_PACK_EXPORT(dtcwt_inv_level2_pack, 4)
