// Level-1 inverse of the 2-D DTCWT in one kernel (CUDA C++, sm_90a).
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
// The bandpass families (near_sym_b_bp) add a third odd synthesis filter
// g2o, the third stream (template flag BP): hh leaves y2, which becomes
// colfilter(hl, g0), and gets a column stage of its own,
//   y3 = colfilter(hh, g2),  out += rowfilter(y3, g2).
//
// Bound on the H100: device memory bytes.  Per output pixel it reads the
// lowpass sample and a quarter of a quad's six complex subbands and writes
// one sample (20 bytes in f32) for 3 (m0 + m1) multiply-adds, far under
// the card's ratio of operations to bytes.  What held the first design
// back was the work it issued per byte: it rebuilt the quad images pixel
// by pixel (a division, two modulos and all six complex subbands, 48 bytes
// apart, for each staged pixel: every quad fetched four times), ran tap
// loops of run-time length reading the taps from memory, and stored one
// sample at a time.  This design:
//
// * Builds each quad image once per quad.  A staging item is one
//   quarter-resolution position: it reads the position's six complex
//   values once (interleaved: three 16-byte pieces of its 48 contiguous
//   bytes where the host says the pointer allows; planes: one value a
//   plane, lanes on consecutive positions) and writes the 2 x 2 pixels of
//   lh, hl and hh to shared memory as 8-byte pairs, every c2q parity from
//   the same registers.  The staged images start on a quad boundary, e =
//   2 ceil(p / 2) >= p pixels before the tile.  H and W are even, so
//   symmetric reflection maps a quad onto a whole quad, with its parities
//   swapped where the reflected index is odd: edge tiles stage quad by
//   quad too, one fold of the quad's first pixel (two compares; the
//   modulo of reflect() only for axes shorter than the reach) giving the
//   source quad and the swap.
// * Taps travel by value in the kernel's parameters (L1Taps), each filter
//   centred on the common halo p (zero outside its own reach), so every
//   tap loop runs to MT (8, 16, 24 or 32 >= 2 p + 1, chosen by the host)
//   under one uniform guard k < 2 p + 1, with compile-time register
//   indices.
// * A block owns a tile of 16 (f64: 8) x 128 output pixels.
//   Column stage: an item is one staged column (128 + 2 p of them, lanes
//   on consecutive columns) by 16 output rows (f64: 8); it loads the
//   lowpass samples it needs straight from device memory (rows reflect
//   only in tiles that reach past the image) and the quad images' windows
//   from shared memory into registers, one image at a time, and writes
//   the column-filtered y1, y2 (and y3) to shared memory.
// * Row stage: an item is one output row by 4 columns, a warp one row of
//   the tile; it reads each column image's window of 4 + 2 p samples with
//   16-byte shared loads (lanes 16 bytes apart: no bank conflict), filters
//   and sums them in registers and stores the 4 samples as one vector (16
//   bytes in f32), or as pairs where the host says the row is too short
//   or the pointer misaligned for it.
//
// The host (ops/ilevel1.py, _ilevel1_geometry) chooses TH, MT, the quad
// loads and the store vectors and passes them in; the kernel refuses any
// other combination.  The tiling's pieces shared with the level-1 forward
// are in l1tile.cuh; the quad staging, shared with the qshift inverse
// (ilevel2.cu), is common.cuh's stage_quads.
#include <type_traits>

#include "l1tile.cuh"

namespace dtcwt {
namespace {

// Output rows a column-stage item and a tile: 16, or 8 in f64 (whose
// registers are twice as wide and whose tiles, 8 rows, keep the 31-tap
// third stream within a block's shared memory).
template <typename A> __host__ __device__ constexpr int i1_rv() {
  return sizeof(A) == 8 ? 8 : 16;
}

// The staged quad images' halo e (even, >= p), row stride and size.
__host__ __device__ constexpr int i1_e(int p) { return (p + 1) / 2 * 2; }
__host__ __device__ constexpr int i1_xc(int p) { return L1_TW + 2 * i1_e(p); }
__host__ __device__ constexpr int i1_xn(int p, int th) {
  return (th + 2 * i1_e(p)) * i1_xc(p);
}

// s[t] = q[t * stride] for t < rv + mm - 1, zero past it.
template <typename A, int MT>
__device__ __forceinline__ void col_window(const A* q, int stride, int mm,
                                           A s[]) {
  constexpr int RV = i1_rv<A>();
#pragma unroll
  for (int t = 0; t < RV + MT - 1; ++t)
    s[t] = t < RV + mm - 1 ? q[t * stride] : A(0);
}

template <typename A>
__device__ __forceinline__ void put_col(A* o, int stride, A acc[]) {
#pragma unroll
  for (int v = 0; v < i1_rv<A>(); ++v) {
    o[v * stride] = acc[v];
    acc[v] = 0;
  }
}

// Column stage: y1, y2 (and y3) of tile rows 0 .. th - 1 and staged
// columns 0 .. 128 + 2p - 1 (input column c0 - p + lc) into st[s][row][lc].
template <typename T, int MT, bool BP>
__device__ __forceinline__ void col_stage(
    const T* __restrict__ zb, const typename AccOf<T>::type* qs,
    typename AccOf<T>::type* st, int H, int W, int r0, int c0, int th,
    int p, const L1Taps<typename AccOf<T>::type>& tp) {
  using A = typename AccOf<T>::type;
  constexpr int RV = i1_rv<A>();
  const int mm = 2 * p + 1, e = i1_e(p), xc = i1_xc(p), xn = i1_xn(p, th);
  const int xw = L1_TW + 2 * p, xws = l1_xws(p);
  const int items = th / RV * xw;
  const bool rows_in = r0 - p >= 0 && r0 + th + p <= H;
  for (int it = threadIdx.x; it < items; it += L1_THREADS) {
    const int g = it / xw, lc = it - g * xw;
    const int gc = fold(c0 - p + lc, W);
    const int rs = r0 + g * RV - p;  // input row of sample 0
    A s[RV + MT - 1], acc[RV];
#pragma unroll
    for (int v = 0; v < RV; ++v) acc[v] = 0;
    col_load<T, RV, MT>(zb, rs, gc, H, W, mm, rows_in, s);
    fir_acc<A, MT, RV>(s, tp.t[0], mm, acc);
    const A* q = qs + (g * RV + e - p) * xc + lc + e - p;  // lh
    col_window<A, MT>(q, xc, mm, s);
    fir_acc<A, MT, RV>(s, tp.t[1], mm, acc);
    A* o = st + g * RV * xws + lc;
    put_col(o, xws, acc);                                     // y1
    col_window<A, MT>(q + xn, xc, mm, s);                     // hl
    fir_acc<A, MT, RV>(s, tp.t[0], mm, acc);
    col_window<A, MT>(q + 2 * xn, xc, mm, s);                 // hh
    if constexpr (BP) {
      put_col(o + th * xws, xws, acc);                        // y2
      fir_acc<A, MT, RV>(s, tp.t[2], mm, acc);
      put_col(o + 2 * th * xws, xws, acc);                    // y3
    } else {
      fir_acc<A, MT, RV>(s, tp.t[1], mm, acc);
      put_col(o + th * xws, xws, acc);                        // y2
    }
  }
}

template <typename T, bool PLANES, bool BP, int MT>
__global__ void __launch_bounds__(L1_THREADS)
    inv_level1_kernel(const T* __restrict__ z, const void* __restrict__ band_a,
                      const void* __restrict__ band_b, T* __restrict__ out,
                      int H, int W, int th, int p, int vq, int vo,
                      const __grid_constant__ L1Taps<typename AccOf<T>::type>
                          tp) {
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* qs = reinterpret_cast<A*>(smem_raw);  // [3][th + 2e][xc]: lh, hl, hh
  A* st = qs + 3 * i1_xn(p, th);           // [2 or 3][th][xws]: y1, y2, y3

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * th, c0 = blockIdx.x * L1_TW;
  const int mm = 2 * p + 1, xws = l1_xws(p);

  // the quad images of staged pixel rows r0 - e .. r0 + th + e - 1 and
  // columns c0 - e .. c0 + 128 + e - 1 (common.cuh)
  const int e = i1_e(p);
  stage_quads<L1_THREADS, T, PLANES>(band_a, band_b, qs, b, H, W,
                                     r0 / 2 - e / 2, c0 / 2 - e / 2,
                                     th / 2 + e, L1_TW / 2 + e, i1_xc(p),
                                     i1_xn(p, th), vq);
  __syncthreads();
  col_stage<T, MT, BP>(z + static_cast<int64_t>(b) * H * W, qs, st, H, W,
                       r0, c0, th, p, tp);
  __syncthreads();

  T* ob = out + static_cast<int64_t>(b) * H * W;
  const int items = th * (L1_TW / L1_V);
  for (int it = threadIdx.x; it < items; it += L1_THREADS) {
    const int rr = it >> 5, g = it & 31;  // tile row, column group
    const int r = r0 + rr, c = c0 + L1_V * g;
    if (r >= H) continue;  // uniform across the warp
    const A* row = st + rr * xws + L1_V * g;
    A o[L1_V], wv[l1_nw<A, MT>()];
#pragma unroll
    for (int v = 0; v < L1_V; ++v) o[v] = 0;
    row_window<A, MT>(row, mm, wv);
    fir_acc<A, MT, L1_V>(wv, tp.t[0], mm, o);
    row_window<A, MT>(row + th * xws, mm, wv);
    fir_acc<A, MT, L1_V>(wv, tp.t[1], mm, o);
    if constexpr (BP) {
      row_window<A, MT>(row + 2 * th * xws, mm, wv);
      fir_acc<A, MT, L1_V>(wv, tp.t[2], mm, o);
    }
    // outputs of this item inside the row: 0, 2 or 4 (W is even)
    const int nc = W - c < L1_V ? (W - c > 0 ? W - c : 0) : L1_V;
    T* dst = ob + static_cast<int64_t>(r) * W + c;
    if (vo == 4 && nc == L1_V) {
      Vec<T, L1_V> pk;
#pragma unroll
      for (int v = 0; v < L1_V; ++v) store(&pk.v[v], o[v]);
      *reinterpret_cast<Vec<T, L1_V>*>(dst) = pk;
    } else {
#pragma unroll
      for (int v = 0; v < L1_V; v += 2) {
        if (v < nc) {
          Vec<T, 2> pk;
          store(&pk.v[0], o[v]);
          store(&pk.v[1], o[v + 1]);
          *reinterpret_cast<Vec<T, 2>*>(dst + v) = pk;
        }
      }
    }
  }
}

template <typename T, bool PLANES, bool BP, int MT>
cudaError_t run_ilevel1(const void* z, const void* band_a, const void* band_b,
                        void* out, int B, int H, int W,
                        const L1Taps<typename AccOf<T>::type>& tp, int p,
                        int th, int vq, int vo, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  const size_t smem =
      sizeof(A) * (3 * static_cast<size_t>(i1_xn(p, th)) +
                   static_cast<size_t>((BP ? 3 : 2) * th) * l1_xws(p));
  const dim3 grid((W + L1_TW - 1) / L1_TW, (H + th - 1) / th, B);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  auto kernel = inv_level1_kernel<T, PLANES, BP, MT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, L1_THREADS, smem, stream>>>(
      static_cast<const T*>(z), band_a, band_b, static_cast<T*>(out), H, W,
      th, p, vq, vo, tp);
  return cudaGetLastError();
}

// The tap bound the host chooses (ops/ilevel1.py): f64 only 32 (it exists
// for the tests), the third stream 24 or 32 (its family's 19 taps), else
// the least of 8, 16, 24, 32 that holds 2 p + 1.
template <typename T, bool BP>
constexpr int tap_bound(int mm) {
  if (std::is_same<T, double>::value) return 32;
  if (BP) return mm <= 24 ? 24 : 32;
  return l1_tap_bound(mm);
}

template <typename T, bool PLANES, bool BP>
cudaError_t ilevel1_mt(const void* z, const void* band_a, const void* band_b,
                       void* out, int B, int H, int W,
                       const double* const t[3], const int m[3], int th,
                       int mt, int vq, int vo, cudaStream_t s) {
  using A = typename AccOf<T>::type;
  L1Taps<A> tp;
  int p;
  if (!make_l1taps(&tp, &p, t, m, BP ? 3 : 2)) return cudaErrorInvalidValue;
  // the host's tiling: its tap bound, 16 rows a tile (f64: 8), 16-byte quad
  // pieces only where the interleaved subbands are 16-byte aligned, 4-wide
  // stores only where rows and the output are aligned for them
  const uintptr_t ob = reinterpret_cast<uintptr_t>(out);
  if (mt != tap_bound<T, BP>(2 * p + 1) || th != i1_rv<A>() ||
      (vq && (PLANES || reinterpret_cast<uintptr_t>(band_a) % 16)) ||
      (vo != 2 && vo != 4) || ob % (vo * sizeof(T)) ||
      (vo == 4 && W % L1_V))
    return cudaErrorInvalidValue;
#define DTCWT_RUN(MT_)                                                    \
  return run_ilevel1<T, PLANES, BP, MT_>(z, band_a, band_b, out, B, H, W, \
                                         tp, p, th, vq, vo, s)
  if constexpr (std::is_same<T, double>::value) {
    DTCWT_RUN(32);
  } else if constexpr (BP) {
    if (mt == 24) DTCWT_RUN(24);
    DTCWT_RUN(32);
  } else {
    switch (mt) {
      case 8:
        DTCWT_RUN(8);
      case 16:
        DTCWT_RUN(16);
      case 24:
        DTCWT_RUN(24);
      default:
        DTCWT_RUN(32);
    }
  }
#undef DTCWT_RUN
}

template <bool BP>
cudaError_t ilevel1_dtype(const void* z, const void* band_a,
                          const void* band_b, void* out, int B, int H, int W,
                          const double* const t[3], const int m[3],
                          int dtype, int planes, int th, int mt, int vq,
                          int vo, cudaStream_t s) {
  switch (dtype) {
    case DT_F32:
      return planes ? ilevel1_mt<float, true, BP>(z, band_a, band_b, out, B,
                                                  H, W, t, m, th, mt, vq, vo,
                                                  s)
                    : ilevel1_mt<float, false, BP>(z, band_a, band_b, out,
                                                   B, H, W, t, m, th, mt, vq,
                                                   vo, s);
    case DT_BF16:
      if (!planes) return cudaErrorInvalidValue;
      return ilevel1_mt<__nv_bfloat16, true, BP>(z, band_a, band_b, out, B,
                                                 H, W, t, m, th, mt, vq, vo,
                                                 s);
    case DT_F64:
      return planes ? ilevel1_mt<double, true, BP>(z, band_a, band_b, out,
                                                   B, H, W, t, m, th, mt, vq,
                                                   vo, s)
                    : ilevel1_mt<double, false, BP>(z, band_a, band_b, out,
                                                    B, H, W, t, m, th, mt,
                                                    vq, vo, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dtcwt

// z, out: [B, H, W]; planes = 0: band_a is the interleaved complex
// [B, H/2, W/2, 6] as real pairs; planes = 1: band_a / band_b are the re /
// im planes [B, 6, H/2, W/2].  t0, t1, t2: reversed taps of g0o, g1o and
// the bandpass families' g2o (t2 null: no third stream).  th (rows a tile:
// 16, f64 8), mt (tap bound), vq (16-byte quad pieces) and vo (4- or 2-wide
// stores): the host's tiling (ops/ilevel1.py).
extern "C" int dtcwt_ilevel1(const void* z, const void* band_a,
                             const void* band_b, void* out, int B, int H,
                             int W, const double* t0, int m0,
                             const double* t1, int m1, const double* t2,
                             int m2, int dtype, int planes, int th, int mt,
                             int vq, int vo, void* stream) {
  using namespace dtcwt;
  if (H % 2 || W % 2 || H < 2 || W < 2 || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* const t[3] = {t0, t1, t2};
  const int m[3] = {m0, m1, t2 ? m2 : 0};
  return t2 ? ilevel1_dtype<true>(z, band_a, band_b, out, B, H, W, t, m,
                                  dtype, planes, th, mt, vq, vo, s)
            : ilevel1_dtype<false>(z, band_a, band_b, out, B, H, W, t, m,
                                   dtype, planes, th, mt, vq, vo, s);
}

// Message of a CUDA error code returned by the functions above.
extern "C" const char* dtcwt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
