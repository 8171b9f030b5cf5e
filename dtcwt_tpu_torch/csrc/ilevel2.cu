// One interpolating (qshift, level >= 2) inverse level of the 2-D DTCWT in
// one kernel (CUDA C++, sm_90a).
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
// The bandpass families (qshift_b_bp) add a third synthesis pair g2a/g2b of
// the same even length, the third stream (template flag BP): hh leaves y2,
// which becomes colifilt(hl, g0b, g0a), and gets a column stage of its own,
//   y3 = colifilt(hh, g2b, g2a),  out += rowifilt(y3, g2b, g2a).
//
// Bound on the H100: device memory bytes.  Per band position (a 4 x 4
// output block) it reads 4 lowpass samples and six complex subbands and
// writes 16 samples (128 bytes in f32) for 16 m multiply-adds, under the
// card's ratio of operations to bytes.  What held the first design back was
// the work it issued per byte: it staged its input tile pixel by pixel (a
// division, two modulos and all six complex subbands, 48 bytes apart, for
// each pixel: every quad fetched four times) in small tiles (16 x 64
// pixels, halo 1.9-4.5x the tile), ran tap loops of run-time length reading
// the taps from memory and every sample from shared memory, and stored its
// 4 x 4 output blocks as scalars.  This design:
//
// * Streams as a uniform swap.  With h2 = floor(m2 / 2), stream s of a pair
//   reads x[2i - 2 h2 + d_s + 2k] with d_s in 0..3, of parity (s & 1) ^ sw:
//   the taps travel by stream in the kernel's parameters (I2Taps), shifted
//   by d_s / 2 and zero past m2, so every tap loop runs to MT (5, 7, 9 or
//   17 >= 2 h2 + 1, chosen by the host) with no guard and compile-time
//   register indices.  A pair's swap sw only chooses which parity a window
//   is loaded from: an address, not a register index.
// * Quad images built once per quad (stage_quads, common.cuh, as in
//   inv_level1): a staging item reads one band position's six complex
//   values once (interleaved: three 16-byte pieces where the host says the
//   pointer allows) and writes its 2 x 2 pixels of lh, hl and hh.  The
//   staged images start 2 h2 pixels (a whole quad) before the tile, so a
//   reflected quad is a whole source quad with its parities swapped.
// * A block owns QH (8, or 4 where 8 leaves SMs without a block; chosen by
//   the host) band rows by 32 band columns: 4 QH x 128 output pixels, 256
//   threads, four blocks an SM on the main path (63 registers, 45 KB).
//   Tiles of 16 band rows took 1.1x the time (two blocks an SM).
//   Column stage: an item is one staged column (lanes on consecutive
//   columns) by G band rows (4; f64 2); it loads each source image's two
//   parity windows of G + MT - 1 rows once into registers (the lowpass
//   straight from device memory, rows reflected only in tiles that reach
//   past the image, with fold()), produces all four row streams of its
//   pairs from them and writes y1, y2 (and y3) to column images split by
//   column parity (l2tile.cuh), so the lanes write disjoint banks.
// * Row stage: an item is one output row by 4 band columns (16 output
//   samples), a warp 4 rows of the tile; it reads each column image's two
//   parity windows of MT + 3 samples with 16-byte shared loads (lanes 16
//   bytes apart: no bank conflict), runs all four column streams of every
//   pair on them and sums the images in registers.  An item's 16 samples
//   lie in 4 vectors 2W apart, so the warp stages its 4 rows in shared
//   memory (the quad images' space, free by then) and stores them a row at
//   a time, one band column's 4 samples a lane: lanes on consecutive
//   vectors, a coalesced warp row.  Stored straight from the items, the
//   lanes' vectors lay 64 bytes apart, and the kernel took 1.4x the time.
//
// The host (ops/ilevel2.py, _ilevel2_geometry) chooses QH, MT and the quad
// loads and passes them in; the kernel refuses any other combination.
#include "l2tile.cuh"

namespace dtcwt {
namespace {

constexpr int I2_THREADS = 256;
constexpr int I2_TQ = 32;     // band columns a tile: 8 row items of 4
constexpr int I2_V = 4;       // band columns a row-stage item
constexpr int I2_MAXK = 17;   // the largest tap bound: m2 = 16 (qshift_32)

// The interpolating pairs' taps by output stream, shifted by d_s / 2 and
// zero past them: t[pair][s][k] multiplies window sample k of parity
// (s & 1) ^ sw[pair].
template <typename A> struct I2Taps {
  A t[3][4][I2_MAXK];
  int sw[3];
};

// Pair pi's taps [stream][m2] and offsets [stream] (stream s gives output
// 4i + s and reads x[2i + offs[s] + 2k]) into stream form.  False where m2
// is out of range or the streams' parities are not one swap of (0, 1, 0,
// 1) (ilevel2.py's ifilt_streams always gives one).
template <typename A>
inline bool set_i2pair(I2Taps<A>* tp, int pi, const double* taps,
                       const int* offs, int m2) {
  if (m2 < 1 || m2 > MAX_TAPS / 2) return false;
  const int h2 = m2 / 2;
  const int sw = (offs[0] + 2 * h2) & 1;
  for (int s = 0; s < 4; ++s) {
    const int d = offs[s] + 2 * h2;
    if (d < 0 || d > 3 || (d & 1) != ((s & 1) ^ sw)) return false;
    for (int k = 0; k < I2_MAXK; ++k) {
      const int kk = k - (d >> 1);
      tp->t[pi][s][k] =
          kk >= 0 && kk < m2 ? static_cast<A>(taps[s * m2 + kk]) : A(0);
    }
  }
  tp->sw[pi] = sw;
  return true;
}

// The tap bound the host chooses for a reach of r = 2 h2 + 1 taps: 5
// (qshift_06, qshift_a: the main path), 7 (qshift_b), 9 (qshift_c,
// qshift_d) or 17 (qshift_32); the third stream 7 (qshift_b_bp) or 17;
// float64 (for tests) 17 only.
template <typename A, bool BP> constexpr int i2_tap_bound(int r) {
  return sizeof(A) == 8 ? 17
         : BP           ? (r <= 7 ? 7 : 17)
         : r <= 5       ? 5
         : r <= 7       ? 7
         : r <= 9       ? 9
                        : 17;
}

// Band rows a column-stage item: 4, or 2 in float64.
template <typename A> __host__ __device__ constexpr int i2_g() {
  return sizeof(A) == 8 ? 2 : 4;
}

// Staged band columns (and rows past the tile's QH): the tile's 32 plus
// MT - 1, from 2 h2 pixels before it; a quad image's row stride.
template <int MT> __host__ __device__ constexpr int i2_xq() {
  return I2_TQ + MT - 1;
}

// A column image's parity half: the staged columns' 32 + MT - 1 values of
// a parity, and the last row item's 16-byte window (28 + round(MT + 3)).
template <typename A, int MT> __host__ __device__ constexpr int i2_xh() {
  constexpr int VN = l1_vn<A>(), NW = (MT + 3 + VN - 1) / VN * VN;
  return l2_half(i2_xq<MT>() > I2_TQ - I2_V + NW ? i2_xq<MT>()
                                                 : I2_TQ - I2_V + NW);
}

// w[t] = z[rs + 2t] of column gc of an H x W image, t < N; rows reflect
// only where !rows_in.
template <typename T, int N>
__device__ __forceinline__ void col_load2(const T* __restrict__ zb, int rs,
                                          int gc, int H, int W, bool rows_in,
                                          typename AccOf<T>::type w[N]) {
  if (rows_in) {
    const T* q = zb + static_cast<int64_t>(rs) * W + gc;
#pragma unroll
    for (int t = 0; t < N; ++t) w[t] = load(q + static_cast<int64_t>(2 * t) * W);
  } else {
#pragma unroll
    for (int t = 0; t < N; ++t)
      w[t] = load(zb + static_cast<int64_t>(fold(rs + 2 * t, H)) * W + gc);
  }
}

// w[t] = q[2t x stride], t < N: a quad image's column window of one parity.
template <typename A, int N>
__device__ __forceinline__ void qwindow(const A* q, int stride, A w[N]) {
#pragma unroll
  for (int t = 0; t < N; ++t) w[t] = q[2 * t * stride];
}

// acc[4v + s] += sum_k t[s][k] w[v + k], w the window of parity (s & 1) ^
// sw: wa (loaded from parity sw) for even streams, wb for odd ones.
template <typename A, int MT, int G>
__device__ __forceinline__ void ifir(const A* wa, const A* wb,
                                     const A (*t)[I2_MAXK], A acc[4 * G]) {
#pragma unroll
  for (int k = 0; k < MT; ++k) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const A tk = t[s][k];
      const A* w = s & 1 ? wb : wa;
#pragma unroll
      for (int v = 0; v < G; ++v) acc[4 * v + s] += tk * w[v + k];
    }
  }
}

// Write an item's 4 G column outputs (rows 4v + s, stride rst) and clear
// them.
template <typename A, int G>
__device__ __forceinline__ void put_rows(A* o, int rst, A acc[4 * G]) {
#pragma unroll
  for (int r = 0; r < 4 * G; ++r) {
    o[r * rst] = acc[r];
    acc[r] = 0;
  }
}

// Column stage: y1, y2 (and y3) of the tile's output rows 0 .. 4 qh - 1
// (row 4v + s of band row v) and staged columns 0 .. 2 XQ - 1 (pixel column
// c0 + lc) into st[image][row][lc & 1][lc / 2].  The staged quad images
// qs[3][qrows][2 XQ] start at pixel row r0, the lowpass is read from
// device memory.
template <typename T, int MT, bool BP>
__device__ __forceinline__ void col_stage(
    const T* __restrict__ zb, const typename AccOf<T>::type* qs,
    typename AccOf<T>::type* st, int H, int W, int r0, int c0, int qh,
    int qn, const I2Taps<typename AccOf<T>::type>& tp) {
  using A = typename AccOf<T>::type;
  constexpr int G = i2_g<A>(), NW = G + MT - 1;
  constexpr int XC = 2 * i2_xq<MT>(), XH = i2_xh<A, MT>();
  constexpr int RST = 2 * XH;
  const int img = 4 * qh * RST;
  const int items = qh / G * XC;
  // the deepest row a window reads: 2 qh - 2 G + 1 + 2 (G + MT - 2)
  const bool rows_in = r0 >= 0 && r0 + 2 * qh + 2 * MT - 3 < H;
  for (int it = threadIdx.x; it < items; it += I2_THREADS) {
    const int g = it / XC, lc = it - g * XC;
    const int gc = fold(c0 + lc, W);
    const int rs = 2 * G * g;  // the item's first window row, staged
    A acc[4 * G], wa[NW], wb[NW];
#pragma unroll
    for (int r = 0; r < 4 * G; ++r) acc[r] = 0;
    // y1 = colifilt(z, pair 0) + colifilt(lh, pair 1)
    col_load2<T, NW>(zb, r0 + rs + tp.sw[0], gc, H, W, rows_in, wa);
    col_load2<T, NW>(zb, r0 + rs + 1 - tp.sw[0], gc, H, W, rows_in, wb);
    ifir<A, MT, G>(wa, wb, tp.t[0], acc);
    const A* q = qs + rs * XC + lc;
    qwindow<A, NW>(q + tp.sw[1] * XC, XC, wa);
    qwindow<A, NW>(q + (1 - tp.sw[1]) * XC, XC, wb);
    ifir<A, MT, G>(wa, wb, tp.t[1], acc);
    A* o = st + 4 * G * g * RST + (lc & 1) * XH + (lc >> 1);
    put_rows<A, G>(o, RST, acc);
    // y2 = colifilt(hl, pair 0) + colifilt(hh, pair 1); with the third
    // stream y2 = colifilt(hl, pair 0), y3 = colifilt(hh, pair 2)
    qwindow<A, NW>(q + qn + tp.sw[0] * XC, XC, wa);
    qwindow<A, NW>(q + qn + (1 - tp.sw[0]) * XC, XC, wb);
    ifir<A, MT, G>(wa, wb, tp.t[0], acc);
    constexpr int PH = BP ? 2 : 1;  // hh's pair
    if constexpr (BP) put_rows<A, G>(o + img, RST, acc);
    qwindow<A, NW>(q + 2 * qn + tp.sw[PH] * XC, XC, wa);
    qwindow<A, NW>(q + 2 * qn + (1 - tp.sw[PH]) * XC, XC, wb);
    ifir<A, MT, G>(wa, wb, tp.t[PH], acc);
    put_rows<A, G>(o + PH * img, RST, acc);
  }
}

// o[q][s] += the row filter of pair P on one row of a column image (its
// even half at e, its odd half at e + XH, both at the item's first window
// sample): band column q, stream s.
template <typename A, int MT, int P>
__device__ __forceinline__ void row_ifir(const A* e, const I2Taps<A>& tp,
                                         A o[I2_V][4]) {
  constexpr int VN = l1_vn<A>(), NW = (MT + 3 + VN - 1) / VN * VN;
  constexpr int XH = i2_xh<A, MT>();
  A wa[NW], wb[NW];
  const int sw = tp.sw[P];
  vec_window<A, NW>(e + sw * XH, NW, wa);
  vec_window<A, NW>(e + (1 - sw) * XH, NW, wb);
#pragma unroll
  for (int k = 0; k < MT; ++k) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const A tk = tp.t[P][s][k];
      const A* w = s & 1 ? wb : wa;
#pragma unroll
      for (int q = 0; q < I2_V; ++q) o[q][s] += tk * w[q + k];
    }
  }
}

template <typename T, bool PLANES, bool BP, int MT>
__global__ void __launch_bounds__(
    I2_THREADS, (sizeof(typename AccOf<T>::type) == 8 ? 1 : 2))
    inv_level2_kernel(const T* __restrict__ z, const void* __restrict__ band_a,
                      const void* __restrict__ band_b, T* __restrict__ out,
                      int H, int W, int qh, int h2, int vq,
                      const __grid_constant__ I2Taps<typename AccOf<T>::type>
                          tp) {
  using A = typename AccOf<T>::type;
  constexpr int XQ = i2_xq<MT>(), XC = 2 * XQ, XH = i2_xh<A, MT>();
  constexpr int RST = 2 * XH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qn = 2 * (qh + MT - 1) * XC;   // one staged quad image
  A* qs = reinterpret_cast<A*>(smem_raw);  // [3][2 (qh + MT - 1)][XC]
  A* st = qs + 3 * qn;                     // [2 or 3][4 qh][2][XH]
  const int img = 4 * qh * RST;

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * qh, j0 = blockIdx.x * I2_TQ;  // band row, col
  const int h = H / 2, w = W / 2;

  stage_quads<I2_THREADS, T, PLANES>(band_a, band_b, qs, b, H, W, i0 - h2,
                                     j0 - h2, qh + MT - 1, XQ, XC, qn, vq);
  __syncthreads();
  col_stage<T, MT, BP>(z + static_cast<int64_t>(b) * H * W, qs, st, H, W,
                       2 * (i0 - h2), 2 * (j0 - h2), qh, qn, tp);
  __syncthreads();

  // row stage, an item a thread (32 qh <= 256 of them): a warp is 4 output
  // rows by the tile's 32 band columns; it stages its 512 samples in the
  // quad images' space (free now) and stores them a row at a time, one band
  // column's 4 samples a lane
  const int it = threadIdx.x, lane = it & 31;
  const int rr = it >> 3, g = it & 7;  // tile output row, band group
  if (it >= 4 * qh * (I2_TQ / I2_V) || i0 + (rr >> 2) >= h)
    return;  // uniform across the warp
  A o[I2_V][4];
#pragma unroll
  for (int q = 0; q < I2_V; ++q)
#pragma unroll
    for (int s = 0; s < 4; ++s) o[q][s] = 0;
  const A* e = st + rr * RST + I2_V * g;
  row_ifir<A, MT, 0>(e, tp, o);
  row_ifir<A, MT, 1>(e + img, tp, o);
  if constexpr (BP) row_ifir<A, MT, 2>(e + 2 * img, tp, o);
  // band column 4g + q of row rr & 3 at slot q ^ (g / 2 % 4): the lanes of
  // a 16-byte phase hit distinct banks here and in the read below
  A* ws = qs + (it >> 5) * 4 * I2_TQ * 4;  // the warp's [4 rows][32][4]
  A* my = ws + (lane >> 3) * I2_TQ * 4 + g * 16;
#pragma unroll
  for (int q = 0; q < I2_V; ++q) {
    Vec<A, 4> pk;
#pragma unroll
    for (int s = 0; s < 4; ++s) pk.v[s] = o[q][s];
    *reinterpret_cast<Vec<A, 4>*>(my + 4 * (q ^ (g >> 1 & 3))) = pk;
  }
  __syncwarp();
  const int j = j0 + lane;  // this lane's band column
  if (j >= w) return;
  const int gl = lane >> 2;
  const A* src = ws + gl * 16 + 4 * ((lane & 3) ^ (gl >> 1 & 3));
  T* dst = out + (static_cast<int64_t>(b) * 2 * H + 4 * i0 + (rr & ~3)) *
                     (2 * W) + 4 * j;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const Vec<A, 4> pk =
        *reinterpret_cast<const Vec<A, 4>*>(src + r * I2_TQ * 4);
    Vec<T, 4> ov;
#pragma unroll
    for (int s = 0; s < 4; ++s) store(&ov.v[s], pk.v[s]);
    *reinterpret_cast<Vec<T, 4>*>(dst + static_cast<int64_t>(r) * 2 * W) = ov;
  }
}

template <typename T, bool PLANES, bool BP, int MT>
cudaError_t run_ilevel2(const void* z, const void* band_a, const void* band_b,
                        void* out, int B, int H, int W,
                        const I2Taps<typename AccOf<T>::type>& tp, int h2,
                        int qh, int vq, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  const size_t smem =
      sizeof(A) * (3 * static_cast<size_t>(2 * (qh + MT - 1)) * 2 *
                       i2_xq<MT>() +
                   static_cast<size_t>((BP ? 3 : 2) * 4 * qh) * 2 *
                       i2_xh<A, MT>());
  const dim3 grid((W / 2 + I2_TQ - 1) / I2_TQ, (H / 2 + qh - 1) / qh, B);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  auto kernel = inv_level2_kernel<T, PLANES, BP, MT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, I2_THREADS, smem, stream>>>(
      static_cast<const T*>(z), band_a, band_b, static_cast<T*>(out), H, W,
      qh, h2, vq, tp);
  return cudaGetLastError();
}

template <typename T, bool PLANES, bool BP>
cudaError_t ilevel2_mt(const void* z, const void* band_a, const void* band_b,
                       void* out, int B, int H, int W, const double* taps,
                       const int* offs, const double* taps2, const int* offs2,
                       int m2, int qh, int mt, int vq, cudaStream_t s) {
  using A = typename AccOf<T>::type;
  I2Taps<A> tp{};
  if (!set_i2pair(&tp, 0, taps, offs, m2) ||
      !set_i2pair(&tp, 1, taps + 4 * m2, offs + 4, m2) ||
      (BP && !set_i2pair(&tp, 2, taps2, offs2, m2)))
    return cudaErrorInvalidValue;
  // the host's tiling: its tap bound, 4 or 8 band rows a tile, 16-byte
  // quad pieces only where the interleaved subbands are 16-byte aligned,
  // an output aligned for the 4-sample vectors
  const int h2 = m2 / 2;
  if (mt != i2_tap_bound<A, BP>(2 * h2 + 1) ||
      (qh != 4 && qh != 8) ||
      (vq && (PLANES || reinterpret_cast<uintptr_t>(band_a) % 16)) ||
      reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)))
    return cudaErrorInvalidValue;
#define DTCWT_RUN(MT_)                                                    \
  return run_ilevel2<T, PLANES, BP, MT_>(z, band_a, band_b, out, B, H, W, \
                                         tp, h2, qh, vq, s)
  if constexpr (sizeof(A) == 8) {
    DTCWT_RUN(17);
  } else if constexpr (BP) {
    if (mt == 7) DTCWT_RUN(7);
    DTCWT_RUN(17);
  } else {
    switch (mt) {
      case 5:
        DTCWT_RUN(5);
      case 7:
        DTCWT_RUN(7);
      case 9:
        DTCWT_RUN(9);
      default:
        DTCWT_RUN(17);
    }
  }
#undef DTCWT_RUN
}

template <bool BP>
cudaError_t ilevel2_dtype(const void* z, const void* band_a,
                          const void* band_b, void* out, int B, int H, int W,
                          const double* taps, const int* offs,
                          const double* taps2, const int* offs2, int m2,
                          int dtype, int planes, int qh, int mt, int vq,
                          cudaStream_t s) {
  switch (dtype) {
    case DT_F32:
      return planes ? ilevel2_mt<float, true, BP>(z, band_a, band_b, out, B,
                                                  H, W, taps, offs, taps2,
                                                  offs2, m2, qh, mt, vq, s)
                    : ilevel2_mt<float, false, BP>(z, band_a, band_b, out,
                                                   B, H, W, taps, offs,
                                                   taps2, offs2, m2, qh, mt,
                                                   vq, s);
    case DT_BF16:
      if (!planes) return cudaErrorInvalidValue;
      return ilevel2_mt<__nv_bfloat16, true, BP>(z, band_a, band_b, out, B,
                                                 H, W, taps, offs, taps2,
                                                 offs2, m2, qh, mt, vq, s);
    case DT_F64:
      return planes ? ilevel2_mt<double, true, BP>(z, band_a, band_b, out,
                                                   B, H, W, taps, offs,
                                                   taps2, offs2, m2, qh, mt,
                                                   vq, s)
                    : ilevel2_mt<double, false, BP>(z, band_a, band_b, out,
                                                    B, H, W, taps, offs,
                                                    taps2, offs2, m2, qh, mt,
                                                    vq, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dtcwt

// z: [B, H, W]; planes = 0: band_a is the interleaved complex
// [B, H/2, W/2, 6] as real pairs; planes = 1: band_a / band_b are the re /
// im planes [B, 6, H/2, W/2].  out: [B, 2H, 2W].  taps: [pair (g0b/g0a,
// g1b/g1a)][stream][m2]; offs: [pair][stream].  taps2 / offs2: the bandpass
// families' third pair (g2b/g2a) as [stream][m2] / [stream]; null for no
// third stream.  qh (band rows a tile: 4 or 8), mt (tap bound) and vq
// (16-byte quad pieces): the host's tiling (ops/ilevel2.py).
extern "C" int dtcwt_ilevel2(const void* z, const void* band_a,
                             const void* band_b, void* out, int B, int H,
                             int W, const double* taps, const int* offs,
                             const double* taps2, const int* offs2, int m2,
                             int dtype, int planes, int qh, int mt, int vq,
                             void* stream) {
  using namespace dtcwt;
  if (H % 2 || W % 2 || H < 2 || W < 2 || B < 1 || B > 65535 ||
      (taps2 == nullptr) != (offs2 == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return taps2 ? ilevel2_dtype<true>(z, band_a, band_b, out, B, H, W, taps,
                                     offs, taps2, offs2, m2, dtype, planes,
                                     qh, mt, vq, s)
               : ilevel2_dtype<false>(z, band_a, band_b, out, B, H, W, taps,
                                      offs, taps2, offs2, m2, dtype, planes,
                                      qh, mt, vq, s);
}
