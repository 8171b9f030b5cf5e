// Filters of any length along any axis of a contiguous tensor (CUDA C++,
// sm_90a): the kernel every wrapper of ops/ launches past its own kernel's
// tap bound (ops/_build.py TAP_BOUNDS, ops/longfir.py).
//
// The three 1-D operations of ops/fb.py are one stream FIR: on the view
// [outer, n_in, inner] of the input along the filtered axis, branch b
// writes
//
//   Y_b[P i + s] = sum_{k < m_bs} t_bs[k] x[D i + c_bs + S k],   i < g_b
//
// with P output streams of m_bs taps at offsets c_bs (fb.filter_streams:
// P = D = S = 1; fb.dfilt_streams: P = 2, D = 4, S = 2; fb.ifilt_streams:
// P = 4, D = 2, S = 2).  Two forms: analysis, one input and one or two
// branches with an output each (filter, filter2, dfilt, dfilt2, ifilt);
// sum, branch b reading input b and both summed into one output
// (filter2_sum, ifilt2_sum).  Two boundary modes: refl = 1 reads x at
// symmetric reflection of the length-n_in axis, folded as often as the
// filter needs (source() in common.cuh), so a filter may be longer than
// the axis; refl = 0 reads a buffer the caller has already extended by
// `side` samples a side (the sharded passes, the explicit adjoints), and
// the host checks that every read stays inside it.
//
// Replaces no TPU kernel: dtcwt_tpu runs these lengths in pallas_level1 /
// pallas_level2 up to 129 / 128 taps and on its XLA path beyond, and the
// port's fused kernels hold their taps under compile-time bounds.
//
// Bound on the H100: an output costs m multiply-adds against the bytes of
// one input and one output sample (8 in float32), so the bytes bound it up
// to about 80 taps (67 TFLOP/s against 3.35 TB/s) and the float32
// operations past that.  The design is the simple one, right first (its
// times against the bound are in PERF.md; making it fast is later work):
//
// * the taps stay in a device buffer of run-time length, in the
//   accumulator type; lanes that compute one stream read the same tap at
//   each k, a broadcast through the read-only cache.  No compile-time tap
//   bound, no register window and no shared memory that grows with the
//   filter;
// * a block is 256 threads: tx across the contiguous columns (inner > 1)
//   by 256 / tx output rows; a thread owns VC columns tx apart, so each
//   load of a warp is tx adjacent samples, and one output row (all its
//   branches); with inner = 1 (the filtered axis contiguous) tx = VC = 1
//   and a warp takes 32 adjacent outputs of one row, whose reads are
//   adjacent too;
// * float32 and bfloat16 accumulate in float32, float64 in float64; each
//   output is written once.
#include <climits>

#include "common.cuh"

namespace dtcwt {
namespace {

constexpr int LF_THREADS = 256;
constexpr int LF_STREAMS = 8;  // two branches of at most four streams

// A launch's streams: stream q = b P + s of branch b has len[q] taps from
// taps[tap0[q]] and reads from offset off[q]; g[b] groups of branch b.
struct LfPlan {
  int P, D, S, nb;
  int g[2];
  int len[LF_STREAMS];
  int off[LF_STREAMS];
  int tap0[LF_STREAMS];
};

// Block: column tile ct, row tile rt of outer row o (the last fastest in
// blockIdx.x).  SUM: branch b reads input b and the branches add into y0.
template <typename T, int VC, bool SUM>
__global__ void __launch_bounds__(LF_THREADS) longfir_kernel(
    const T* __restrict__ x0, const T* __restrict__ x1, T* __restrict__ y0,
    T* __restrict__ y1, const typename AccOf<T>::type* __restrict__ taps,
    const LfPlan pl, const int n_in, const int64_t inner, const int shift,
    const int refl, const int tx, const int64_t col_tiles,
    const int64_t row_tiles) {
  using A = typename AccOf<T>::type;
  int64_t blk = blockIdx.x;
  const int64_t ct = blk % col_tiles;
  blk /= col_tiles;
  const int64_t rt = blk % row_tiles;
  const int64_t o = blk / row_tiles;
  const int ty = LF_THREADS / tx;
  const int i = static_cast<int>(rt * ty) + threadIdx.x / tx;
  const int64_t c0 = ct * tx * VC + threadIdx.x % tx;
  if (c0 >= inner) return;
  const int s = i % pl.P, grp = i / pl.P;
  A sum[VC];
#pragma unroll
  for (int v = 0; v < VC; ++v) sum[v] = A(0);
  for (int b = 0; b < pl.nb; ++b) {
    if (grp >= pl.g[b]) continue;
    const int q = b * pl.P + s;
    const T* xo = ((SUM && b == 1) ? x1 : x0) + o * n_in * inner + c0;
    const A* t = taps + pl.tap0[q];
    const int j0 = pl.D * grp + pl.off[q] + shift;
    A acc[VC];
#pragma unroll
    for (int v = 0; v < VC; ++v) acc[v] = A(0);
    for (int k = 0; k < pl.len[q]; ++k) {
      const A tk = __ldg(t + k);
      const T* p = xo + source(j0 + pl.S * k, n_in, refl) * inner;
#pragma unroll
      for (int v = 0; v < VC; ++v)
        if (c0 + v * tx < inner) acc[v] += tk * load(p + v * tx);
    }
    if constexpr (SUM) {
#pragma unroll
      for (int v = 0; v < VC; ++v) sum[v] += acc[v];
    } else {
      T* yo = (b ? y1 : y0) +
              (o * (static_cast<int64_t>(pl.P) * pl.g[b]) + i) * inner + c0;
#pragma unroll
      for (int v = 0; v < VC; ++v)
        if (c0 + v * tx < inner) store(yo + v * tx, acc[v]);
    }
  }
  if constexpr (SUM) {
    if (grp >= pl.g[0]) return;
    T* yo = y0 + (o * (static_cast<int64_t>(pl.P) * pl.g[0]) + i) * inner +
            c0;
#pragma unroll
    for (int v = 0; v < VC; ++v)
      if (c0 + v * tx < inner) store(yo + v * tx, sum[v]);
  }
}

template <typename T, int VC>
int launch_vc(const void* x0, const void* x1, void* y0, void* y1,
              int64_t outer, int n_in, int64_t inner, int sum, int shift,
              int refl, const void* taps, const LfPlan& pl, int tx,
              cudaStream_t st) {
  using A = typename AccOf<T>::type;
  const int ty = LF_THREADS / tx;
  const int rows = pl.P * (pl.g[0] > pl.g[1] ? pl.g[0] : pl.g[1]);
  const int64_t cols = int64_t(tx) * VC;  // columns a block
  const int64_t col_tiles = (inner + cols - 1) / cols;
  const int64_t row_tiles = (rows + ty - 1) / ty;
  const int64_t blocks = outer * row_tiles * col_tiles;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const T* a = static_cast<const T*>(x0);
  const T* b = static_cast<const T*>(x1);
  const A* t = static_cast<const A*>(taps);
  if (sum)
    longfir_kernel<T, VC, true><<<static_cast<unsigned>(blocks), LF_THREADS,
                                  0, st>>>(
        a, b, static_cast<T*>(y0), nullptr, t, pl, n_in, inner, shift, refl,
        tx, col_tiles, row_tiles);
  else
    longfir_kernel<T, VC, false><<<static_cast<unsigned>(blocks),
                                   LF_THREADS, 0, st>>>(
        a, nullptr, static_cast<T*>(y0), static_cast<T*>(y1), t, pl, n_in,
        inner, shift, refl, tx, col_tiles, row_tiles);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x0, const void* x1, void* y0, void* y1, int64_t outer,
           int n_in, int64_t inner, int sum, int shift, int refl,
           const void* taps, const LfPlan& pl, int vc, int tx,
           cudaStream_t st) {
  if (vc == 4)
    return launch_vc<T, 4>(x0, x1, y0, y1, outer, n_in, inner, sum, shift,
                           refl, taps, pl, tx, st);
  return launch_vc<T, 1>(x0, x1, y0, y1, outer, n_in, inner, sum, shift,
                         refl, taps, pl, tx, st);
}

}  // namespace
}  // namespace dtcwt

// x0, x1 (sum form: branch 1's input), y0, y1 (analysis: branch 1's
// output); the view [outer, n_in, inner]; sum; side and refl; taps: a
// device buffer in the accumulator type; meta: the host ints P, D, S, nb,
// g0, g1, then len, off, tap0 of the 8 streams; dtype; the tiling vc (1 or
// 4 columns a thread) and tx (threads across columns, a power of two up
// to 256); stream.
extern "C" int dtcwt_longfir(const void* x0, const void* x1, void* y0,
                             void* y1, long long outer, int n_in,
                             long long inner, int sum, int side, int refl,
                             const void* taps, const int* meta, int dtype,
                             int vc, int tx, void* stream) {
  dtcwt::LfPlan pl;
  pl.P = meta[0];
  pl.D = meta[1];
  pl.S = meta[2];
  pl.nb = meta[3];
  pl.g[0] = meta[4];
  pl.g[1] = meta[5];
  for (int q = 0; q < dtcwt::LF_STREAMS; ++q) {
    pl.len[q] = meta[6 + q];
    pl.off[q] = meta[6 + dtcwt::LF_STREAMS + q];
    pl.tap0[q] = meta[6 + 2 * dtcwt::LF_STREAMS + q];
  }
  if (outer < 1 || inner < 1 || n_in < 1 || !taps || !x0 || !y0 ||
      (pl.P != 1 && pl.P != 2 && pl.P != 4) || pl.nb < 1 || pl.nb > 2 ||
      (sum && (pl.nb != 2 || !x1 || pl.g[0] != pl.g[1])) ||
      (!sum && pl.nb == 2 && !y1) || (vc != 1 && vc != 4) || tx < 1 ||
      tx > dtcwt::LF_THREADS || (tx & (tx - 1)) || (inner == 1 && tx != 1) ||
      pl.g[0] < 1 || (pl.nb == 2 && pl.g[1] < 1))
    return cudaErrorInvalidValue;
  if (pl.nb == 1) pl.g[1] = 0;
  const int shift = refl ? 0 : side;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dtcwt::DT_F32:
      return dtcwt::launch<float>(x0, x1, y0, y1, outer, n_in, inner, sum,
                                  shift, refl, taps, pl, vc, tx, st);
    case dtcwt::DT_BF16:
      return dtcwt::launch<__nv_bfloat16>(x0, x1, y0, y1, outer, n_in, inner,
                                          sum, shift, refl, taps, pl, vc, tx,
                                          st);
    case dtcwt::DT_F64:
      return dtcwt::launch<double>(x0, x1, y0, y1, outer, n_in, inner, sum,
                                   shift, refl, taps, pl, vc, tx, st);
  }
  return cudaErrorInvalidValue;
}
