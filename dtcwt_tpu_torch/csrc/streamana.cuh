// The analysis entries of dual.cu, along any axis of a contiguous tensor
// (CUDA C++, sm_90a):
//
//   filter2  (filter(x, h0), filter(x, h1))             (P = 1)
//   dfilt2   (dfilt(x, *p0), dfilt(x, *p1)), n -> n / 2  (P = 2)
//
// [outer, n_in, inner] -> two [outer, P g_b, inner]: filter g_b = n + 1 -
// m_b % 2 outputs (the branches may differ in parity, so in length),
// dfilt g = n / 4 groups of its two streams (level2.dfilt_streams, their
// order set by the sign of sum(ha hb)).  Replace _build_filter2 and
// _build_dfilt2 of dtcwt_tpu/ops/pallas_dual.py (entries filter2_axis,
// dfilt2_axis and their *_fromext_axis forms).
//
// Bound on the H100: device memory bytes.  Each input sample is read once
// and feeds both branches' outputs: 12 bytes an f32 input sample for filter
// (two thirds of them stores), 8 for dfilt, against m_0 + m_1 multiply-adds
// an output pair (dfilt m a stream, every other sample), far under the
// card's ~20 float32 operations per byte.  What held the first port
// (streams.cuh's stream_kernel, two branches) at 24-38% of that bound was
// the work it issued per byte, as for the sums (streamsum.cuh): a sample a
// staging item, reflected and converted, about one load in flight a
// thread; the taps converted from a float64 table into shared memory by
// every block, two shared loads a multiply-add, in loops of run-time
// length; every output row re-reading its window from shared memory for
// each branch, its stream found by a division, windows of neighbouring
// dfilt rows 4 and 2 words apart (bank conflicts where inner = 1).  This
// design is the sums' run the other way, one input into two outputs, on the
// pieces of streamtile.cuh:
//
// * Taps by value in the kernel's parameters (HsTaps of taps.cuh) under a
//   compile-time bound MT the host chooses (filter 5, 7, 9, 19 or 33; dfilt
//   10, 14, 16, 18 or 32; every dtype), both branches centred on one common
//   halo: every tap loop runs to MT with register indices and no guard, the
//   taps past a branch's own reach being zero.  The largest bounds hold
//   every filter the plans take: 32 taps of either parity (the branches of
//   either parity each), qshift pairs of 32.
// * dfilt reads every other sample: its window starts on an even sample
//   (4 g - 2 ph), so that a sample's parity is its index's.  The taps are
//   placed by parity (hs_taps_by_parity: the host's plan swaps a branch's
//   streams where its first stream reads the odd samples), each parity
//   sums into its own accumulators with compile-time indices, and the
//   branch's swap sw places the two sums on their output rows at the store.
// * Columns (inner > 1): a thread owns VC columns and RV groups (filter 4
//   outputs, dfilt 2 groups of 2) of both branches, loads the rows its
//   window needs once and adds each into every output of both branches
//   that it reaches; each output vector is written once.
// * Rows (inner = 1): a block stages a flat range of the input with
//   cp.async; a thread item is GV groups (16 bytes of outputs a branch)
//   from one register window feeding both branches, each branch stored as
//   a vector where its output row allows.  Only windows that cross a row's
//   end reflect.
// * filter's branches may differ in length and parity: the kernel runs the
//   groups of the longer output, max(g_0, g_1), and stores each branch
//   only below its own g_b.
//
// The host (ops/dual.py _stream_geometry, _plan) chooses the path, the
// tiling, the tap bound and the shared memory and passes them in; the C
// entries refuse any other with a CUDA error and launch nothing.
// tests/test_torch_dual_tiling.py replays both paths on the CPU.
#pragma once

#include "streamtile.cuh"

namespace dtcwt {

// Columns path.  Block b: column tile b % n_ct, group tile (b / n_ct) %
// n_rt, outer index b / (n_ct n_rt); thread (tx, ty) = (tid % TX, tid /
// TX) owns columns ((ct TX + tx) VC ..) + VC - 1 and groups ((rt TY + ty)
// RV ..) + RV - 1 of both branches, TY = threads / TX.
template <typename T, int P, int MT, int VC>
__global__ void __launch_bounds__(ST_THREADS)
    ana_cols(const T* __restrict__ x, T* __restrict__ y0,
             T* __restrict__ y1, int n_in, int inner, int g0n, int g1n,
             int side, int refl, int lgTX, int n_rt, int n_ct,
             const __grid_constant__ HsTaps<typename AccOf<T>::type, P> tp) {
  using A = typename AccOf<T>::type;
  constexpr int RV = st_col_groups<P, 1>();
  constexpr int D = st_step<P>();
  constexpr int PH = (MT - 1) / 2;
  const int tid = threadIdx.x;
  const int tx = tid & ((1 << lgTX) - 1), ty = tid >> lgTX;
  const int ct = static_cast<int>(blockIdx.x % n_ct);
  const int rt = static_cast<int>((blockIdx.x / n_ct) % n_rt);
  const int64_t o = blockIdx.x / (static_cast<int64_t>(n_ct) * n_rt);
  const int col = ((ct << lgTX) + tx) * VC;
  const int g0 = (rt * (ST_THREADS >> lgTX) + ty) * RV;
  if (col >= inner || g0 >= (g0n > g1n ? g0n : g1n)) return;
  const T* xp = x + o * n_in * static_cast<int64_t>(inner) + col;
  // the window's first sample
  const int j0 = D * g0 - st_tap_step<P>() * PH + side;

  A acc[2][RV][P][VC];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int v = 0; v < RV; ++v)
#pragma unroll
      for (int s = 0; s < P; ++s)
#pragma unroll
        for (int u = 0; u < VC; ++u) acc[b][v][s][u] = 0;
  if constexpr (P == 1) {
#pragma unroll
    for (int r = 0; r < RV + MT - 1; ++r) {
      A w[VC];
      st_load_row<T, A, VC>(xp, j0 + r, n_in, inner, refl, w);
      st_fir<A, MT, RV, VC>(acc[0], r, tp.t[0][0], w);
      st_fir<A, MT, RV, VC>(acc[1], r, tp.t[1][0], w);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2 * RV + MT - 2; ++r) {
      A e[VC], od[VC];
      st_load_row<T, A, VC>(xp, j0 + 2 * r, n_in, inner, refl, e);
      st_load_row<T, A, VC>(xp, j0 + 2 * r + 1, n_in, inner, refl, od);
      st_fir_dec<A, MT, RV, VC>(acc[0], r, tp.t[0], e, od);
      st_fir_dec<A, MT, RV, VC>(acc[1], r, tp.t[1], e, od);
    }
  }
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int gb = b ? g1n : g0n;
    // dfilt: parity p is the stream p ^ sw
    const int sw = P == 2 ? tp.sw[b] : 0;
    T* out = (b ? y1 : y0) + (o * gb + g0) * static_cast<int64_t>(P) * inner +
             col;
#pragma unroll
    for (int v = 0; v < RV; ++v)
      if (g0 + v < gb) {
#pragma unroll
        for (int p = 0; p < P; ++p)
          store_pack<T, A, VC>(
              out + static_cast<int64_t>(P * v + (p ^ sw)) * inner,
              acc[b][v][p]);
      }
  }
}

// One rows-path block's staged input: in-row sample j of staged row r is
// xs[base + r n_in + j], its cells [lo, hi]; the block's groups s0 ..
// end[b] - 1 of each row go to y[b] (rows of P g[b]).
template <typename T> struct AnaRowTile {
  const T* xs;
  T* y[2];
  int64_t o0;
  int s0, n_in, refl, j00;  // j00: group s0's window start
  int base, lo, hi;
  int end[2], g[2];
  bool vec_out[2];
};

// Groups s0 + q GV .. + GV - 1 of staged row r, both branches from one
// register window.  FAST: the window lies inside the row.
template <typename T, int P, int MT, bool FAST>
__device__ __forceinline__ void ana_rows_item(
    const AnaRowTile<T>& tl, const HsTaps<typename AccOf<T>::type, P>& tp,
    int r, int q) {
  using A = typename AccOf<T>::type;
  constexpr int D = st_step<P>();
  constexpr int GV = st_row_groups<T, P>();
  constexpr int NW = st_span<P, MT>(GV);  // an item's window samples
  constexpr int V = vec16<T>();
  const int j0 = tl.j00 + D * GV * q;
  A w[NW];
  st_row_window<T, A, NW, FAST>(tl.xs, tl.base + r * tl.n_in, j0, tl.n_in,
                                tl.refl, tl.lo, tl.hi, w);
  const int gq = tl.s0 + GV * q;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    A acc[GV * P];
#pragma unroll
    for (int i = 0; i < GV * P; ++i) acc[i] = 0;
    if constexpr (P == 1) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const A tk = tp.t[b][0][m];
#pragma unroll
        for (int v = 0; v < GV; ++v) acc[v] += tk * w[v + m];
      }
    } else {
      // group v, parity p, pair m: window sample 4 v + p + 2 m
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const A tk = tp.t[b][p][m];
#pragma unroll
          for (int v = 0; v < GV; ++v)
            acc[2 * v + p] += tk * w[4 * v + p + 2 * m];
        }
      // parity p is the stream p ^ sw
      const bool sw = tp.sw[b];
#pragma unroll
      for (int v = 0; v < GV; ++v) {
        const A a0 = acc[2 * v], a1 = acc[2 * v + 1];
        acc[2 * v] = sw ? a1 : a0;
        acc[2 * v + 1] = sw ? a0 : a1;
      }
    }
    const int nv = P * (tl.end[b] - gq < GV ? tl.end[b] - gq : GV);
    if (nv <= 0) continue;
    T* out =
        tl.y[b] + (tl.o0 + r) * static_cast<int64_t>(P) * tl.g[b] + P * gq;
    if (tl.vec_out[b] && nv == GV * P) {
#pragma unroll
      for (int e = 0; e < GV * P / V; ++e)
        store_pack<T, A, V>(out + e * V, acc + e * V);
    } else {
#pragma unroll
      for (int i = 0; i < GV * P; ++i)
        if (i < nv) store(out + i, acc[i]);
    }
  }
}

// Rows path (inner = 1).  Block b: segment b % n_seg of rows (b / n_seg) R
// .. + R - 1; segment s covers groups [s L, s L + L) of gn = max(g_0, g_1).
template <typename T, int P, int MT>
__global__ void __launch_bounds__(ST_THREADS)
    ana_rows(const T* __restrict__ x, T* __restrict__ y0,
             T* __restrict__ y1, int outer, int n_in, int g0n, int g1n,
             int side, int refl, int R, int L, int n_seg,
             const __grid_constant__ HsTaps<typename AccOf<T>::type, P> tp) {
  constexpr int D = st_step<P>();
  constexpr int PH = (MT - 1) / 2;
  constexpr int GV = st_row_groups<T, P>();
  constexpr int NW = st_span<P, MT>(GV);
  constexpr int V = vec16<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int gn = g0n > g1n ? g0n : g1n;
  const int s0 = static_cast<int>(blockIdx.x % n_seg) * L;
  const int64_t o0 = static_cast<int64_t>(blockIdx.x / n_seg) * R;
  const int rows = static_cast<int>(
      outer - o0 < static_cast<int64_t>(R) ? outer - o0 : R);
  const int lr = gn - s0 < L ? gn - s0 : L;  // groups of the tile a row

  // stage the flat range from in-row sample sa of the first row to sb of
  // the last: the windows of groups s0 .. s0 + L - 1
  const int j00 = D * s0 - st_tap_step<P>() * PH + side;
  const int sa = j00 > 0 ? j00 : 0;
  const int sb = j00 + st_span<P, MT>(L) < n_in ? j00 + st_span<P, MT>(L)
                                                : n_in;
  const int len = (rows - 1) * n_in + (sb - sa);
  const int pad = st_stage_flat(x + o0 * n_in + sa, xs, len);
  cp_async_wait_all();
  __syncthreads();

  auto vec_ok = [&](const T* y, int g) {
    return (P * g) % V == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  };
  const AnaRowTile<T> tl{xs, {y0, y1}, o0, s0, n_in, refl, j00,
                         pad - sa, pad, pad + len - 1,
                         {g0n < s0 + lr ? g0n : s0 + lr,
                          g1n < s0 + lr ? g1n : s0 + lr},
                         {g0n, g1n}, {vec_ok(y0, g0n), vec_ok(y1, g1n)}};
  // items [q_lo, q_hi) of GV groups read inside their row; the others, at
  // the row's ends, reflect or read zero, in a loop of their own so that
  // no warp of the interior diverges
  const int items = (lr + GV - 1) / GV;
  const int lo = -j00;               // j0 >= 0 <=> q D GV >= lo
  const int hi = n_in - NW - j00;    // j0 + NW <= n_in <=> q D GV <= hi
  const int q_lo = lo > 0 ? min(items, (lo + D * GV - 1) / (D * GV)) : 0;
  const int q_hi =
      max(q_lo, min(items, hi < 0 ? 0 : hi / (D * GV) + 1));
  const int ni = q_hi - q_lo, ne = items - ni;
  for (int it = tid; it < rows * ni; it += ST_THREADS) {
    const int r = it / ni;
    ana_rows_item<T, P, MT, true>(tl, tp, r, q_lo + it - r * ni);
  }
  for (int it = tid; it < rows * ne; it += ST_THREADS) {
    const int r = it / ne, k = it - r * ne;
    ana_rows_item<T, P, MT, false>(tl, tp, r,
                                   k < q_lo ? k : q_hi + k - q_lo);
  }
}

// The instance of tap bound MT, if the host's tiling is one it runs.
template <typename T, int P, int MT>
cudaError_t run_ana(const T* x, T* y0, T* y1, int outer, int n_in,
                    int inner, int g0n, int g1n, int side, int refl,
                    const HsTaps<typename AccOf<T>::type, P>& tp,
                    const StTile& t, cudaStream_t st) {
  const int gn = g0n > g1n ? g0n : g1n;
  if (t.path == 0) {  // rows
    int n_seg, rb;
    if (!st_rows_tile<T, P, MT>(t, inner, n_in, gn, 1, &n_seg, &rb))
      return cudaErrorInvalidValue;
    const int64_t blocks =
        (static_cast<int64_t>(outer) + t.rows - 1) / t.rows * n_seg;
    return st_launch(ana_rows<T, P, MT>, blocks, t.smem, st, x, y0, y1,
                     outer, n_in, g0n, g1n, side, refl, t.rows, t.seg, n_seg,
                     tp);
  }
  int lgTX;
  if (!st_cols_tile<P, 1>(t, inner, &lgTX)) return cudaErrorInvalidValue;
  const int n_rt = (gn + t.seg - 1) / t.seg;
  const int64_t n_ct = (static_cast<int64_t>(inner) + t.tx * t.vc - 1) /
                       (static_cast<int64_t>(t.tx) * t.vc);
  const int64_t blocks = static_cast<int64_t>(outer) * n_rt * n_ct;
  if (t.vc == 1)
    return st_launch(ana_cols<T, P, MT, 1>, blocks, 0, st, x, y0, y1, n_in,
                     inner, g0n, g1n, side, refl, lgTX, n_rt,
                     static_cast<int>(n_ct), tp);
  constexpr int VC = col_vec<T>();
  const uintptr_t align = VC * sizeof(T);
  if (t.vc != VC || inner % VC ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y0) |
       reinterpret_cast<uintptr_t>(y1)) % align)
    return cudaErrorInvalidValue;
  return st_launch(ana_cols<T, P, MT, VC>, blocks, 0, st, x, y0, y1, n_in,
                   inner, g0n, g1n, side, refl, lgTX, n_rt,
                   static_cast<int>(n_ct), tp);
}

// The plans' taps at the least tap bound of the instance set that holds
// them (dfilt's by parity), which must be the host's; then that instance.
template <typename T, int P>
cudaError_t dispatch_ana_mt(const void* x, void* y0, void* y1, int outer,
                            int n_in, int inner, int g0n, int g1n, int side,
                            int refl, const double* taps, const int* lens,
                            const int* offs, const StTile& t,
                            cudaStream_t st) {
  using A = typename AccOf<T>::type;
  HsTaps<A, P> tp{};
  const int mt = st_fill_taps<A, P>(&tp, taps, lens, offs);
  if (!mt || mt != t.mt) return cudaErrorInvalidValue;
  hs_taps_by_parity(&tp);
  const T* xt = static_cast<const T*>(x);
  T* y0t = static_cast<T*>(y0);
  T* y1t = static_cast<T*>(y1);
#define DTCWT_RUN_ANA(E)                                                     \
  if (mt == st_bound<P>(E))                                                  \
  return run_ana<T, P, st_bound<P>(E)>(xt, y0t, y1t, outer, n_in, inner,    \
                                       g0n, g1n, side, refl, tp, t, st)
  DTCWT_RUN_ANA(0);
  DTCWT_RUN_ANA(1);
  DTCWT_RUN_ANA(2);
  DTCWT_RUN_ANA(3);
  DTCWT_RUN_ANA(4);
#undef DTCWT_RUN_ANA
  return cudaErrorInvalidValue;
}

template <int P>
int dispatch_ana(const void* x, void* y0, void* y1, int outer, int n_in,
                 int inner, int g0n, int g1n, int side, int refl,
                 const double* taps, const int* lens, const int* offs,
                 int dtype, const StTile& t, void* stream) {
  if (outer < 1 || n_in < 1 || inner < 1 || g0n < 1 || g1n < 1 ||
      side < 0 || (refl != 0 && refl != 1) || (refl && side))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return dispatch_ana_mt<float, P>(x, y0, y1, outer, n_in, inner, g0n,
                                       g1n, side, refl, taps, lens, offs, t,
                                       st);
    case DT_BF16:
      return dispatch_ana_mt<__nv_bfloat16, P>(x, y0, y1, outer, n_in,
                                               inner, g0n, g1n, side, refl,
                                               taps, lens, offs, t, st);
    case DT_F64:
      return dispatch_ana_mt<double, P>(x, y0, y1, outer, n_in, inner, g0n,
                                        g1n, side, refl, taps, lens, offs, t,
                                        st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace dtcwt

// C interface of the two analysis entries.  x: the input viewed as [outer,
// n_in, inner]; y0, y1: [outer, P g0, inner] and [outer, P g1, inner] (dfilt
// g0 = g1).  side: the extension of a pre-extended buffer (refl = 0), or 0
// with refl = 1 (x read at symmetric reflection of the length-n_in axis).
// taps: host float64 [2 branches][P streams][MAX_TAPS]; lens, offs: host
// [2][P], the plans' offsets without the side.  mt .. smem: the host's
// tiling (StTile), refused unless the instance runs it.  Returns the
// launch's CUDA error code.
#define DTCWT_ANA_EXPORT(name, P)                                           \
  extern "C" int name(const void* x, void* y0, void* y1, int outer,         \
                      int n_in, int inner, int g0, int g1, int side,        \
                      int refl, const double* taps, const int* lens,        \
                      const int* offs, int dtype, int mt, int path, int v,  \
                      int vc, int rows, int seg, int tx, int smem,          \
                      void* stream) {                                       \
    return dtcwt::dispatch_ana<P>(                                          \
        x, y0, y1, outer, n_in, inner, g0, g1, side, refl, taps, lens,      \
        offs, dtype, dtcwt::StTile{mt, path, v, vc, rows, seg, tx, smem},   \
        stream);                                                            \
  }
