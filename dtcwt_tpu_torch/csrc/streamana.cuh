// The analysis kernels of the stream plans, along any axis of a contiguous
// tensor (CUDA C++, sm_90a): dual.cu's two entries, NB = 2 branches,
//
//   filter2  (filter(x, h0), filter(x, h1))             (P = 1)
//   dfilt2   (dfilt(x, *p0), dfilt(x, *p1)), n -> n / 2  (P = 2)
//
// and single.cu's one-branch entry, NB = 1,
//
//   dfilt    dfilt(x, ha, hb), n -> n / 2                (P = 2)
//
// [outer, n_in, inner] -> NB [outer, P g_b, inner]: filter g_b = n + 1 -
// m_b % 2 outputs (the branches may differ in parity, so in length),
// dfilt g = n / 4 groups of its two streams (level2.dfilt_streams, their
// order set by the sign of sum(ha hb)).  Replace _build_filter2 and
// _build_dfilt2 of dtcwt_tpu/ops/pallas_dual.py (entries filter2_axis,
// dfilt2_axis and their *_fromext_axis forms) and _build_dfilt of
// dtcwt_tpu/ops/pallas_fb.py (dfilt_axis, dfilt_fromext_axis).
//
// Bound on the H100: device memory bytes.  Each input sample is read once
// and feeds every branch's outputs: 12 bytes an f32 input sample for
// filter2 (two thirds of them stores), 8 for dfilt2, 6 for dfilt, against
// m multiply-adds an output (dfilt m a stream, every other sample), far
// under the card's ~20 float32 operations per byte.  What held the first
// port (a stream-plan kernel with a sample a staging item and the taps in
// shared memory) at 24-38% of that bound was the work it issued per byte,
// as for the sums (streamsum.cuh): a sample a staging item, reflected and
// converted, about one load in flight a thread; the taps converted from a
// float64 table into shared memory by every block, two shared loads a
// multiply-add, in loops of run-time length; every output row re-reading
// its window from shared memory, its stream found by a division, windows
// of neighbouring dfilt rows 4 and 2 words apart (bank conflicts where
// inner = 1).  This design is the sums' run the other way, one input into
// NB outputs, on the pieces of streamtile.cuh:
//
// * Taps by value in the kernel's parameters (HsTaps of taps.cuh, NB
//   branches) under a compile-time bound MT the host chooses (filter 5, 7,
//   9, 19 or 33; dfilt 10, 14, 16, 18 or 32; every dtype), every branch
//   centred on one common halo: every tap loop runs to MT with register
//   indices and no guard, the taps past a branch's own reach being zero.
//   The largest bounds hold every filter the plans take: 32 taps of either
//   parity (the branches of either parity each), qshift pairs of 32.
// * dfilt reads every other sample: its window starts on an even sample
//   (4 g - 2 ph), so that a sample's parity is its index's.  The taps are
//   placed by parity (hs_taps_by_parity: the host's plan swaps a branch's
//   streams where its first stream reads the odd samples), each parity
//   sums into its own accumulators with compile-time indices, and the
//   branch's swap sw places the two sums on their output rows at the store.
// * Columns (inner > 1): a thread owns VC columns and RV groups of each
//   branch (filter2 4 outputs, dfilt2 and dfilt 2 groups of 2:
//   st_col_groups), loads the rows its window needs once and adds each into
//   every output of every branch that it reaches; each output vector is
//   written once.
// * Rows (inner = 1): a block stages a flat range of the input with
//   cp.async; a thread item is GV groups (16 bytes of outputs a branch)
//   from one register window feeding every branch, each branch stored as
//   a vector where its output row allows.  Only windows that cross a row's
//   end reflect.  With one branch the window is read in 16-byte vectors
//   where it starts on one: a warp's windows are 4 GV samples apart, and
//   its scalar loads met in a quarter of the banks or fewer (8-way
//   conflicts in f32), which held dfilt's rows at 44% of its bound.
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
// RV ..) + RV - 1 of each of the NB branches, TY = threads / TX.
template <typename T, int P, int MT, int VC, int NB>
__global__ void __launch_bounds__(ST_THREADS)
    ana_cols(const T* __restrict__ x, T* __restrict__ y0,
             T* __restrict__ y1, int n_in, int inner, int g0n, int g1n,
             int side, int refl, int lgTX, int n_rt, int n_ct,
             const __grid_constant__
             HsTaps<typename AccOf<T>::type, P, NB> tp) {
  using A = typename AccOf<T>::type;
  constexpr int RV = st_col_groups<P, 1, NB>();
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

  A acc[NB][RV][P][VC];
#pragma unroll
  for (int b = 0; b < NB; ++b)
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
#pragma unroll
      for (int b = 0; b < NB; ++b)
        st_fir<A, MT, RV, VC>(acc[b], r, tp.t[b][0], w);
    }
  } else {
#pragma unroll
    for (int r = 0; r < 2 * RV + MT - 2; ++r) {
      A e[VC], od[VC];
      st_load_row<T, A, VC>(xp, j0 + 2 * r, n_in, inner, refl, e);
      st_load_row<T, A, VC>(xp, j0 + 2 * r + 1, n_in, inner, refl, od);
#pragma unroll
      for (int b = 0; b < NB; ++b)
        st_fir_dec<A, MT, RV, VC>(acc[b], r, tp.t[b], e, od);
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
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
// end[b] - 1 of each row go to y[b] (rows of P g[b]), b < NB.
template <typename T, int NB> struct AnaRowTile {
  const T* xs;
  T* y[NB];
  int64_t o0;
  int s0, n_in, refl, j00;  // j00: group s0's window start
  int base, lo, hi;
  int end[NB], g[NB];
  bool vec_out[NB];
};

// dfilt: add taps m0 .. m0 + M - 1 of a branch, t[p][m] of parity p, over
// the window w of GV groups (group v, parity p, tap m: sample 4 v + p + 2
// (m - m0)) into acc[2 v + p].
template <typename A, int GV, int M, int NW, typename Taps>
__device__ __forceinline__ void ana_dec_taps(A (&acc)[2 * GV], const Taps& t,
                                             int m0, const A (&w)[NW]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const A tk = t[p][m0 + m];
#pragma unroll
      for (int v = 0; v < GV; ++v) acc[2 * v + p] += tk * w[4 * v + p + 2 * m];
    }
}

// Groups s0 + q GV .. + GV - 1 of staged row r, every branch from one
// register window.  FAST: the window lies inside the row.
template <typename T, int P, int MT, int NB, bool FAST>
__device__ __forceinline__ void ana_rows_item(
    const AnaRowTile<T, NB>& tl,
    const HsTaps<typename AccOf<T>::type, P, NB>& tp, int r, int q) {
  using A = typename AccOf<T>::type;
  constexpr int D = st_step<P>();
  constexpr int GV = st_row_groups<T, P>();
  constexpr int NW = st_span<P, MT>(GV);  // an item's window samples
  constexpr int V = vec16<T>();
  const int j0 = tl.j00 + D * GV * q;
  const int rbase = tl.base + r * tl.n_in;
  const int gq = tl.s0 + GV * q;
  // one branch: 16-byte window loads (a warp's scalar loads of windows 4
  // GV samples apart would meet in a quarter of the banks); above tap
  // bound ST_ROW_CHUNK_ABOVE the window in chunks of st_row_chunk taps, a
  // loop that is not unrolled (the whole window held the registers of
  // two blocks an SM in float32, one in float64)
  constexpr bool CHUNKED = NB == 1 && P == 2 && MT > ST_ROW_CHUNK_ABOVE;
  A w[CHUNKED ? 1 : NW];
  if constexpr (!CHUNKED)
    st_row_window<T, A, NW, FAST, NB == 1>(tl.xs, rbase, j0, tl.n_in,
                                           tl.refl, tl.lo, tl.hi, w);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
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
      if constexpr (CHUNKED) {
        constexpr int CH = st_row_chunk<A, P>(), NC = st_span<P, CH>(GV);
        constexpr int R = MT % CH, NR = st_span<P, R>(GV);
#pragma unroll 1
        for (int c = 0; c < MT / CH; ++c) {
          A wc[NC];
          st_row_window<T, A, NC, FAST, true>(tl.xs, rbase, j0 + 2 * CH * c,
                                              tl.n_in, tl.refl, tl.lo,
                                              tl.hi, wc);
          ana_dec_taps<A, GV, CH>(acc, tp.t[b], CH * c, wc);
        }
        if constexpr (R > 0) {
          A wr[NR];
          st_row_window<T, A, NR, FAST, true>(
              tl.xs, rbase, j0 + 2 * (MT - R), tl.n_in, tl.refl, tl.lo,
              tl.hi, wr);
          ana_dec_taps<A, GV, R>(acc, tp.t[b], MT - R, wr);
        }
      } else {
        ana_dec_taps<A, GV, MT>(acc, tp.t[b], 0, w);
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
// .. + R - 1; segment s covers groups [s L, s L + L) of gn = max(g_0, g_1)
// (st_row_block).
template <typename T, int P, int MT, int NB>
__global__ void __launch_bounds__(ST_THREADS)
    ana_rows(const T* __restrict__ x, T* __restrict__ y0,
             T* __restrict__ y1, int outer, int n_in, int g0n, int g1n,
             int side, int refl, int R, int L, int n_seg,
             const __grid_constant__
             HsTaps<typename AccOf<T>::type, P, NB> tp) {
  constexpr int GV = st_row_groups<T, P>();
  constexpr int V = vec16<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);

  const int gn = g0n > g1n ? g0n : g1n;
  const StRowBlock bk = st_row_block<P, MT>(outer, n_in, gn, side, R, L,
                                            n_seg);
  int pad[1];
  st_stage_rows<T, 1>(x, nullptr, xs, 0, n_in, bk, pad);

  auto vec_ok = [&](const T* y, int g) {
    return (P * g) % V == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  };
  const int end = bk.s0 + bk.lr;
  AnaRowTile<T, NB> tl{xs, {}, bk.o0, bk.s0, n_in, refl, bk.j00,
                       pad[0] - bk.sa, pad[0], pad[0] + bk.len - 1};
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int g = b ? g1n : g0n;
    tl.y[b] = b ? y1 : y0;
    tl.end[b] = g < end ? g : end;
    tl.g[b] = g;
    tl.vec_out[b] = vec_ok(tl.y[b], g);
  }
  st_row_items<P, MT, GV>(bk, n_in, [&](int r, int q, auto fast) {
    ana_rows_item<T, P, MT, NB, decltype(fast)::value>(tl, tp, r, q);
  });
}

// The instance of tap bound MT, if the host's tiling is one it runs.
template <typename T, int P, int MT, int NB>
cudaError_t run_ana(const T* x, T* y0, T* y1, int outer, int n_in,
                    int inner, int g0n, int g1n, int side, int refl,
                    const HsTaps<typename AccOf<T>::type, P, NB>& tp,
                    const StTile& t, cudaStream_t st) {
  const int gn = g0n > g1n ? g0n : g1n;
  if (t.path == 0) {  // rows
    int n_seg, rb;
    if (!st_rows_tile<T, P, MT>(t, inner, n_in, gn, 1, &n_seg, &rb))
      return cudaErrorInvalidValue;
    const int64_t blocks =
        (static_cast<int64_t>(outer) + t.rows - 1) / t.rows * n_seg;
    return st_launch(ana_rows<T, P, MT, NB>, blocks, t.smem, st, x, y0, y1,
                     outer, n_in, g0n, g1n, side, refl, t.rows, t.seg, n_seg,
                     tp);
  }
  int lgTX;
  if (!st_cols_tile<P, 1, NB>(t, inner, &lgTX)) return cudaErrorInvalidValue;
  const int n_rt = (gn + t.seg - 1) / t.seg;
  const int64_t n_ct = (static_cast<int64_t>(inner) + t.tx * t.vc - 1) /
                       (static_cast<int64_t>(t.tx) * t.vc);
  const int64_t blocks = static_cast<int64_t>(outer) * n_rt * n_ct;
  if (t.vc == 1)
    return st_launch(ana_cols<T, P, MT, 1, NB>, blocks, 0, st, x, y0, y1,
                     n_in, inner, g0n, g1n, side, refl, lgTX, n_rt,
                     static_cast<int>(n_ct), tp);
  constexpr int VC = col_vec<T>();
  const uintptr_t align = VC * sizeof(T);
  if (t.vc != VC || inner % VC ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y0) |
       reinterpret_cast<uintptr_t>(y1)) % align)
    return cudaErrorInvalidValue;
  return st_launch(ana_cols<T, P, MT, VC, NB>, blocks, 0, st, x, y0, y1,
                   n_in, inner, g0n, g1n, side, refl, lgTX, n_rt,
                   static_cast<int>(n_ct), tp);
}

// The plans' taps at the least tap bound of the instance set that holds
// them (dfilt's by parity), which must be the host's; then that instance.
template <typename T, int P, int NB>
cudaError_t dispatch_ana_mt(const void* x, void* y0, void* y1, int outer,
                            int n_in, int inner, int g0n, int g1n, int side,
                            int refl, const double* taps, const int* lens,
                            const int* offs, const StTile& t,
                            cudaStream_t st) {
  using A = typename AccOf<T>::type;
  HsTaps<A, P, NB> tp{};
  const int mt = st_fill_taps<A, P, NB>(&tp, taps, lens, offs);
  if (!mt || mt != t.mt) return cudaErrorInvalidValue;
  hs_taps_by_parity(&tp);
  const T* xt = static_cast<const T*>(x);
  T* y0t = static_cast<T*>(y0);
  T* y1t = static_cast<T*>(y1);
#define DTCWT_RUN_ANA(E)                                                     \
  if (mt == st_bound<P>(E))                                                  \
  return run_ana<T, P, st_bound<P>(E), NB>(xt, y0t, y1t, outer, n_in,       \
                                           inner, g0n, g1n, side, refl, tp, \
                                           t, st)
  DTCWT_RUN_ANA(0);
  DTCWT_RUN_ANA(1);
  DTCWT_RUN_ANA(2);
  DTCWT_RUN_ANA(3);
  DTCWT_RUN_ANA(4);
#undef DTCWT_RUN_ANA
  return cudaErrorInvalidValue;
}

// NB = 1: one branch, written to y0 (y1 null, g1n = g0n).
template <int P, int NB>
int dispatch_ana(const void* x, void* y0, void* y1, int outer, int n_in,
                 int inner, int g0n, int g1n, int side, int refl,
                 const double* taps, const int* lens, const int* offs,
                 int dtype, const StTile& t, void* stream) {
  if (outer < 1 || n_in < 1 || inner < 1 || g0n < 1 || g1n < 1 ||
      side < 0 || (refl != 0 && refl != 1) || (refl && side) ||
      (NB == 1 && (y1 || g1n != g0n)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return dispatch_ana_mt<float, P, NB>(x, y0, y1, outer, n_in, inner,
                                           g0n, g1n, side, refl, taps, lens,
                                           offs, t, st);
    case DT_BF16:
      return dispatch_ana_mt<__nv_bfloat16, P, NB>(
          x, y0, y1, outer, n_in, inner, g0n, g1n, side, refl, taps, lens,
          offs, t, st);
    case DT_F64:
      return dispatch_ana_mt<double, P, NB>(x, y0, y1, outer, n_in, inner,
                                            g0n, g1n, side, refl, taps, lens,
                                            offs, t, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace dtcwt

// C interface of the two analysis entries of dual.cu.  x: the input viewed
// as [outer, n_in, inner]; y0, y1: [outer, P g0, inner] and [outer, P g1,
// inner] (dfilt g0 = g1).  side: the extension of a pre-extended buffer
// (refl = 0), or 0 with refl = 1 (x read at symmetric reflection of the
// length-n_in axis).  taps: host float64 [2 branches][P streams][MAX_TAPS];
// lens, offs: host [2][P], the plans' offsets without the side.  mt ..
// smem: the host's tiling (StTile), refused unless the instance runs it.
// Returns the launch's CUDA error code.
#define DTCWT_ANA_EXPORT(name, P)                                           \
  extern "C" int name(const void* x, void* y0, void* y1, int outer,         \
                      int n_in, int inner, int g0, int g1, int side,        \
                      int refl, const double* taps, const int* lens,        \
                      const int* offs, int dtype, int mt, int path, int v,  \
                      int vc, int rows, int seg, int tx, int smem,          \
                      void* stream) {                                       \
    return dtcwt::dispatch_ana<P, 2>(                                       \
        x, y0, y1, outer, n_in, inner, g0, g1, side, refl, taps, lens,      \
        offs, dtype, dtcwt::StTile{mt, path, v, vc, rows, seg, tx, smem},   \
        stream);                                                            \
  }

// C interface of a one-branch analysis entry (single.cu's dfilt): as
// DTCWT_ANA_EXPORT with the one output y [outer, P g, inner], taps host
// float64 [1][P][MAX_TAPS], lens and offs [P].
#define DTCWT_ANA1_EXPORT(name, P)                                          \
  extern "C" int name(const void* x, void* y, int outer, int n_in,          \
                      int inner, int g, int side, int refl,                 \
                      const double* taps, const int* lens, const int* offs, \
                      int dtype, int mt, int path, int v, int vc, int rows, \
                      int seg, int tx, int smem, void* stream) {            \
    return dtcwt::dispatch_ana<P, 1>(                                       \
        x, y, nullptr, outer, n_in, inner, g, g, side, refl, taps, lens,    \
        offs, dtype, dtcwt::StTile{mt, path, v, vc, rows, seg, tx, smem},   \
        stream);                                                            \
  }
