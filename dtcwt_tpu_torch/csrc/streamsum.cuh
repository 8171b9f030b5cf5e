// The synthesis kernels of the stream plans, along any axis of a
// contiguous tensor (CUDA C++, sm_90a): dual.cu's two sums, NIN = 2 inputs,
//
//   filter2_sum  y = filter(a, h0) + filter(b, h1)          (P = 1)
//   ifilt2_sum   y = ifilt(a, *p0) + ifilt(b, *p1), n -> 2n  (P = 4)
//
// and single.cu's one-input entry, NIN = 1,
//
//   ifilt        y = ifilt(a, ha, hb), n -> 2n               (P = 4)
//
// [outer, n_in, inner] NIN times -> [outer, P g, inner]: filter g = n + 1
// - m % 2 outputs, ifilt g = n / 2 groups of its four streams
// (ilevel2.ifilt_streams).  Replace _build_filter2_sum and
// _build_ifilt2_sum of dtcwt_tpu/ops/pallas_dual.py (entries
// filter2_sum_axis, ifilt2_sum_axis and their *_fromext_axis forms) and
// _build_ifilt of dtcwt_tpu/ops/pallas_fb.py (ifilt_axis,
// ifilt_fromext_axis).
//
// Bound on the H100: device memory bytes.  Each output costs (m0 + m1) /
// P multiply-adds (one input: m / P) against 12 bytes moved in float32
// (ifilt2_sum 8, ifilt 6), far under the card's ~20 float32 operations per
// byte.  What held the first port (a stream-plan kernel with a sample a
// staging item and the taps in shared memory) at 21-38% of that bound was
// the work it issued per byte: a sample a staging item, reflected and
// converted, with about one load in flight a thread; the taps converted
// from a float64 table into shared memory by every block and read from
// there, two shared loads a multiply-add, in loops of run-time length;
// every output row re-reading its window of each input from shared
// memory, its stream found by a division.  This design is filter.cu's, for
// NIN inputs whose branch sum stays in registers (the pieces are
// streamtile.cuh's):
//
// * Taps by value in the kernel's parameters (HsTaps of taps.cuh, a branch
//   an input) under a compile-time bound MT the host chooses (filter 5, 7,
//   9, 19 or 33; ifilt 5, 7, 9, 17 or 33; every dtype), centred on a common
//   halo: every tap loop runs to MT with register indices and no guard, the
//   taps past a filter's own reach being zero.  The largest bounds hold
//   every filter the plans take: 32 taps of either parity, qshift pairs of
//   64.
// * ifilt reads every other sample: its window starts on an even sample,
//   so that a sample's parity is its index's, and each branch's swap
//   (the stream order of ifilt_streams, set by the sign of sum(ha hb) and
//   m/2 % 2) selects which parity feeds the even streams.
// * Columns (inner > 1): a thread owns VC columns and RV groups (filter2_sum
//   8 outputs, ifilt2_sum 4 groups of 4, ifilt 2: st_col_groups), loads
//   the rows of each input that its window needs once and adds each into
//   every output it reaches: the branches in one set of accumulators, each
//   output written once.
// * Rows (inner = 1): a block stages a flat range of each input with
//   cp.async; a thread item is GV groups (16 bytes of outputs) from a
//   register window of each input, stored as vectors where the output row
//   allows.  Only windows that cross a row's end reflect.
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
// RV ..) + RV - 1, TY = threads / TX.  NIN = 1: the input a alone (b
// null).
template <typename T, int P, int MT, int VC, int NIN>
__global__ void __launch_bounds__(ST_THREADS)
    sum_cols(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ y, int n_in, int inner, int g, int side,
             int refl, int lgTX, int n_rt, int n_ct,
             const __grid_constant__
             HsTaps<typename AccOf<T>::type, P, NIN> tp) {
  using A = typename AccOf<T>::type;
  constexpr int RV = st_col_groups<P, NIN, NIN>();
  constexpr int D = st_step<P>();
  constexpr int PH = (MT - 1) / 2;
  const int tid = threadIdx.x;
  const int tx = tid & ((1 << lgTX) - 1), ty = tid >> lgTX;
  const int ct = static_cast<int>(blockIdx.x % n_ct);
  const int rt = static_cast<int>((blockIdx.x / n_ct) % n_rt);
  const int64_t o = blockIdx.x / (static_cast<int64_t>(n_ct) * n_rt);
  const int col = ((ct << lgTX) + tx) * VC;
  const int g0 = (rt * (ST_THREADS >> lgTX) + ty) * RV;
  if (col >= inner || g0 >= g) return;
  const int64_t x0 = o * n_in * static_cast<int64_t>(inner) + col;
  const T* xa = a + x0;
  const T* xb = NIN == 2 ? b + x0 : nullptr;
  const int j0 = D * (g0 - PH) + side;  // the window's first sample

  A acc[RV][P][VC];
#pragma unroll
  for (int v = 0; v < RV; ++v)
#pragma unroll
    for (int s = 0; s < P; ++s)
#pragma unroll
      for (int u = 0; u < VC; ++u) acc[v][s][u] = 0;
  if constexpr (P == 1) {
#pragma unroll
    for (int r = 0; r < RV + MT - 1; ++r) {
      A va[VC], vb[VC];
      st_load_row<T, A, VC>(xa, j0 + r, n_in, inner, refl, va);
      if constexpr (NIN == 2)
        st_load_row<T, A, VC>(xb, j0 + r, n_in, inner, refl, vb);
      st_fir<A, MT, RV, VC>(acc, r, tp.t[0][0], va);
      if constexpr (NIN == 2) st_fir<A, MT, RV, VC>(acc, r, tp.t[1][0], vb);
    }
  } else {
#pragma unroll
    for (int r = 0; r < RV + MT - 1; ++r) {
      A ea[VC], oa[VC], eb[VC], ob[VC];
      st_load_row<T, A, VC>(xa, j0 + 2 * r, n_in, inner, refl, ea);
      st_load_row<T, A, VC>(xa, j0 + 2 * r + 1, n_in, inner, refl, oa);
      if constexpr (NIN == 2) {
        st_load_row<T, A, VC>(xb, j0 + 2 * r, n_in, inner, refl, eb);
        st_load_row<T, A, VC>(xb, j0 + 2 * r + 1, n_in, inner, refl, ob);
      }
      st_fir_pairs<A, MT, RV, VC>(acc, r, tp.t[0], tp.sw[0], ea, oa);
      if constexpr (NIN == 2)
        st_fir_pairs<A, MT, RV, VC>(acc, r, tp.t[1], tp.sw[1], eb, ob);
    }
  }
  T* out = y + (o * g + g0) * static_cast<int64_t>(P) * inner + col;
#pragma unroll
  for (int v = 0; v < RV; ++v)
    if (g0 + v < g) {
#pragma unroll
      for (int s = 0; s < P; ++s)
        store_pack<T, A, VC>(out + static_cast<int64_t>(P * v + s) * inner,
                             acc[v][s]);
    }
}

// One rows-path block's staged inputs: input i's in-row sample j of
// staged row r is xs[base_i + r n_in + j], its cells [lo_i, hi_i], i <
// NIN; the block's groups s0 .. end - 1 of each row go to y (rows of P g).
template <typename T, int NIN> struct SumRowTile {
  const T* xs;
  T* y;
  int64_t o0;
  int s0, end, n_in, g, refl, j00;  // j00: group s0's window start
  int base[NIN], lo[NIN], hi[NIN];
  bool vec_out;
};

// ifilt: add pairs m0 .. m0 + M - 1 of a branch's taps t[s][m] over the
// window w of GV groups (pair k: samples 2 k, 2 k + 1 of w, group v and
// tap m reading pair v + m - m0) into acc[4 v + s], the parity windows
// selected by the branch's swap sw.
template <typename A, int GV, int M, int NW, typename Taps>
__device__ __forceinline__ void sum_pair_taps(A (&acc)[4 * GV],
                                              const Taps& t, int sw, int m0,
                                              const A (&w)[NW]) {
  // the parity windows: wa feeds the even streams, wb the odd ones
  A wa[GV + M - 1], wb[GV + M - 1];
#pragma unroll
  for (int k = 0; k < GV + M - 1; ++k) {
    wa[k] = sw ? w[2 * k + 1] : w[2 * k];
    wb[k] = sw ? w[2 * k] : w[2 * k + 1];
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const A tk = t[s][m0 + m];
#pragma unroll
      for (int v = 0; v < GV; ++v)
        acc[4 * v + s] += tk * (s & 1 ? wb : wa)[v + m];
    }
}

// Groups s0 + q GV .. + GV - 1 of staged row r from a register window of
// each input.  FAST: every window lies inside the row.
template <typename T, int P, int MT, int NIN, bool FAST>
__device__ __forceinline__ void sum_rows_item(
    const SumRowTile<T, NIN>& tl,
    const HsTaps<typename AccOf<T>::type, P, NIN>& tp, int r, int q) {
  using A = typename AccOf<T>::type;
  constexpr int D = st_step<P>();
  constexpr int GV = st_row_groups<T, P>();
  constexpr int NW = st_span<P, MT>(GV);  // an item's window samples
  constexpr int V = vec16<T>();
  // one float64 input above tap bound ST_ROW_CHUNK_ABOVE: the window in
  // chunks of st_row_chunk taps, a loop that is not unrolled (the whole
  // window held the registers of one block an SM; float32 ran faster
  // unchunked)
  constexpr bool CHUNKED = NIN == 1 && P == 4 && sizeof(A) == 8 &&
                           MT > ST_ROW_CHUNK_ABOVE;
  const int j0 = tl.j00 + D * GV * q;
  A acc[GV * P];
#pragma unroll
  for (int i = 0; i < GV * P; ++i) acc[i] = 0;
#pragma unroll
  for (int bb = 0; bb < NIN; ++bb) {
    const int rbase = tl.base[bb] + r * tl.n_in;
    if constexpr (CHUNKED) {
      constexpr int CH = st_row_chunk<A, P>(), NC = st_span<P, CH>(GV);
      constexpr int R = MT % CH, NR = st_span<P, R>(GV);
#pragma unroll 1
      for (int c = 0; c < MT / CH; ++c) {
        A wc[NC];
        st_row_window<T, A, NC, FAST>(tl.xs, rbase, j0 + 2 * CH * c,
                                      tl.n_in, tl.refl, tl.lo[bb],
                                      tl.hi[bb], wc);
        sum_pair_taps<A, GV, CH>(acc, tp.t[bb], tp.sw[bb], CH * c, wc);
      }
      if constexpr (R > 0) {
        A wr[NR];
        st_row_window<T, A, NR, FAST>(tl.xs, rbase, j0 + 2 * (MT - R),
                                      tl.n_in, tl.refl, tl.lo[bb],
                                      tl.hi[bb], wr);
        sum_pair_taps<A, GV, R>(acc, tp.t[bb], tp.sw[bb], MT - R, wr);
      }
    } else {
      A w[NW];
      st_row_window<T, A, NW, FAST>(tl.xs, rbase, j0, tl.n_in, tl.refl,
                                    tl.lo[bb], tl.hi[bb], w);
      if constexpr (P == 1) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const A tk = tp.t[bb][0][m];
#pragma unroll
          for (int v = 0; v < GV; ++v) acc[v] += tk * w[v + m];
        }
      } else {
        sum_pair_taps<A, GV, MT>(acc, tp.t[bb], tp.sw[bb], 0, w);
      }
    }
  }
  const int gq = tl.s0 + GV * q;
  T* out = tl.y + (tl.o0 + r) * static_cast<int64_t>(P) * tl.g + P * gq;
  const int nv = P * (tl.end - gq < GV ? tl.end - gq : GV);
  if (tl.vec_out && nv == GV * P) {
#pragma unroll
    for (int e = 0; e < GV * P / V; ++e)
      store_pack<T, A, V>(out + e * V, acc + e * V);
  } else {
#pragma unroll
    for (int i = 0; i < GV * P; ++i)
      if (i < nv) store(out + i, acc[i]);
  }
}

// Rows path (inner = 1).  Block b: segment b % n_seg of rows (b / n_seg) R
// .. + R - 1; segment s covers groups [s L, s L + L) (st_row_block).  The
// staged regions of the NIN inputs are rb values apart.
template <typename T, int P, int MT, int NIN>
__global__ void __launch_bounds__(ST_THREADS)
    sum_rows(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ y, int outer, int n_in, int g, int side,
             int refl, int R, int L, int n_seg, int rb,
             const __grid_constant__
             HsTaps<typename AccOf<T>::type, P, NIN> tp) {
  constexpr int GV = st_row_groups<T, P>();
  constexpr int V = vec16<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [NIN][rb]

  const StRowBlock bk = st_row_block<P, MT>(outer, n_in, g, side, R, L,
                                            n_seg);
  int pad[NIN];
  st_stage_rows<T, NIN>(a, b, xs, rb, n_in, bk, pad);

  SumRowTile<T, NIN> tl{xs, y, bk.o0, bk.s0, bk.s0 + bk.lr, n_in, g, refl,
                        bk.j00};
#pragma unroll
  for (int i = 0; i < NIN; ++i) {
    tl.base[i] = i * rb + pad[i] - bk.sa;
    tl.lo[i] = i * rb + pad[i];
    tl.hi[i] = i * rb + pad[i] + bk.len - 1;
  }
  tl.vec_out = (P * g) % V == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  st_row_items<P, MT, GV>(bk, n_in, [&](int r, int q, auto fast) {
    sum_rows_item<T, P, MT, NIN, decltype(fast)::value>(tl, tp, r, q);
  });
}

// The instance of tap bound MT, if the host's tiling is one it runs.
template <typename T, int P, int MT, int NIN>
cudaError_t run_sum(const T* a, const T* b, T* y, int outer, int n_in,
                    int inner, int g, int side, int refl,
                    const HsTaps<typename AccOf<T>::type, P, NIN>& tp,
                    const StTile& t, cudaStream_t st) {
  if (t.path == 0) {  // rows
    int n_seg, rb;
    if (!st_rows_tile<T, P, MT>(t, inner, n_in, g, NIN, &n_seg, &rb))
      return cudaErrorInvalidValue;
    const int64_t blocks =
        (static_cast<int64_t>(outer) + t.rows - 1) / t.rows * n_seg;
    return st_launch(sum_rows<T, P, MT, NIN>, blocks, t.smem, st, a, b, y,
                     outer, n_in, g, side, refl, t.rows, t.seg, n_seg, rb,
                     tp);
  }
  int lgTX;
  if (!st_cols_tile<P, NIN, NIN>(t, inner, &lgTX))
    return cudaErrorInvalidValue;
  const int n_rt = (g + t.seg - 1) / t.seg;
  const int64_t n_ct = (static_cast<int64_t>(inner) + t.tx * t.vc - 1) /
                       (static_cast<int64_t>(t.tx) * t.vc);
  const int64_t blocks = static_cast<int64_t>(outer) * n_rt * n_ct;
  if (t.vc == 1)
    return st_launch(sum_cols<T, P, MT, 1, NIN>, blocks, 0, st, a, b, y,
                     n_in, inner, g, side, refl, lgTX, n_rt,
                     static_cast<int>(n_ct), tp);
  constexpr int VC = col_vec<T>();
  const uintptr_t align = VC * sizeof(T);
  if (t.vc != VC || inner % VC ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(y)) % align)
    return cudaErrorInvalidValue;
  return st_launch(sum_cols<T, P, MT, VC, NIN>, blocks, 0, st, a, b, y,
                   n_in, inner, g, side, refl, lgTX, n_rt,
                   static_cast<int>(n_ct), tp);
}

// The plans' taps at the least tap bound of the instance set that holds
// them, which must be the host's; then that instance.
template <typename T, int P, int NIN>
cudaError_t dispatch_sum_mt(const void* a, const void* b, void* y, int outer,
                            int n_in, int inner, int g, int side, int refl,
                            const double* taps, const int* lens,
                            const int* offs, const StTile& t,
                            cudaStream_t st) {
  using A = typename AccOf<T>::type;
  HsTaps<A, P, NIN> tp{};
  const int mt = st_fill_taps<A, P, NIN>(&tp, taps, lens, offs);
  if (!mt || mt != t.mt) return cudaErrorInvalidValue;
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  T* yt = static_cast<T*>(y);
#define DTCWT_RUN_SUM(E)                                                     \
  if (mt == st_bound<P>(E))                                                  \
  return run_sum<T, P, st_bound<P>(E), NIN>(at, bt, yt, outer, n_in, inner, \
                                            g, side, refl, tp, t, st)
  DTCWT_RUN_SUM(0);
  DTCWT_RUN_SUM(1);
  DTCWT_RUN_SUM(2);
  DTCWT_RUN_SUM(3);
  DTCWT_RUN_SUM(4);
#undef DTCWT_RUN_SUM
  return cudaErrorInvalidValue;
}

// NIN = 1: the input a alone (b null).
template <int P, int NIN>
int dispatch_sum(const void* a, const void* b, void* y, int outer, int n_in,
                 int inner, int g, int side, int refl, const double* taps,
                 const int* lens, const int* offs, int dtype,
                 const StTile& t, void* stream) {
  if (outer < 1 || n_in < 1 || inner < 1 || g < 1 || side < 0 ||
      (refl != 0 && refl != 1) || (refl && side) || (NIN == 1 && b))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return dispatch_sum_mt<float, P, NIN>(a, b, y, outer, n_in, inner, g,
                                            side, refl, taps, lens, offs, t,
                                            st);
    case DT_BF16:
      return dispatch_sum_mt<__nv_bfloat16, P, NIN>(
          a, b, y, outer, n_in, inner, g, side, refl, taps, lens, offs, t,
          st);
    case DT_F64:
      return dispatch_sum_mt<double, P, NIN>(a, b, y, outer, n_in, inner, g,
                                             side, refl, taps, lens, offs, t,
                                             st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace dtcwt

// C interface of the two sums of dual.cu.  a, b: the inputs viewed as
// [outer, n_in, inner]; y: [outer, P g, inner].  side: the extension of a
// pre-extended buffer (refl = 0), or 0 with refl = 1 (x read at symmetric
// reflection of the length-n_in axis).  taps: host float64 [2 branches][P
// streams][MAX_TAPS]; lens, offs: host [2][P], the plans' offsets without
// the side.  mt .. smem: the host's tiling (StTile), refused unless the
// instance runs it.  Returns the launch's CUDA error code.
#define DTCWT_SUM_EXPORT(name, P)                                           \
  extern "C" int name(const void* a, const void* b, void* y, int outer,     \
                      int n_in, int inner, int g, int side, int refl,       \
                      const double* taps, const int* lens, const int* offs, \
                      int dtype, int mt, int path, int v, int vc, int rows, \
                      int seg, int tx, int smem, void* stream) {            \
    return dtcwt::dispatch_sum<P, 2>(                                       \
        a, b, y, outer, n_in, inner, g, side, refl, taps, lens, offs,       \
        dtype, dtcwt::StTile{mt, path, v, vc, rows, seg, tx, smem},        \
        stream);                                                            \
  }

// C interface of a one-input entry (single.cu's ifilt): as
// DTCWT_SUM_EXPORT with the one input x, taps host float64 [1][P][MAX_TAPS],
// lens and offs [P].
#define DTCWT_SUM1_EXPORT(name, P)                                          \
  extern "C" int name(const void* x, void* y, int outer, int n_in,          \
                      int inner, int g, int side, int refl,                 \
                      const double* taps, const int* lens, const int* offs, \
                      int dtype, int mt, int path, int v, int vc, int rows, \
                      int seg, int tx, int smem, void* stream) {            \
    return dtcwt::dispatch_sum<P, 1>(                                       \
        x, nullptr, y, outer, n_in, inner, g, side, refl, taps, lens, offs, \
        dtype, dtcwt::StTile{mt, path, v, vc, rows, seg, tx, smem},        \
        stream);                                                            \
  }
