// The synthesis sums of dual.cu, along any axis of a contiguous tensor
// (CUDA C++, sm_90a):
//
//   filter2_sum  y = filter(a, h0) + filter(b, h1)          (P = 1)
//   ifilt2_sum   y = ifilt(a, *p0) + ifilt(b, *p1), n -> 2n  (P = 4)
//
// [outer, n_in, inner] twice -> [outer, P g, inner]: filter g = n + 1 - m
// % 2 outputs, ifilt g = n / 2 groups of its four streams
// (ilevel2.ifilt_streams).  Replace _build_filter2_sum and
// _build_ifilt2_sum of dtcwt_tpu/ops/pallas_dual.py (entries
// filter2_sum_axis, ifilt2_sum_axis and their *_fromext_axis forms).
//
// Bound on the H100: device memory bytes.  Each output costs (m0 + m1) /
// P multiply-adds against 12 bytes moved in float32 (ifilt 8), far under
// the card's ~20 float32 operations per byte.  What held the first port
// (streams.cuh's stream_kernel) at 21-38% of that bound was the work it
// issued per byte: a sample a staging item, reflected and converted, with
// about one load in flight a thread; the taps converted from a float64
// table into shared memory by every block and read from there, two shared
// loads a multiply-add, in loops of run-time length; every output row
// re-reading its window of both inputs from shared memory, its stream
// found by a division.  This design is filter.cu's, for two inputs whose
// branch sum stays in registers (the pieces are streamtile.cuh's):
//
// * Taps by value in the kernel's parameters (HsTaps of taps.cuh) under a
//   compile-time bound MT the host chooses (filter 5, 7, 9, 19 or 33; ifilt
//   5, 7, 9, 17 or 33; every dtype), centred on a common halo: every tap
//   loop runs to MT with register indices and no guard, the taps past a
//   filter's own reach being zero.  The largest bounds hold every filter
//   the plans take: 32 taps of either parity, qshift pairs of 64.
// * ifilt reads every other sample: its window starts on an even sample,
//   so that a sample's parity is its index's, and each branch's swap
//   (the stream order of ifilt_streams, set by the sign of sum(ha hb) and
//   m/2 % 2) selects which parity feeds the even streams.
// * Columns (inner > 1): a thread owns VC columns and RV groups (filter 8
//   outputs, ifilt 4 groups of 4), loads the rows of both inputs that its
//   window needs once and adds each into every output it reaches: the two
//   branches in one set of accumulators, each output written once.
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
// RV ..) + RV - 1, TY = threads / TX.
template <typename T, int P, int MT, int VC>
__global__ void __launch_bounds__(ST_THREADS)
    sum_cols(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ y, int n_in, int inner, int g, int side,
             int refl, int lgTX, int n_rt, int n_ct,
             const __grid_constant__ HsTaps<typename AccOf<T>::type, P> tp) {
  using A = typename AccOf<T>::type;
  constexpr int RV = st_col_groups<P, 2>();
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
  const T* xb = b + x0;
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
      st_load_row<T, A, VC>(xb, j0 + r, n_in, inner, refl, vb);
      st_fir<A, MT, RV, VC>(acc, r, tp.t[0][0], va);
      st_fir<A, MT, RV, VC>(acc, r, tp.t[1][0], vb);
    }
  } else {
#pragma unroll
    for (int r = 0; r < RV + MT - 1; ++r) {
      A ea[VC], oa[VC], eb[VC], ob[VC];
      st_load_row<T, A, VC>(xa, j0 + 2 * r, n_in, inner, refl, ea);
      st_load_row<T, A, VC>(xa, j0 + 2 * r + 1, n_in, inner, refl, oa);
      st_load_row<T, A, VC>(xb, j0 + 2 * r, n_in, inner, refl, eb);
      st_load_row<T, A, VC>(xb, j0 + 2 * r + 1, n_in, inner, refl, ob);
      st_fir_pairs<A, MT, RV, VC>(acc, r, tp.t[0], tp.sw[0], ea, oa);
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
// staged row r is xs[base_i + r n_in + j], its cells [lo_i, hi_i]; the
// block's groups s0 .. end - 1 of each row go to y (rows of P g).
template <typename T> struct SumRowTile {
  const T* xs;
  T* y;
  int64_t o0;
  int s0, end, n_in, g, refl, j00;  // j00: group s0's window start
  int base[2], lo[2], hi[2];
  bool vec_out;
};

// Groups s0 + q GV .. + GV - 1 of staged row r from a register window of
// each input.  FAST: both windows lie inside the row.
template <typename T, int P, int MT, bool FAST>
__device__ __forceinline__ void sum_rows_item(
    const SumRowTile<T>& tl, const HsTaps<typename AccOf<T>::type, P>& tp,
    int r, int q) {
  using A = typename AccOf<T>::type;
  constexpr int D = st_step<P>();
  constexpr int GV = st_row_groups<T, P>();
  constexpr int NW = D * (GV + MT - 1);  // an item's window samples
  constexpr int V = vec16<T>();
  const int j0 = tl.j00 + D * GV * q;
  A acc[GV * P];
#pragma unroll
  for (int i = 0; i < GV * P; ++i) acc[i] = 0;
#pragma unroll
  for (int bb = 0; bb < 2; ++bb) {
    A w[NW];
    st_row_window<T, A, NW, FAST>(tl.xs, tl.base[bb] + r * tl.n_in, j0,
                                  tl.n_in, tl.refl, tl.lo[bb], tl.hi[bb], w);
    if constexpr (P == 1) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const A tk = tp.t[bb][0][m];
#pragma unroll
        for (int v = 0; v < GV; ++v) acc[v] += tk * w[v + m];
      }
    } else {
      // the parity windows: wa feeds the even streams, wb the odd ones
      const int sw = tp.sw[bb];
      A wa[GV + MT - 1], wb[GV + MT - 1];
#pragma unroll
      for (int k = 0; k < GV + MT - 1; ++k) {
        wa[k] = sw ? w[2 * k + 1] : w[2 * k];
        wb[k] = sw ? w[2 * k] : w[2 * k + 1];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const A tk = tp.t[bb][s][m];
#pragma unroll
          for (int v = 0; v < GV; ++v)
            acc[4 * v + s] += tk * (s & 1 ? wb : wa)[v + m];
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
// .. + R - 1; segment s covers groups [s L, s L + L).  The staged regions
// of the two inputs are rb values apart.
template <typename T, int P, int MT>
__global__ void __launch_bounds__(ST_THREADS)
    sum_rows(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ y, int outer, int n_in, int g, int side,
             int refl, int R, int L, int n_seg, int rb,
             const __grid_constant__ HsTaps<typename AccOf<T>::type, P> tp) {
  constexpr int D = st_step<P>();
  constexpr int PH = (MT - 1) / 2;
  constexpr int GV = st_row_groups<T, P>();
  constexpr int NW = D * (GV + MT - 1);
  constexpr int V = vec16<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [2][rb]

  const int tid = threadIdx.x;
  const int s0 = static_cast<int>(blockIdx.x % n_seg) * L;
  const int64_t o0 = static_cast<int64_t>(blockIdx.x / n_seg) * R;
  const int rows = static_cast<int>(
      outer - o0 < static_cast<int64_t>(R) ? outer - o0 : R);
  const int lr = g - s0 < L ? g - s0 : L;  // groups of the tile a row

  // stage the flat range of each input from in-row sample sa of the first
  // row to sb of the last: the windows of groups s0 .. s0 + L - 1
  const int j00 = D * (s0 - PH) + side;
  const int sa = j00 > 0 ? j00 : 0;
  const int sb = j00 + D * (L + MT - 1) < n_in ? j00 + D * (L + MT - 1)
                                                : n_in;
  const int64_t f0 = o0 * n_in + sa;
  const int len = (rows - 1) * n_in + (sb - sa);
  const int pa = st_stage_flat(a + f0, xs, len);
  const int pb = st_stage_flat(b + f0, xs + rb, len);
  cp_async_wait_all();
  __syncthreads();

  const bool vec_out =
      (P * g) % V == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const SumRowTile<T> tl{xs, y, o0, s0, s0 + lr, n_in, g, refl, j00,
                         {pa - sa, rb + pb - sa},
                         {pa, rb + pb}, {pa + len - 1, rb + pb + len - 1},
                         vec_out};
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
    sum_rows_item<T, P, MT, true>(tl, tp, r, q_lo + it - r * ni);
  }
  for (int it = tid; it < rows * ne; it += ST_THREADS) {
    const int r = it / ne, k = it - r * ne;
    sum_rows_item<T, P, MT, false>(tl, tp, r,
                                   k < q_lo ? k : q_hi + k - q_lo);
  }
}

// The instance of tap bound MT, if the host's tiling is one it runs.
template <typename T, int P, int MT>
cudaError_t run_sum(const T* a, const T* b, T* y, int outer, int n_in,
                    int inner, int g, int side, int refl,
                    const HsTaps<typename AccOf<T>::type, P>& tp,
                    const StTile& t, cudaStream_t st) {
  if (t.path == 0) {  // rows
    int n_seg, rb;
    if (!st_rows_tile<T, P, MT>(t, inner, n_in, g, 2, &n_seg, &rb))
      return cudaErrorInvalidValue;
    const int64_t blocks =
        (static_cast<int64_t>(outer) + t.rows - 1) / t.rows * n_seg;
    return st_launch(sum_rows<T, P, MT>, blocks, t.smem, st, a, b, y, outer,
                     n_in, g, side, refl, t.rows, t.seg, n_seg, rb, tp);
  }
  int lgTX;
  if (!st_cols_tile<P, 2>(t, inner, &lgTX)) return cudaErrorInvalidValue;
  const int n_rt = (g + t.seg - 1) / t.seg;
  const int64_t n_ct = (static_cast<int64_t>(inner) + t.tx * t.vc - 1) /
                       (static_cast<int64_t>(t.tx) * t.vc);
  const int64_t blocks = static_cast<int64_t>(outer) * n_rt * n_ct;
  if (t.vc == 1)
    return st_launch(sum_cols<T, P, MT, 1>, blocks, 0, st, a, b, y, n_in,
                     inner, g, side, refl, lgTX, n_rt,
                     static_cast<int>(n_ct), tp);
  constexpr int VC = col_vec<T>();
  const uintptr_t align = VC * sizeof(T);
  if (t.vc != VC || inner % VC ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(y)) % align)
    return cudaErrorInvalidValue;
  return st_launch(sum_cols<T, P, MT, VC>, blocks, 0, st, a, b, y, n_in,
                   inner, g, side, refl, lgTX, n_rt, static_cast<int>(n_ct),
                   tp);
}

// The plans' taps at the least tap bound of the instance set that holds
// them, which must be the host's; then that instance.
template <typename T, int P>
cudaError_t dispatch_sum_mt(const void* a, const void* b, void* y, int outer,
                            int n_in, int inner, int g, int side, int refl,
                            const double* taps, const int* lens,
                            const int* offs, const StTile& t,
                            cudaStream_t st) {
  using A = typename AccOf<T>::type;
  HsTaps<A, P> tp{};
  const int mt = st_fill_taps<A, P>(&tp, taps, lens, offs);
  if (!mt || mt != t.mt) return cudaErrorInvalidValue;
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  T* yt = static_cast<T*>(y);
#define DTCWT_RUN_SUM(E)                                                     \
  if (mt == st_bound<P>(E))                                                  \
  return run_sum<T, P, st_bound<P>(E)>(at, bt, yt, outer, n_in, inner, g,   \
                                       side, refl, tp, t, st)
  DTCWT_RUN_SUM(0);
  DTCWT_RUN_SUM(1);
  DTCWT_RUN_SUM(2);
  DTCWT_RUN_SUM(3);
  DTCWT_RUN_SUM(4);
#undef DTCWT_RUN_SUM
  return cudaErrorInvalidValue;
}

template <int P>
int dispatch_sum(const void* a, const void* b, void* y, int outer, int n_in,
                 int inner, int g, int side, int refl, const double* taps,
                 const int* lens, const int* offs, int dtype,
                 const StTile& t, void* stream) {
  if (outer < 1 || n_in < 1 || inner < 1 || g < 1 || side < 0 ||
      (refl != 0 && refl != 1) || (refl && side))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return dispatch_sum_mt<float, P>(a, b, y, outer, n_in, inner, g, side,
                                       refl, taps, lens, offs, t, st);
    case DT_BF16:
      return dispatch_sum_mt<__nv_bfloat16, P>(a, b, y, outer, n_in, inner,
                                               g, side, refl, taps, lens,
                                               offs, t, st);
    case DT_F64:
      return dispatch_sum_mt<double, P>(a, b, y, outer, n_in, inner, g, side,
                                        refl, taps, lens, offs, t, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace dtcwt

// C interface of the two sums.  a, b: the inputs viewed as [outer, n_in,
// inner]; y: [outer, P g, inner].  side: the extension of a pre-extended
// buffer (refl = 0), or 0 with refl = 1 (x read at symmetric reflection of
// the length-n_in axis).  taps: host float64 [2 branches][P
// streams][MAX_TAPS]; lens, offs: host [2][P], the plans' offsets without
// the side.  mt .. smem: the host's tiling (StTile), refused unless the
// instance runs it.  Returns the launch's CUDA error code.
#define DTCWT_SUM_EXPORT(name, P)                                           \
  extern "C" int name(const void* a, const void* b, void* y, int outer,     \
                      int n_in, int inner, int g, int side, int refl,       \
                      const double* taps, const int* lens, const int* offs, \
                      int dtype, int mt, int path, int v, int vc, int rows, \
                      int seg, int tx, int smem, void* stream) {            \
    return dtcwt::dispatch_sum<P>(                                          \
        a, b, y, outer, n_in, inner, g, side, refl, taps, lens, offs,       \
        dtype, dtcwt::StTile{mt, path, v, vc, rows, seg, tx, smem},        \
        stream);                                                            \
  }
