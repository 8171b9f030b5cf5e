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
// operations past that.  So the design keeps the instructions that are
// not multiply-adds well under one per multiply-add, at any length:
//
// * The plan (ops/longfir.py _plan).  Every stream's taps are shifted onto
//   one window a branch (one for both branches of the analysis form, whose
//   input they share) and zero-padded to `chunks` chunks of LF_MT taps:
//   slot q = b P + sigma of branch b reads window sample D i + ph(sigma) +
//   S k, its phase ph(sigma) = sigma & 1 where S = 2 (0 where S = 1), and
//   holds output stream sigma ^ sw_b (the branch's swap).  A chunk is an
//   in-bound stream FIR of LF_MT taps: the loops over a chunk's taps,
//   outputs and window samples are unrolled with compile-time indices
//   (registers, no guard on the filter's length), and the filter's length
//   sets only how often the chunk loop runs: neither the registers nor the
//   shared memory grow with it.  At each chunk a thread loads the chunk's
//   taps of its slots into registers (uniform 16-byte loads through the
//   read-only cache); the accumulators stay in registers over all chunks.
// * Columns (inner > 1, lf_cols): a thread owns VC adjacent columns (a
//   16-byte vector, bfloat16 8 bytes, where inner and the pointers allow;
//   else one) and RV consecutive groups, 8 accumulators a column; 128
//   bytes of a row a warp's row of threads, the rest of the block's 256
//   threads down the axis.  At each chunk it loads the RV + LF_MT - 1 rows
//   (S = 2: row pairs) its window needs, once each, and adds each into
//   every output the row reaches: one tap register feeds RV x VC
//   multiply-adds.  A window inside the axis takes a path without folds.
// * Rows (inner = 1, lf_rows): a block takes a segment of `seg` groups of
//   `rows` outer rows (whole rows where they are short) and stages the
//   window samples of its segment into shared memory in the accumulator
//   type, the fold of the reflection computed once a staged sample (a
//   range inside the axis is copied with cp.async and not folded, a value
//   a copy: the staged window starts at the block's first window sample,
//   so that every thread's window starts on a 16-byte vector, which the
//   input's own alignment cannot give; bfloat16 is widened as it is
//   staged).  Each
//   thread then takes GV consecutive groups of one row from a register
//   window read in 16-byte vectors, its samples by phase at compile-time
//   indices, so that each sample feeds every stream of both branches.
//   The shared memory is bounded for any filter length: a staging round
//   holds the halo of at most `cr` chunks (ops/longfir.py _HALO samples);
//   past it the window is staged again for the next round of chunks,
//   double-buffered with cp.async (the next round's copies in flight
//   while the block computes one).  A thread has at most one item.
// * float32 and bfloat16 accumulate in float32, float64 in float64; each
//   output is written once.  The plan travels in LfArgs by value (named
//   fields, nothing indexed at run time).
#include <climits>

#include "common.cuh"

namespace dtcwt {
namespace {

constexpr int LF_THREADS = 256;
constexpr int LF_MT = 8;                 // taps a chunk
constexpr int LF_SMEM_MAX = 227 * 1024;  // dynamic shared memory a block

// Samples a group steps (D): filter 1, dfilt 4, ifilt 2.
template <int P> __host__ __device__ constexpr int lf_step() {
  return P == 1 ? 1 : P == 2 ? 4 : 2;
}
// Samples a tap steps (S): filter 1, the qshift streams 2.
template <int P> __host__ __device__ constexpr int lf_tap_step() {
  return P == 1 ? 1 : 2;
}
// Tap slots an input feeds (analysis: every branch's streams; sum: its
// branch's), which is also the accumulators of a group.
template <int P, int NB, bool SUM>
__host__ __device__ constexpr int lf_slots() {
  return SUM ? P : P * NB;
}
// Columns path: groups a thread, 8 accumulators a column.
template <int P, int NB, bool SUM>
__host__ __device__ constexpr int lf_col_groups() {
  return 8 / lf_slots<P, NB, SUM>();
}
// Rows path: groups a thread, whose windows start D GV samples apart: a
// multiple of a 16-byte vector of the accumulator type A (so that every
// window starts on one) and an odd number of vectors (so that the lanes'
// 16-byte shared loads hit distinct banks; float64 dfilt: two).  12, 3 and
// 6 ran faster than 20, 5 and 10 (PERF.md).
template <typename A, int P> __host__ __device__ constexpr int lf_row_groups() {
  return sizeof(A) == 8 ? (P == 1 ? 6 : 3) : (P == 1 ? 12 : P == 2 ? 3 : 6);
}
// The phase of slot q of P streams: the sample of a pair it reads.
template <int P> __host__ __device__ constexpr int lf_phase(int q) {
  return P == 1 ? 0 : (q % P) & 1;
}

// The launch, by value: view, groups, each input's window offset (the
// from-extension shift included), swaps, chunks of taps, and the tiling.
struct LfArgs {
  int64_t outer, inner;
  int n_in, refl;
  int g0, g1, gn;      // groups of each branch, and the larger
  int base0, base1;    // window sample of group 0, input / branch 0 and 1
  int sw0, sw1;        // each branch's swap of its streams
  int chunks, mp;      // chunks of taps, taps a slot (chunks LF_MT)
  int lg_tx, row_tiles, col_tiles;  // columns path
  int rows, seg, n_seg, cr, wp;     // rows path
};

// The value of output stream s from slot base + (s ^ sw) of P streams.
template <int P, typename A, int N, int NV>
__device__ __forceinline__ A lf_pick(const A (&acc)[N][NV], int base, int s,
                                     int sw, int u) {
  if constexpr (P == 1) {
    return acc[base][u];
  } else {
    return sw ? acc[base + (s ^ 1)][u] : acc[base + s][u];
  }
}

// 16 bytes of taps through the read-only cache.
__device__ __forceinline__ void lf_ld16(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void lf_ld16(const double* p, double (&v)[2]) {
  const double2 t = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = t.x;
  v[1] = t.y;
}

// Chunk c's taps of the NQ slots from q0 (mp a slot), 16-byte loads.
template <typename A, int NQ>
__device__ __forceinline__ void lf_taps(const A* __restrict__ taps, int q0,
                                        int mp, int c, A (&t)[NQ][LF_MT]) {
  constexpr int V = 16 / sizeof(A);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const A* p = taps + static_cast<int64_t>(q0 + q) * mp + c * LF_MT;
#pragma unroll
    for (int e = 0; e < LF_MT / V; ++e) {
      A pk[V];
      lf_ld16(p + e * V, pk);
#pragma unroll
      for (int u = 0; u < V; ++u) t[q][e * V + u] = pk[u];
    }
  }
}

// Columns path: the VC values of axis row j from the column pointer x
// (rows inner apart); FAST: j lies inside the axis, else it is folded
// (source()) and reads zero outside a pre-extended buffer.
template <bool FAST, typename T, typename A, int VC>
__device__ __forceinline__ void lf_row(const T* x, int j, int n_in,
                                       int64_t inner, int refl, A (&v)[VC]) {
  int jj = j;
  if constexpr (!FAST) jj = source(j, n_in, refl);
  const T* p = x + static_cast<int64_t>(jj < 0 ? 0 : jj) * inner;
  if constexpr (VC == 1) {
    v[0] = load(p);
  } else {
    load_pack<T, A, VC>(p, v);
  }
  if constexpr (!FAST) {
    if (jj < 0) {
#pragma unroll
      for (int u = 0; u < VC; ++u) v[u] = A(0);
    }
  }
}

// Columns path: one chunk of one input, its window from row jc: each of
// the window's rows (pairs where S = 2) loaded once and added into every
// output it reaches, acc[v][q] += t[q][k] x[jc + D v + ph(q) + S k].  The
// loop runs over the rows, then the outputs: every index is a constant.
template <bool FAST, int P, int NQ, int RV, int VC, typename T, typename A>
__device__ __forceinline__ void lf_cols_chunk(A (&acc)[RV][NQ][VC],
                                              const A (&t)[NQ][LF_MT],
                                              const T* x, int jc, int n_in,
                                              int64_t inner, int refl) {
  constexpr int D = lf_step<P>(), S = lf_tap_step<P>();
  constexpr int NWR = (D / S) * (RV - 1) + LF_MT;  // rows or pairs
#pragma unroll
  for (int u = 0; u < NWR; ++u) {
#pragma unroll
    for (int ph = 0; ph < S; ++ph) {
      A row[VC];
      lf_row<FAST, T, A, VC>(x, jc + S * u + ph, n_in, inner, refl, row);
#pragma unroll
      for (int v = 0; v < RV; ++v) {
        const int k = u - (D / S) * v;
        if (k >= 0 && k < LF_MT) {
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            if (lf_phase<P>(q) != ph) continue;
#pragma unroll
            for (int e = 0; e < VC; ++e) acc[v][q][e] += t[q][k] * row[e];
          }
        }
      }
    }
  }
}

// Block: column tile ct, row tile rt of outer row o (the first fastest in
// blockIdx.x); thread: VC adjacent columns, RV groups.
template <typename T, int P, int NB, bool SUM, int VC>
__device__ __forceinline__ void lf_cols_body(
    const T* __restrict__ x0, const T* __restrict__ x1, T* __restrict__ y0,
    T* __restrict__ y1, const typename AccOf<T>::type* __restrict__ taps,
    const LfArgs& a) {
  using A = typename AccOf<T>::type;
  constexpr int D = lf_step<P>(), S = lf_tap_step<P>();
  constexpr int NQ = lf_slots<P, NB, SUM>(), RV = lf_col_groups<P, NB, SUM>();
  constexpr int NWR = (D / S) * (RV - 1) + LF_MT;
  unsigned blk = blockIdx.x;  // under 2^31 blocks: 32-bit divisions
  const int ct = static_cast<int>(blk % a.col_tiles);
  blk /= a.col_tiles;
  const int rt = static_cast<int>(blk % a.row_tiles);
  const int64_t o = blk / a.row_tiles;
  const int cx = threadIdx.x & ((1 << a.lg_tx) - 1);
  const int cy = threadIdx.x >> a.lg_tx;
  const int64_t c0 = ((static_cast<int64_t>(ct) << a.lg_tx) + cx) * VC;
  const int i0 = ((rt << (8 - a.lg_tx)) + cy) * RV;  // 256 threads a block
  if (c0 >= a.inner || i0 >= a.gn) return;
  A acc[RV][NQ][VC];
#pragma unroll
  for (int v = 0; v < RV; ++v)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < VC; ++e) acc[v][q][e] = A(0);
#pragma unroll
  for (int b = 0; b < (SUM ? 2 : 1); ++b) {
    const T* x = (b ? x1 : x0) + o * a.n_in * a.inner + c0;
    const int j0 = D * i0 + (b ? a.base1 : a.base0);
    for (int c = 0; c < a.chunks; ++c) {
      A t[NQ][LF_MT];
      lf_taps<A, NQ>(taps, b * NQ, a.mp, c, t);
      const int jc = j0 + S * LF_MT * c;
      if (jc >= 0 && jc + S * NWR <= a.n_in)
        lf_cols_chunk<true, P, NQ, RV, VC>(acc, t, x, jc, a.n_in, a.inner,
                                           a.refl);
      else
        lf_cols_chunk<false, P, NQ, RV, VC>(acc, t, x, jc, a.n_in, a.inner,
                                            a.refl);
    }
  }
#pragma unroll
  for (int v = 0; v < RV; ++v) {
    const int i = i0 + v;
#pragma unroll
    for (int b = 0; b < (SUM ? 1 : NB); ++b) {
      const int g = b ? a.g1 : a.g0;
      if (i >= g) continue;
      T* yo = (b ? y1 : y0) +
              (o * (static_cast<int64_t>(P) * g) + P * i) * a.inner + c0;
#pragma unroll
      for (int s = 0; s < P; ++s) {
        A val[VC];
#pragma unroll
        for (int e = 0; e < VC; ++e)
          val[e] = lf_pick<P>(acc[v], b * P, s, b ? a.sw1 : a.sw0, e);
        if constexpr (VC == 1)
          store(yo + s * a.inner, val[0]);
        else
          store_pack<T, A, VC>(yo + s * a.inner, val);
      }
    }
  }
}

// Rows path staging: W samples of the row from window sample js into dst,
// as the accumulator type, the fold computed once a sample; a range inside
// the axis is copied with cp.async (float32, float64) without folds.
__device__ __forceinline__ void lf_copy(float* d, const float* s) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(d));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(s)
               : "memory");
}
__device__ __forceinline__ void lf_copy(double* d, const double* s) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(d));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(a), "l"(s)
               : "memory");
}
__device__ __forceinline__ void lf_copy(float* d, const __nv_bfloat16* s) {
  *d = load(s);
}

template <typename T, typename A>
__device__ __forceinline__ void lf_stage(const T* row, A* dst, int js, int W,
                                         int n_in, int refl) {
  if (js >= 0 && js + W <= n_in) {
    for (int e = threadIdx.x; e < W; e += LF_THREADS)
      lf_copy(dst + e, row + js + e);
  } else {
    for (int e = threadIdx.x; e < W; e += LF_THREADS) {
      const int jj = source(js + e, n_in, refl);
      dst[e] = jj >= 0 ? load(row + jj) : A(0);
    }
  }
}

__device__ __forceinline__ void lf_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void lf_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows path: N outputs from p (n of them stored, n <= N), in 16-byte or
// 8-byte vectors where the run is whole and aligned.
template <typename T, typename A, int N>
__device__ __forceinline__ void lf_store_run(T* p, const A (&v)[N], int n) {
  constexpr int V16 = 16 / sizeof(T), V8 = 8 / sizeof(T);
  const uintptr_t ad = reinterpret_cast<uintptr_t>(p);
  if constexpr (N % V16 == 0) {
    if (n == N && ad % 16 == 0) {
#pragma unroll
      for (int c = 0; c < N / V16; ++c)
        store_pack<T, A, V16>(p + c * V16, v + c * V16);
      return;
    }
  }
  if constexpr (N % V8 == 0) {
    if (n == N && ad % 8 == 0) {
#pragma unroll
      for (int c = 0; c < N / V8; ++c)
        store_pack<T, A, V8>(p + c * V8, v + c * V8);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < N; ++e)
    if (e < n) store(p + e, v[e]);
}

// Rows path: block u takes segment u % n_seg (groups s0 .. s0 + seg) of
// the rows outer rows from o0 = (u / n_seg) rows, items of GV groups each.
struct LfRowBlock {
  int64_t o0;
  int rows, s0, items;
};

template <int GV>
__device__ __forceinline__ LfRowBlock lf_row_block(const LfArgs& a,
                                                   unsigned u) {
  LfRowBlock n;
  n.s0 = u % a.n_seg * a.seg;
  n.o0 = static_cast<int64_t>(u / a.n_seg) * a.rows;
  n.rows = static_cast<int>(
      a.outer - n.o0 < static_cast<int64_t>(a.rows) ? a.outer - n.o0
                                                     : a.rows);
  const int lr = a.gn - n.s0 < a.seg ? a.gn - n.s0 : a.seg;
  n.items = (lr + GV - 1) / GV;
  return n;
}

// Stage round rd of block n into buffer bf: the window of every row and
// input, then commit the copies as one group.
template <typename T, typename A, int P, int NIN>
__device__ __forceinline__ void lf_stage_round(const T* x0, const T* x1,
                                               A* sm, const LfArgs& a,
                                               const LfRowBlock& n, int rd,
                                               int bf) {
  constexpr int D = lf_step<P>(), S = lf_tap_step<P>();
  const int cn = a.chunks - rd * a.cr < a.cr ? a.chunks - rd * a.cr : a.cr;
  const int W = D * (a.seg - 1) + S * LF_MT * cn;
  const int64_t region = static_cast<int64_t>(a.rows) * a.wp;
#pragma unroll
  for (int b = 0; b < NIN; ++b) {
    const T* x = b ? x1 : x0;
    const int js = D * n.s0 + (b ? a.base1 : a.base0) + S * LF_MT * a.cr * rd;
    for (int r = 0; r < n.rows; ++r)
      lf_stage(x + (n.o0 + r) * a.n_in, sm + (bf * NIN + b) * region +
                                            r * a.wp,
               js, W, a.n_in, a.refl);
  }
  lf_commit();
}

// Rows path: the staged windows in shared memory, wp values a row and an
// input: buffer bf, input b, row r at ((bf NIN + b) rows + r) wp.  Block:
// lf_row_block(blockIdx.x), its rounds in turn; thread: item (r, q),
// groups s0 + GV q ..
template <typename T, int P, int NB, bool SUM>
__device__ __forceinline__ void lf_rows_body(
    const T* __restrict__ x0, const T* __restrict__ x1, T* __restrict__ y0,
    T* __restrict__ y1, const typename AccOf<T>::type* __restrict__ taps,
    const LfArgs& a) {
  using A = typename AccOf<T>::type;
  constexpr int D = lf_step<P>(), S = lf_tap_step<P>();
  constexpr int NIN = SUM ? 2 : 1, NQ = lf_slots<P, NB, SUM>();
  constexpr int GV = lf_row_groups<A, P>(), V = 16 / sizeof(A);
  constexpr int NW = D * (GV - 1) + S * LF_MT;  // a chunk's window samples
  constexpr int NWV = (NW + V - 1) / V;
  extern __shared__ __align__(16) unsigned char lf_smem[];
  A* sm = reinterpret_cast<A*>(lf_smem);
  const int64_t region = static_cast<int64_t>(a.rows) * a.wp;
  const int rounds = (a.chunks + a.cr - 1) / a.cr;
  const LfRowBlock n = lf_row_block<GV>(a, blockIdx.x);
  const int r = threadIdx.x / n.items, q = threadIdx.x - r * n.items;
  A acc[GV][NQ][1];
#pragma unroll
  for (int v = 0; v < GV; ++v)
#pragma unroll
    for (int k = 0; k < NQ; ++k) acc[v][k][0] = A(0);
  lf_stage_round<T, A, P, NIN>(x0, x1, sm, a, n, 0, 0);
  for (int rd = 0; rd < rounds; ++rd) {
    if (rd + 1 < rounds) {
      lf_stage_round<T, A, P, NIN>(x0, x1, sm, a, n, rd + 1, (rd + 1) & 1);
      lf_wait<1>();
    } else {
      lf_wait<0>();
    }
    __syncthreads();
    if (r < n.rows) {
      const int bf = rd & 1;
      const int c1 = (rd + 1) * a.cr < a.chunks ? (rd + 1) * a.cr : a.chunks;
      for (int c = rd * a.cr; c < c1; ++c) {
#pragma unroll
        for (int b = 0; b < NIN; ++b) {
          A t[NQ][LF_MT];
          lf_taps<A, NQ>(taps, b * NQ, a.mp, c, t);
          const A* p = sm + (bf * NIN + b) * region + r * a.wp +
                       D * GV * q + S * LF_MT * (c - rd * a.cr);
          A w[NWV * V];
#pragma unroll
          for (int e = 0; e < NWV; ++e) {
            const Vec<A, V> pk = *reinterpret_cast<const Vec<A, V>*>(p + e * V);
#pragma unroll
            for (int u = 0; u < V; ++u) w[e * V + u] = pk.v[u];
          }
#pragma unroll
          for (int v = 0; v < GV; ++v)
#pragma unroll
            for (int k = 0; k < NQ; ++k)
#pragma unroll
              for (int m = 0; m < LF_MT; ++m)
                acc[v][k][0] += t[k][m] * w[D * v + lf_phase<P>(k) + S * m];
        }
      }
    }
    __syncthreads();
  }
  if (r >= n.rows) return;
  const int i0 = n.s0 + GV * q;
#pragma unroll
  for (int b = 0; b < (SUM ? 1 : NB); ++b) {
    const int g = b ? a.g1 : a.g0;
    if (i0 >= g) continue;
    A val[P * GV];
#pragma unroll
    for (int v = 0; v < GV; ++v)
#pragma unroll
      for (int s = 0; s < P; ++s)
        val[v * P + s] = lf_pick<P>(acc[v], b * P, s, b ? a.sw1 : a.sw0, 0);
    const int nv = P * (g - i0 < GV ? g - i0 : GV);
    lf_store_run<T, A, P * GV>(
        (b ? y1 : y0) + (n.o0 + r) * (static_cast<int64_t>(P) * g) +
            static_cast<int64_t>(P) * i0,
        val, nv);
  }
}

// The kernels: each body under two launch bounds.  Under the default one,
// ptxas keeps the two-branch float32 and bfloat16 instances (the round
// trips' launches) in registers, but spilled 4-16 bytes in eight of the
// others (one branch, or float64) to reach an occupancy step; those take
// a minimum of one block an SM, under which every instance keeps its
// values in registers (the round trip's launches under that bound ran
// 1.2-1.4x slower: PERF.md).
template <typename T, int NB> constexpr bool lf_one_block() {
  return NB == 1 || sizeof(T) == 8;
}

#define LF_PARAMS                                                         \
  const T *__restrict__ x0, const T *__restrict__ x1, T *__restrict__ y0, \
      T *__restrict__ y1, const typename AccOf<T>::type *__restrict__ taps, \
      const LfArgs a

template <typename T, int P, int NB, bool SUM, int VC>
__global__ void __launch_bounds__(LF_THREADS) lf_cols(LF_PARAMS) {
  lf_cols_body<T, P, NB, SUM, VC>(x0, x1, y0, y1, taps, a);
}
template <typename T, int P, int NB, bool SUM, int VC>
__global__ void __launch_bounds__(LF_THREADS, 1) lf_cols_one(LF_PARAMS) {
  lf_cols_body<T, P, NB, SUM, VC>(x0, x1, y0, y1, taps, a);
}
template <typename T, int P, int NB, bool SUM>
__global__ void __launch_bounds__(LF_THREADS) lf_rows(LF_PARAMS) {
  lf_rows_body<T, P, NB, SUM>(x0, x1, y0, y1, taps, a);
}
template <typename T, int P, int NB, bool SUM>
__global__ void __launch_bounds__(LF_THREADS, 1) lf_rows_one(LF_PARAMS) {
  lf_rows_body<T, P, NB, SUM>(x0, x1, y0, y1, taps, a);
}

template <typename T, int P, int NB, bool SUM, int VC>
constexpr auto lf_cols_kernel() {
  if constexpr (lf_one_block<T, NB>()) {
    return lf_cols_one<T, P, NB, SUM, VC>;
  } else {
    return lf_cols<T, P, NB, SUM, VC>;
  }
}
template <typename T, int P, int NB, bool SUM>
constexpr auto lf_rows_kernel() {
  if constexpr (lf_one_block<T, NB>()) {
    return lf_rows_one<T, P, NB, SUM>;
  } else {
    return lf_rows<T, P, NB, SUM>;
  }
}

// The staged row's values (a multiple of a vector): the window of seg
// groups and cr chunks, and the reach of the last thread's vector loads.
template <typename A, int P>
__host__ int64_t lf_row_pitch(int seg, int cr) {
  constexpr int V = 16 / sizeof(A);
  const int64_t w = static_cast<int64_t>(lf_step<P>()) * (seg - 1) +
                    static_cast<int64_t>(lf_tap_step<P>()) * LF_MT * cr +
                    V - 1;
  return (w + V - 1) / V * V;
}

template <typename Kernel, typename... Args>
cudaError_t lf_launch(Kernel kernel, int64_t blocks, int smem,
                      cudaStream_t st, Args... args) {
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), LF_THREADS, smem, st>>>(args...);
  return cudaGetLastError();
}

// The host's tiling, checked against the instance: tile = mt, path (0
// rows, 1 columns), groups a thread (RV, GV), columns a thread, threads
// across inner, outer rows a block, groups a block, chunks a staging
// round, dynamic shared memory in bytes.
template <typename T, int P, int NB, bool SUM>
int launch(const void* x0, const void* x1, void* y0, void* y1,
           const void* taps, LfArgs a, const int* tile, cudaStream_t st) {
  using A = typename AccOf<T>::type;
  using TT = const T*;
  using TA = const A*;
  const int mt = tile[0], path = tile[1], v = tile[2], vc = tile[3],
            tx = tile[4], rows = tile[5], seg = tile[6], cr = tile[7],
            smem = tile[8];
  if (mt != LF_MT || tx < 1 || tx > LF_THREADS || (tx & (tx - 1)) ||
      rows < 1 || seg < 1 || cr < 1 || cr > a.chunks || smem < 0)
    return cudaErrorInvalidValue;
  a.lg_tx = 0;
  while ((1 << a.lg_tx) < tx) ++a.lg_tx;
  if (path == 1) {
    constexpr int RV = lf_col_groups<P, NB, SUM>();
    if (a.inner < 2 || v != RV || (vc != 1 && vc != col_vec<T>()) ||
        a.inner % vc || rows != 1 || seg != (LF_THREADS / tx) * RV ||
        cr != a.chunks || smem != 0)
      return cudaErrorInvalidValue;
    const int64_t col_tiles = (a.inner + int64_t(tx) * vc - 1) /
                              (int64_t(tx) * vc);
    const int64_t row_tiles = (a.gn + int64_t(seg) - 1) / seg;
    const int64_t blocks = a.outer * row_tiles * col_tiles;
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    a.row_tiles = static_cast<int>(row_tiles);
    a.col_tiles = static_cast<int>(col_tiles);
    if (vc == 1)
      return lf_launch(lf_cols_kernel<T, P, NB, SUM, 1>(), blocks, 0, st,
                       static_cast<TT>(x0), static_cast<TT>(x1),
                       static_cast<T*>(y0), static_cast<T*>(y1),
                       static_cast<TA>(taps), a);
    return lf_launch(lf_cols_kernel<T, P, NB, SUM, col_vec<T>()>(), blocks,
                     0, st,
                     static_cast<TT>(x0), static_cast<TT>(x1),
                     static_cast<T*>(y0), static_cast<T*>(y1),
                     static_cast<TA>(taps), a);
  }
  constexpr int GV = lf_row_groups<A, P>();
  if (path != 0 || a.inner != 1 || v != GV || vc != 1 || tx != 1 ||
      seg % GV || int64_t(rows) * (seg / GV) > LF_THREADS)
    return cudaErrorInvalidValue;
  a.n_seg = (a.gn + seg - 1) / seg;
  if (a.n_seg > 1 && rows != 1) return cudaErrorInvalidValue;
  const int64_t wp = lf_row_pitch<A, P>(seg, cr);
  const int bufs = cr < a.chunks ? 2 : 1;  // double-buffered rounds
  const int64_t bytes = int64_t(bufs) * (SUM ? 2 : 1) * rows * wp *
                        static_cast<int64_t>(sizeof(A));
  if (bytes != smem || bytes > LF_SMEM_MAX || wp > INT_MAX)
    return cudaErrorInvalidValue;
  a.rows = rows;
  a.seg = seg;
  a.cr = cr;
  a.wp = static_cast<int>(wp);
  const int64_t blocks = (a.outer + rows - 1) / rows * a.n_seg;
  return lf_launch(lf_rows_kernel<T, P, NB, SUM>(), blocks, smem, st,
                   static_cast<TT>(x0), static_cast<TT>(x1),
                   static_cast<T*>(y0), static_cast<T*>(y1),
                   static_cast<TA>(taps), a);
}

template <typename T>
int launch_plan(const void* x0, const void* x1, void* y0, void* y1,
                const void* taps, const LfArgs& a, int P, int nb, int sum,
                const int* tile, cudaStream_t st) {
  if (sum) {
    if (P == 1) return launch<T, 1, 2, true>(x0, x1, y0, y1, taps, a, tile, st);
    if (P == 4) return launch<T, 4, 2, true>(x0, x1, y0, y1, taps, a, tile, st);
    return cudaErrorInvalidValue;
  }
  if (P == 1)
    return nb == 1 ? launch<T, 1, 1, false>(x0, x1, y0, y1, taps, a, tile, st)
                   : launch<T, 1, 2, false>(x0, x1, y0, y1, taps, a, tile, st);
  if (P == 2)
    return nb == 1 ? launch<T, 2, 1, false>(x0, x1, y0, y1, taps, a, tile, st)
                   : launch<T, 2, 2, false>(x0, x1, y0, y1, taps, a, tile, st);
  if (P == 4 && nb == 1)
    return launch<T, 4, 1, false>(x0, x1, y0, y1, taps, a, tile, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dtcwt

// x0, x1 (sum form: branch 1's input), y0, y1 (analysis: branch 1's
// output); the view [outer, n_in, inner]; sum; side and refl; taps: a
// device buffer in the accumulator type, a row of chunks LF_MT taps a
// slot; meta: the host ints P, nb, g0, g1, base0, base1, sw0, sw1, chunks
// (ops/longfir.py _plan); tile: the host's tiling (ops/longfir.py
// _geometry); dtype; stream.
extern "C" int dtcwt_longfir(const void* x0, const void* x1, void* y0,
                             void* y1, long long outer, int n_in,
                             long long inner, int sum, int side, int refl,
                             const void* taps, const int* meta,
                             const int* tile, int dtype, void* stream) {
  dtcwt::LfArgs a = {};
  const int P = meta[0], nb = meta[1];
  a.outer = outer;
  a.inner = inner;
  a.n_in = n_in;
  a.refl = refl ? 1 : 0;
  a.g0 = meta[2];
  a.g1 = nb == 2 ? meta[3] : 0;
  a.gn = a.g0 > a.g1 ? a.g0 : a.g1;
  const int shift = refl ? 0 : side;
  a.base0 = meta[4] + shift;
  a.base1 = meta[5] + shift;
  a.sw0 = meta[6];
  a.sw1 = meta[7];
  a.chunks = meta[8];
  a.mp = a.chunks * dtcwt::LF_MT;
  if (outer < 1 || inner < 1 || n_in < 1 || !taps || !x0 || !y0 || !tile ||
      nb < 1 || nb > 2 || a.g0 < 1 || (nb == 2 && a.g1 < 1) ||
      a.chunks < 1 || a.sw0 < 0 || a.sw0 > 1 || a.sw1 < 0 || a.sw1 > 1 ||
      (P == 1 && (a.sw0 || a.sw1)) ||
      (sum && (nb != 2 || !x1 || a.g0 != a.g1 || a.sw0 != a.sw1)) ||
      (!sum && nb == 2 && (!y1 || a.base0 != a.base1)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dtcwt::DT_F32:
      return dtcwt::launch_plan<float>(x0, x1, y0, y1, taps, a, P, nb, sum,
                                       tile, st);
    case dtcwt::DT_BF16:
      return dtcwt::launch_plan<__nv_bfloat16>(x0, x1, y0, y1, taps, a, P,
                                               nb, sum, tile, st);
    case dtcwt::DT_F64:
      return dtcwt::launch_plan<double>(x0, x1, y0, y1, taps, a, P, nb, sum,
                                        tile, st);
  }
  return cudaErrorInvalidValue;
}
