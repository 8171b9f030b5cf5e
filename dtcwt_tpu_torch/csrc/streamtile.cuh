// The pieces of the Hopper tiling of the 1-D stream kernels (CUDA C++,
// sm_90a): filter.cu's two paths, for NB branch filters (two, or one)
// whose taps travel by value under a compile-time bound MT (taps.cuh).
// The analysis kernels of streamana.cuh (dual.cu's filter2 and dfilt2: one
// input, two branch outputs; single.cu's dfilt: one input, one output) and
// the synthesis kernels of streamsum.cuh (dual.cu's filter2_sum and
// ifilt2_sum: two inputs summed into one output; single.cu's ifilt: one
// input, one output) run on them.
//
// The filtered axis of a contiguous tensor is viewed as [outer, n_in,
// inner].  A branch is P output streams of groups g (taps.cuh): filter P =
// 1, a group one output whose window is the MT samples from g - ph; dfilt
// P = 2, a group two outputs whose window is the MT sample pairs from 4 g -
// 2 ph; ifilt P = 4, a group four outputs whose window is the MT sample
// pairs from 2 (g - ph).  In a pair the even sample feeds the streams of
// one parity and the odd one the others, as the branch's swap sw says.  D
// is the samples a group steps (1, 4, 2) and S the samples a tap steps (1,
// 2, 2).  In the from-extension mode every sample index is shifted by the
// side the caller extended; in the reflect mode a sample outside the axis
// is read at source() of common.cuh.
//
// * Columns (inner > 1): a thread owns VC adjacent columns (one 16-byte
//   vector, bfloat16 8, where inner and the pointers allow; else one) and
//   RV consecutive output groups.  It loads the rows its window needs once
//   from each input, coalesced across the warp (st_load_row), and adds
//   each row into every output it reaches (st_fir, st_fir_dec,
//   st_fir_pairs): no shared memory.
// * Rows (inner = 1): a block takes a segment of groups of some outer rows
//   (st_row_block) and stages a flat range of each input, its halo
//   included, into shared memory with 16-byte cp.async copies, a head and
//   a tail a value at a time taking any alignment (st_stage_flat,
//   st_stage_rows); a thread then takes items of GV consecutive groups
//   (st_row_items), each from a register window of each input
//   (st_row_window).
//
// The host chooses the path and the tiling (ops/dual.py _stream_geometry)
// and passes them in as an StTile; the C entries refuse any other.
#pragma once

#include <climits>

#include "taps.cuh"

namespace dtcwt {

constexpr int ST_THREADS = 256;
constexpr int ST_SMEM_MAX = 227 * 1024;  // dynamic shared memory a block
// Rows path, the one-branch entries: above this tap bound an item's window
// is read and summed in chunks of taps (st_row_chunk).
constexpr int ST_ROW_CHUNK_ABOVE = 18;

// Samples a group steps: filter 1, dfilt 4, ifilt 2.
template <int P> __host__ __device__ constexpr int st_step() {
  return P == 1 ? 1 : P == 2 ? 4 : 2;
}
// Samples a tap steps: filter 1, the qshift streams 2.
template <int P> __host__ __device__ constexpr int st_tap_step() {
  return P == 1 ? 1 : 2;
}
// Columns path: output groups a thread, by streams P, inputs NIN and
// branches NB (ops/dual.py _COL_GROUPS): the analysis entries (one input,
// two branches' accumulators) filter 4 outputs, dfilt 2 groups of 2; the
// sums (two inputs, one set) filter 8, ifilt 4 groups of 4; the one-branch
// entries (one input, one set) dfilt 2 groups of 2, ifilt 2 groups of 4.
template <int P, int NIN, int NB>
__host__ __device__ constexpr int st_col_groups() {
  return NB == 1 ? 2 : NIN == 1 ? (P == 1 ? 4 : 2) : (P == 1 ? 8 : 4);
}
// Rows path: groups a thread item, P GV outputs of 16 bytes of storage
// (float64 ifilt: one group, 32 bytes).
template <typename T, int P>
__host__ __device__ constexpr int st_row_groups() {
  return vec16<T>() / P > 1 ? vec16<T>() / P : 1;
}
// Samples the windows of n consecutive groups span.
template <int P, int MT> __host__ __device__ constexpr int st_span(int n) {
  return st_step<P>() * (n - 1) + st_tap_step<P>() * MT;
}
// Rows path: values of one input's staged region, rows whole rows of n_in
// or a segment of seg groups with its halo, after a pad of up to a vector;
// a multiple of a vector, so that every region starts 16 bytes aligned.
template <typename T, int P, int MT>
__host__ __device__ constexpr int64_t st_row_region(int rows, int seg,
                                                    int n_in) {
  const int64_t span = st_span<P, MT>(seg);
  const int64_t vals = vec16<T>() + static_cast<int64_t>(rows - 1) * n_in +
                       (span < n_in ? span : n_in);
  return (vals + vec16<T>() - 1) / vec16<T>() * vec16<T>();
}

// Columns path: the VC values of row j of the axis from the column
// pointer x (rows inner apart), zero where the sample reads as zero.
template <typename T, typename A, int VC>
__device__ __forceinline__ void st_load_row(const T* x, int j, int n_in,
                                            int inner, int refl,
                                            A (&v)[VC]) {
  const int jj = source(j, n_in, refl);
  load_pack<T, A, VC>(x + static_cast<int64_t>(jj < 0 ? 0 : jj) * inner, v);
  if (jj < 0) {
#pragma unroll
    for (int u = 0; u < VC; ++u) v[u] = 0;
  }
}

// Columns path, filter: add window row r of one branch into the RV
// outputs it reaches, acc[v] += t[r - v] x.  The loop runs over the
// outputs, so that the accumulators keep compile-time indices (registers)
// even where the caller's loop over r is too long to unroll.
template <typename A, int MT, int RV, int VC>
__device__ __forceinline__ void st_fir(A (&acc)[RV][1][VC], int r,
                                       const A (&t)[HS_K],
                                       const A (&x)[VC]) {
#pragma unroll
  for (int v = 0; v < RV; ++v) {
    const int m = r - v;
    if (m >= 0 && m < MT) {
      const A tk = t[m];
#pragma unroll
      for (int u = 0; u < VC; ++u) acc[v][0][u] += tk * x[u];
    }
  }
}

// Columns path, dfilt: add window pair r (rows e, o of even and odd
// parity) of one branch into the RV groups it reaches (group v's window
// starts at pair 2 v), as st_fir: acc[v][p] sums the parity p, its taps
// t[p] placed by parity (hs_taps_by_parity); the caller applies the
// branch's swap where it stores.
template <typename A, int MT, int RV, int VC>
__device__ __forceinline__ void st_fir_dec(A (&acc)[RV][2][VC], int r,
                                           const A (&t)[2][HS_K],
                                           const A (&e)[VC],
                                           const A (&o)[VC]) {
#pragma unroll
  for (int v = 0; v < RV; ++v) {
    const int m = r - 2 * v;
    if (m >= 0 && m < MT) {
      const A te = t[0][m], to = t[1][m];
#pragma unroll
      for (int u = 0; u < VC; ++u) {
        acc[v][0][u] += te * e[u];
        acc[v][1][u] += to * o[u];
      }
    }
  }
}

// Columns path, ifilt: add window pair r (rows e, o of even and odd
// parity) of one branch into the RV groups it reaches, as st_fir: stream
// s takes the parity (s & 1) ^ sw.
template <typename A, int MT, int RV, int VC>
__device__ __forceinline__ void st_fir_pairs(A (&acc)[RV][4][VC], int r,
                                             const A (&t)[4][HS_K], int sw,
                                             const A (&e)[VC],
                                             const A (&o)[VC]) {
  A wa[VC], wb[VC];
#pragma unroll
  for (int u = 0; u < VC; ++u) {
    wa[u] = sw ? o[u] : e[u];
    wb[u] = sw ? e[u] : o[u];
  }
#pragma unroll
  for (int v = 0; v < RV; ++v) {
    const int m = r - v;
    if (m >= 0 && m < MT) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const A tk = t[s][m];
#pragma unroll
        for (int u = 0; u < VC; ++u) acc[v][s][u] += tk * (s & 1 ? wb : wa)[u];
      }
    }
  }
}

// Rows path: stage src[0 .. len) into shared memory at region + pad, pad
// being src's distance from 16-byte alignment in values (so that the two
// are congruent): 16-byte cp.async copies for the body, a value at a time
// for the head and the tail.  Returns pad.  The caller waits
// (cp_async_wait_all) and syncs.
template <typename T>
__device__ __forceinline__ int st_stage_flat(const T* src, T* region,
                                             int len) {
  constexpr int VEC = vec16<T>();
  const int pad = static_cast<int>(
      (reinterpret_cast<uintptr_t>(src) % 16) / sizeof(T));
  T* dst = region + pad;
  const int head = (VEC - pad) % VEC < len ? (VEC - pad) % VEC : len;
  const int nvec = (len - head) / VEC;
  for (int e = threadIdx.x; e < head; e += ST_THREADS) dst[e] = src[e];
  for (int q = threadIdx.x; q < nvec; q += ST_THREADS)
    cp_async16(dst + head + q * VEC, src + head + q * VEC);
  for (int e = head + nvec * VEC + threadIdx.x; e < len; e += ST_THREADS)
    dst[e] = src[e];
  return pad;
}

// Rows path, the one-branch entries: taps a chunk, 128 bytes of a
// branch's P streams' taps in the accumulator type A (dfilt 16, float64
// 8; ifilt float64 4), the chunk size that ran fastest at the largest tap
// bound against half and twice it.
template <typename A, int P> __host__ __device__ constexpr int st_row_chunk() {
  return 128 / (P * static_cast<int>(sizeof(A)));
}

// Rows path: the share of block blockIdx.x, segment blockIdx.x % n_seg
// (groups [s0, s0 + L) of gn, lr of them) of the R outer rows from o0
// (rows of them), and the flat range it stages of each input: len values
// from in-row sample sa of row o0, the windows of its groups, group s0's
// starting at in-row sample j00.
struct StRowBlock {
  int64_t o0;
  int rows, s0, lr, j00, sa, len;
};

template <int P, int MT>
__device__ __forceinline__ StRowBlock st_row_block(int outer, int n_in,
                                                   int gn, int side, int R,
                                                   int L, int n_seg) {
  StRowBlock b;
  b.s0 = static_cast<int>(blockIdx.x % n_seg) * L;
  b.o0 = static_cast<int64_t>(blockIdx.x / n_seg) * R;
  b.rows = static_cast<int>(
      outer - b.o0 < static_cast<int64_t>(R) ? outer - b.o0 : R);
  b.lr = gn - b.s0 < L ? gn - b.s0 : L;
  b.j00 = st_step<P>() * b.s0 - st_tap_step<P>() * ((MT - 1) / 2) + side;
  b.sa = b.j00 > 0 ? b.j00 : 0;
  const int sb = b.j00 + st_span<P, MT>(L) < n_in ? b.j00 + st_span<P, MT>(L)
                                                   : n_in;
  b.len = (b.rows - 1) * n_in + (sb - b.sa);
  return b;
}

// Rows path: stage block bk's flat range of the input a, and of b where
// NIN = 2, into the regions xs and xs + rb, pad[i] values in
// (st_stage_flat), and wait for them.
template <typename T, int NIN>
__device__ __forceinline__ void st_stage_rows(const T* a, const T* b,
                                              T* xs, int rb, int n_in,
                                              const StRowBlock& bk,
                                              int (&pad)[NIN]) {
  const int64_t f0 = bk.o0 * n_in + bk.sa;
  pad[0] = st_stage_flat(a + f0, xs, bk.len);
  if constexpr (NIN == 2) pad[1] = st_stage_flat(b + f0, xs + rb, bk.len);
  cp_async_wait_all();
  __syncthreads();
}

// Whether an item's windows lie inside their row, as a type.
template <bool B> struct StFast {
  static constexpr bool value = B;
};

// Rows path: block b's items of GV groups, item(r, q, StFast<FAST>) for
// staged row r and item q (groups s0 + q GV ..) in turn over the block's
// threads.  Items [q_lo, q_hi) read inside their row (FAST); the others,
// at the row's ends, reflect or read zero, in a loop of their own so that
// no warp of the interior diverges.
template <int P, int MT, int GV, typename Item>
__device__ __forceinline__ void st_row_items(const StRowBlock& b, int n_in,
                                             Item&& item) {
  constexpr int D = st_step<P>();
  constexpr int NW = st_span<P, MT>(GV);  // an item's window samples
  const int items = (b.lr + GV - 1) / GV;
  const int lo = -b.j00;             // j0 >= 0 <=> q D GV >= lo
  const int hi = n_in - NW - b.j00;  // j0 + NW <= n_in <=> q D GV <= hi
  const int q_lo = lo > 0 ? min(items, (lo + D * GV - 1) / (D * GV)) : 0;
  const int q_hi =
      max(q_lo, min(items, hi < 0 ? 0 : hi / (D * GV) + 1));
  const int ni = q_hi - q_lo, ne = items - ni;
  for (int it = threadIdx.x; it < b.rows * ni; it += ST_THREADS) {
    const int r = it / ni;
    item(r, q_lo + it - r * ni, StFast<true>{});
  }
  for (int it = threadIdx.x; it < b.rows * ne; it += ST_THREADS) {
    const int r = it / ne, k = it - r * ne;
    item(r, k < q_lo ? k : q_hi + k - q_lo, StFast<false>{});
  }
}

// Rows path: w[t] = sample j0 + t of a staged row whose in-row sample j
// is xs[rbase + j], t < NW.  FAST: the window lies inside the row; VEC: it
// is read in 16-byte vectors where it starts on one (the last vector may
// run up to a vector's end past the window, inside the staged region,
// whose size is a multiple of a vector).  Otherwise each sample is read at
// source() of the axis, zero where it reads as zero, its cell clamped to
// the staged cells [lo, hi]: the clamp moves only reads that no stored
// output takes.
template <typename T, typename A, int NW, bool FAST, bool VEC = false>
__device__ __forceinline__ void st_row_window(const T* xs, int rbase,
                                              int j0, int n_in, int refl,
                                              int lo, int hi, A (&w)[NW]) {
  if constexpr (FAST) {
    const T* p = xs + rbase + j0;
    if constexpr (VEC) {
      constexpr int V = vec16<T>();
      if (reinterpret_cast<uintptr_t>(p) % 16 == 0) {
#pragma unroll
        for (int c = 0; c < (NW + V - 1) / V; ++c) {
          const Vec<T, V> pk = *reinterpret_cast<const Vec<T, V>*>(p + c * V);
#pragma unroll
          for (int u = 0; u < V; ++u)
            if (c * V + u < NW) w[c * V + u] = load(&pk.v[u]);
        }
        return;
      }
    }
#pragma unroll
    for (int t = 0; t < NW; ++t) w[t] = load(p + t);
  } else {
#pragma unroll
    for (int t = 0; t < NW; ++t) {
      const int jj = source(j0 + t, n_in, refl);
      int c = rbase + (jj < 0 ? 0 : jj);
      c = c < lo ? lo : (c > hi ? hi : c);
      const A v = load(xs + c);
      w[t] = jj >= 0 ? v : A(0);
    }
  }
}

// The host's tiling of a stream launch (ops/dual.py _stream_geometry): the
// tap bound, the path (0 rows, 1 columns), groups a thread item (rows) or a
// thread (columns), columns a thread, outer rows a block (rows path),
// groups a block along the axis, threads across inner (columns path) and
// the dynamic shared memory in bytes.
struct StTile {
  int mt, path, v, vc, rows, seg, tx, smem;
};

template <typename Kernel, typename... Args>
cudaError_t st_launch(Kernel kernel, int64_t blocks, int smem,
                      cudaStream_t stream, Args... args) {
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;
  if (smem > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), ST_THREADS, smem, stream>>>(
      args...);
  return cudaGetLastError();
}

// Rows path: whether the host's tiling t is one the instance runs on gn
// groups a row (GV groups an item, segments of whole items, the shared
// memory of `inputs` staged regions), and its segments n_seg and region
// rb in values.
template <typename T, int P, int MT>
bool st_rows_tile(const StTile& t, int inner, int n_in, int gn, int inputs,
                  int* n_seg, int* rb) {
  constexpr int GV = st_row_groups<T, P>();
  if (inner != 1 || t.v != GV || t.vc != 1 || t.tx != 1 || t.rows < 1 ||
      t.seg < GV || t.seg % GV)
    return false;
  *n_seg = (gn + t.seg - 1) / t.seg;
  if (*n_seg > 1 && t.rows != 1) return false;
  const int64_t r = st_row_region<T, P, MT>(t.rows, t.seg, n_in);
  *rb = static_cast<int>(r);
  return inputs * r * static_cast<int64_t>(sizeof(T)) == t.smem &&
         t.smem <= ST_SMEM_MAX;
}

// Columns path: whether the host's tiling t is one the instance runs (RV
// groups a thread, a power of two of threads across inner, seg groups a
// block), and lgTX.
template <int P, int NIN, int NB>
bool st_cols_tile(const StTile& t, int inner, int* lgTX) {
  constexpr int RV = st_col_groups<P, NIN, NB>();
  if (t.path != 1 || inner < 2 || t.v != RV || t.rows != 1 || t.tx < 1 ||
      t.tx > ST_THREADS || (t.tx & (t.tx - 1)) ||
      t.seg != (ST_THREADS / t.tx) * RV || t.smem != 0)
    return false;
  *lgTX = 0;
  while ((1 << *lgTX) < t.tx) ++*lgTX;
  return true;
}

// The plans' taps at the least tap bound of the instance set st_bound<P>
// that holds them; returns it, 0 where none does.
template <typename A, int P, int NB>
int st_fill_taps(HsTaps<A, P, NB>* tp, const double* taps, const int* lens,
                 const int* offs) {
  for (int e = 0; e < HS_BOUNDS; ++e)
    if (make_hs_taps<A, P>(tp, taps, lens, offs, st_bound<P>(e)))
      return st_bound<P>(e);
  return 0;
}

}  // namespace dtcwt
