// The pieces of the Hopper tiling of the 1-D stream kernels (CUDA C++,
// sm_90a): filter.cu's two paths, for two branch filters whose taps travel
// by value under a compile-time bound MT (taps.cuh).  The synthesis sums of
// dual.cu (streamsum.cuh: filter2_sum, ifilt2_sum) run on them.
//
// The filtered axis of a contiguous tensor is viewed as [outer, n_in,
// inner].  A branch is P output streams of groups g (taps.cuh): filter P =
// 1, a group one output whose window is the MT samples from g - ph; ifilt
// P = 4, a group four outputs whose window is the MT sample pairs from
// 2 (g - ph), the even sample of a pair feeding streams of one parity and
// the odd one the others, as the branch's swap sw says.  D is the samples
// a group steps (1, 2).  In the from-extension mode every sample index is
// shifted by the side the caller extended; in the reflect mode a sample
// outside the axis is read at source() of common.cuh.
//
// * Columns (inner > 1): a thread owns VC adjacent columns (one 16-byte
//   vector, bfloat16 8, where inner and the pointers allow; else one) and
//   RV consecutive output groups.  It loads the rows its window needs once
//   from each input, coalesced across the warp (st_load_row), and adds
//   each row into every output it reaches (st_fir, st_fir_pairs): no
//   shared memory.
// * Rows (inner = 1): a block stages a flat range of each input, its halo
//   included, into shared memory with 16-byte cp.async copies, a head and
//   a tail a value at a time taking any alignment (st_stage_flat); a
//   thread then takes GV consecutive groups from a register window of
//   each input (st_row_window).
#pragma once

#include "taps.cuh"

namespace dtcwt {

constexpr int ST_THREADS = 256;
constexpr int ST_SMEM_MAX = 227 * 1024;  // dynamic shared memory a block

// Samples a group steps: filter 1, ifilt 2.
template <int P> __host__ __device__ constexpr int st_step() {
  return P == 1 ? 1 : 2;
}
// Columns path: output groups a thread.
template <int P> __host__ __device__ constexpr int st_col_groups() {
  return P == 1 ? 8 : 4;
}
// Rows path: groups a thread item, P GV outputs of 16 bytes of storage
// (float64 ifilt: one group, 32 bytes).
template <typename T, int P>
__host__ __device__ constexpr int st_row_groups() {
  return P == 1 ? vec16<T>() : vec16<T>() / 4 > 1 ? vec16<T>() / 4 : 1;
}
// Rows path: values of one input's staged region, rows whole rows of n_in
// or a segment of seg groups with its halo, after a pad of up to a vector;
// a multiple of a vector, so that every region starts 16 bytes aligned.
template <typename T, int P, int MT>
__host__ __device__ constexpr int64_t st_row_region(int rows, int seg,
                                                    int n_in) {
  const int64_t span = static_cast<int64_t>(st_step<P>()) * (seg + MT - 1);
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

// Rows path: w[t] = sample j0 + t of a staged row whose in-row sample j
// is xs[rbase + j], t < NW.  FAST: the window lies inside the row.
// Otherwise each sample is read at source() of the axis, zero where it
// reads as zero, its cell clamped to the staged cells [lo, hi]: the clamp
// moves only reads that no stored output takes.
template <typename T, typename A, int NW, bool FAST>
__device__ __forceinline__ void st_row_window(const T* xs, int rbase,
                                              int j0, int n_in, int refl,
                                              int lo, int hi, A (&w)[NW]) {
  if constexpr (FAST) {
    const T* p = xs + rbase + j0;
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

}  // namespace dtcwt
