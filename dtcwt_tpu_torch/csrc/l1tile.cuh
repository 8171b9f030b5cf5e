// Shared pieces of the two 2-D level-1 kernels, the forward (level1.cu)
// and the inverse (ilevel1.cu), CUDA C++, sm_90a.
//
// Both run 256-thread blocks on tiles 128 output columns wide.  A column
// stage filters register windows down a column into shared column images
// (row stride l1_xws); a row stage filters windows of 4 + 2 p samples of
// those images, read as 16-byte vectors, in registers.  The taps travel by
// value in the kernel's parameters (L1Taps), each filter centred on the
// common halo p (zero outside its own reach), so every tap loop runs to a
// compile-time bound MT >= 2 p + 1 under one uniform guard k < 2 p + 1.
// The qshift forward (level2.cu, l2tile.cuh) uses the column loads and the
// 16-byte window loads too.
#pragma once

#include "common.cuh"

namespace dtcwt {

constexpr int L1_THREADS = 256;
constexpr int L1_TW = 128;  // output columns a block: 32 lanes x 4
constexpr int L1_V = 4;     // output columns a row-stage item

template <typename A> struct L1Taps {
  A t[3][MAX_TAPS];  // reversed taps of the three filters centred on p
};

// The ns filters' reversed taps t[s] (m[s] of them, odd, at most
// MAX_TAPS) centred on the common halo *p, their largest half-length.
// False on a length the kernels do not take.
template <typename A>
inline bool make_l1taps(L1Taps<A>* tp, int* p, const double* const t[3],
                        const int m[3], int ns) {
  *p = 0;
  for (int si = 0; si < ns; ++si) {
    if (m[si] < 1 || m[si] > MAX_TAPS || m[si] % 2 == 0) return false;
    *p = m[si] / 2 > *p ? m[si] / 2 : *p;
  }
  for (int si = 0; si < 3; ++si) {
    for (int k = 0; k < MAX_TAPS; ++k) {
      const int kk = k - (*p - m[si] / 2);  // index into the filter's taps
      tp->t[si][k] = si < ns && kk >= 0 && kk < m[si]
                         ? static_cast<A>(t[si][kk])
                         : A(0);
    }
  }
  return true;
}

// The least tap bound of 8, 16, 24, 32 that holds mm taps.
constexpr int l1_tap_bound(int mm) {
  return mm <= 8 ? 8 : mm <= 16 ? 16 : mm <= 24 ? 24 : 32;
}

// The column images' shared row stride: 128 + 2 p columns, 16-byte rows.
__host__ __device__ constexpr int l1_xws(int p) {
  return (L1_TW + 2 * p + 3) / 4 * 4;
}

// s[t] = the sample of column gc at row rs + t of a rows x cols image,
// t < rv + mm - 1, zero past it; rows reflect only where !rows_in.
template <typename T, int RV, int MT>
__device__ __forceinline__ void col_load(const T* __restrict__ xb, int rs,
                                         int gc, int rows, int cols, int mm,
                                         bool rows_in,
                                         typename AccOf<T>::type s[]) {
  using A = typename AccOf<T>::type;
  if (rows_in) {
    const T* q = xb + static_cast<int64_t>(rs) * cols + gc;
#pragma unroll
    for (int t = 0; t < RV + MT - 1; ++t)
      s[t] = t < RV + mm - 1 ? load(q + static_cast<int64_t>(t) * cols)
                             : A(0);
  } else {
#pragma unroll
    for (int t = 0; t < RV + MT - 1; ++t)
      s[t] = t < RV + mm - 1
                 ? load(xb + static_cast<int64_t>(fold(rs + t, rows)) * cols +
                        gc)
                 : A(0);
  }
}

// acc[v] += sum_k t[k] s[v + k], k < mm: one uniform guard for every
// filter (a guard per filter's own taps keeps each k's predicate live and
// doubles the registers).
template <typename A, int MT, int NV>
__device__ __forceinline__ void fir_acc(const A* s, const A* t, int mm,
                                        A acc[NV]) {
#pragma unroll
  for (int k = 0; k < MT; ++k) {
    if (k < mm) {
      const A tk = t[k];
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[v] += tk * s[v + k];
    }
  }
}

// The window of four adjacent row-filter outputs: w[t] = row[t], t < 4 +
// mm - 1, read as 16-byte vectors (row 16-byte aligned), zero past it.
template <typename A> __host__ __device__ constexpr int l1_vn() {
  return 16 / sizeof(A);
}
template <typename A, int MT> __host__ __device__ constexpr int l1_nw() {
  return (L1_V + MT - 1 + l1_vn<A>() - 1) / l1_vn<A>() * l1_vn<A>();
}

// w[t] = row[t], NW values (a multiple of the 16-byte vector), read as
// 16-byte vectors while VN q < n, zero past them.
template <typename A, int NW>
__device__ __forceinline__ void vec_window(const A* row, int n, A w[NW]) {
  constexpr int VN = l1_vn<A>();
#pragma unroll
  for (int q = 0; q < NW / VN; ++q) {
    if (VN * q < n) {
      const Vec<A, VN> pk =
          *reinterpret_cast<const Vec<A, VN>*>(row + VN * q);
#pragma unroll
      for (int u = 0; u < VN; ++u) w[VN * q + u] = pk.v[u];
    } else {
#pragma unroll
      for (int u = 0; u < VN; ++u) w[VN * q + u] = 0;
    }
  }
}

template <typename A, int MT>
__device__ __forceinline__ void row_window(const A* row, int mm, A w[]) {
  vec_window<A, l1_nw<A, MT>()>(row, L1_V + mm - 1, w);
}

}  // namespace dtcwt
