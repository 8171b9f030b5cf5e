// The pieces shared by the two (H, W) stage-pair kernels of hw.cu (CUDA
// C++, sm_90a): the analysis hw22_kernel (hwana.cuh: filter_hw22,
// dfilt_hw22) and the synthesis sum_hw22_kernel (hwsum.cuh:
// filter_sum_hw22, ifilt_sum_hw22).  Both write 32 x 32 output tiles of a
// depth slice; both stage their input area (the tile plus the filters'
// reach) in shared memory through row and column maps folded once a block;
// both take their taps by value under a compile-time bound the host
// chooses; both run the W stage on register windows of a staged row and
// the H stage on register windows down a column.
//
// Here: the tile side, the taps struct and its filling from the host plan
// (the taps centred on the halo of the bound), the instance sets' tap
// bounds, and the staging of images through the maps: 16-byte cp.async
// chunks where a row is stored in order (filter, dfilt), a value an item
// where its cells are split by column parity (ifilt).  A geometry G (HaGeo,
// HsGeo) gives the staged area: X x X cells at row stride XS, XN values an
// image, G::ROWS where a row's cells are in order, G::cell(r, col).
#pragma once

#include "hwstage.cuh"
#include "l1tile.cuh"

namespace dtcwt {

constexpr int HS_TILE = 32;  // output tile side
constexpr int HS_K = 33;     // the largest tap bound

// The two branch filters' taps by value: t[b][s][m] multiplies the window
// sample m of stream s of branch b (ifilt: of the parity (s & 1) ^ sw[b];
// dfilt: of the parity s, the host having swapped the streams where sw[b]).
template <typename A, int P> struct HsTaps {
  A t[2][P][HS_K];
  int sw[2];
};

// Shared memory of n_x staged images of xn values, two W-stage images of
// vn and two int maps of x.
template <typename A>
__host__ __device__ constexpr size_t hs_bytes(int n_x, int xn, int vn,
                                              int x) {
  return sizeof(A) * (static_cast<size_t>(n_x) * xn + 2 * vn) +
         sizeof(int) * 2 * x;
}

// 16 bytes from device memory into shared memory, asynchronously.
template <typename A>
__device__ __forceinline__ void hs_cp_async16(A* smem, const A* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Values a chunk of the row-major staging: 16 bytes (bfloat16: 8, four
// values as for float32).
template <typename T> __host__ __device__ constexpr int hs_chunk() {
  return sizeof(T) == 8 ? 2 : 4;
}

// Copy NX images' cells at offset off of each src[i] to dst + i XN.
template <typename T, int NX, int XN>
__device__ __forceinline__ void hs_copy(const T* const (&src)[NX],
                                        int64_t off,
                                        typename AccOf<T>::type* dst) {
  using A = typename AccOf<T>::type;
  if constexpr (sizeof(T) == sizeof(A)) {
#pragma unroll
    for (int i = 0; i < NX; ++i) cp_async_value(dst + i * XN, src[i] + off);
  } else {
    A v[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) v[i] = load(src[i] + off);
#pragma unroll
    for (int i = 0; i < NX; ++i) dst[i * XN] = v[i];
  }
}

// Stage NX images: cell (r, col) of image i is src[i][rmap[r] W +
// cmap[col]], all NX images' values of a cell from one offset; then wait
// for the copies.  The caller syncs.  A row-major geometry (G::ROWS), where
// vec (the row width and the inputs aligned to a chunk): an item is a
// chunk of CW cells of a row, copied as one vector where the map runs on in
// order (16-byte asynchronous copies; bfloat16 an 8-byte load, converted),
// else a cell at a time; otherwise (ifilt, its cells split by column
// parity) an item is a cell.
template <typename T, typename G, int NX>
__device__ __forceinline__ void hs_stage(const T* const (&src)[NX],
                                         typename AccOf<T>::type* xs,
                                         const int* rmap, const int* cmap,
                                         int W, bool vec) {
  using A = typename AccOf<T>::type;
  constexpr int CW = hs_chunk<T>();
  if constexpr (G::ROWS) {
    if (vec) {
      constexpr int NC = G::X / CW;  // chunks a row
      for (int it = threadIdx.x; it < G::X * NC; it += PACK_THREADS) {
        const int r = it / NC, col = (it - r * NC) * CW;
        const int c0 = cmap[col];
        const int64_t row = static_cast<int64_t>(rmap[r]) * W;
        A* dst = xs + r * G::XS + col;
        if (cmap[col + CW - 1] == c0 + CW - 1 && c0 % CW == 0) {
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            if constexpr (sizeof(T) == sizeof(A)) {
              hs_cp_async16(dst + i * G::XN, src[i] + row + c0);
            } else {
              const Vec<T, CW> pk =
                  *reinterpret_cast<const Vec<T, CW>*>(src[i] + row + c0);
              Vec<A, CW> o;
#pragma unroll
              for (int e = 0; e < CW; ++e) o.v[e] = load(&pk.v[e]);
              *reinterpret_cast<Vec<A, CW>*>(dst + i * G::XN) = o;
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < CW; ++e)
            hs_copy<T, NX, G::XN>(src, row + cmap[col + e], dst + e);
        }
      }
      if constexpr (sizeof(T) == sizeof(A))
        asm volatile("cp.async.wait_all;\n" ::: "memory");
      return;
    }
  }
  for (int it = threadIdx.x; it < G::X * G::X; it += PACK_THREADS) {
    const int r = it / G::X, col = it - r * G::X;
    hs_copy<T, NX, G::XN>(src,
                          static_cast<int64_t>(rmap[r]) * W + cmap[col],
                          xs + G::cell(r, col));
  }
  if constexpr (sizeof(T) == sizeof(A))
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tap bounds of an instance set, 5 of each: P = 1 (filter, both
// directions) 5, 7, 9, 19, 31; P = 2 (dfilt) 10, 14, 16, 18, 32; P = 4
// (ifilt) 5, 7, 9, 17, 33.
constexpr int HS_BOUNDS = 5;
template <int P> constexpr int hs_bound(int e) {
  constexpr int b1[HS_BOUNDS] = {5, 7, 9, 19, 31};
  constexpr int b2[HS_BOUNDS] = {10, 14, 16, 18, 32};
  constexpr int b4[HS_BOUNDS] = {5, 7, 9, 17, HS_K};
  return P == 1 ? b1[e] : P == 2 ? b2[e] : b4[e];
}

// Fill *tp from the host plan (taps [2][P][MAX_TAPS], lens and offs
// [2][P]: stream s of branch b reads x[D g + offs + S k], k < lens) centred
// on the halo of bound mt; false where a stream does not fit in it.
template <typename A, int P>
bool make_hs_taps(HsTaps<A, P>* tp, const double* taps, const int* lens,
                  const int* offs, int mt) {
  if (mt > HS_K) return false;
  const int ph = (mt - 1) / 2;
  for (int b = 0; b < 2; ++b) {
    // qshift: the parity of stream 0's first sample sets the swap
    const int sw = P == 1 ? 0 : (offs[b * P] + 2 * ph) & 1;
    tp->sw[b] = sw;
    for (int s = 0; s < P; ++s) {
      const int len = lens[b * P + s];
      // the stream's first tap's window index: filter ph + off; qshift the
      // half-index shift d / 2 of d = off + 2 ph
      const int d = P == 1 ? ph + offs[b * P + s] : offs[b * P + s] + 2 * ph;
      const int sh = P == 1 ? d : d >> 1;
      if (len < 1 || len > MAX_TAPS || d < 0 || sh + len > mt ||
          (P > 1 && (d & 1) != ((s & 1) ^ sw)))
        return false;
      for (int k = 0; k < HS_K; ++k) {
        const int kk = k - sh;
        tp->t[b][s][k] =
            kk >= 0 && kk < len
                ? static_cast<A>(taps[(b * P + s) * MAX_TAPS + kk])
                : A(0);
      }
    }
  }
  return true;
}

// The host's tile of an hw kernel (ops/hw.py _hw22_geometry,
// _sum_hw22_geometry): OH x OW output samples, the tap bound MT, the staged
// area XR x XC and the dynamic shared memory in bytes.
struct HwTile {
  int oh, ow, mt, xr, xc, smem;
};

}  // namespace dtcwt
