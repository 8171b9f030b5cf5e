// The pieces shared by the (H, W) stage-pair kernels of the 3-D DTCWT (CUDA
// C++, sm_90a): hw.cu's analysis hw22_kernel (hwana.cuh: filter_hw22,
// dfilt_hw22) and synthesis sum_hw22_kernel (hwsum.cuh: filter_sum_hw22,
// ifilt_sum_hw22), and the level-1 and level-2 analysis kernel of the
// unsharded transform, fpack.cu's fwd_pack_kernel (fpack.cuh), which runs
// hw22's per-slice stages on each slice of a depth branch.  All write
// 32 x 32 output tiles of a depth slice; all stage their input area (the
// tile plus the filters' reach) in shared memory through row and column
// maps folded once a block; all take their taps by value under a
// compile-time bound the host chooses; all run the W stage on register
// windows of a staged row and the H stage on register windows down a
// column.  The 3-D synthesis kernel (ipack.cuh) takes the block size, the
// shared memory cap and cp_async_value from here.
//
// Here: the block size, the tile side and the staging of images through
// the maps (the taps struct, its filling from the host plan and the
// instance sets' tap bounds are taps.cuh's, shared with the 1-D stream
// sums): 16-byte cp.async chunks where a row is stored in order (filter,
// dfilt), a value an item where its cells are split by column parity
// (ifilt); the host's tile, its tap bound (hs_fill) and the launch over the
// tiles (launch_tiles).  A geometry G (HaGeo, HsGeo, FpGeo) gives the
// staged area: X x X cells at row stride XS, XN values an image, G::ROWS
// where a row's cells are in order, G::cell(r, col), and the dynamic
// shared memory G::SMEM.
#pragma once

#include <climits>

#include "l1tile.cuh"
#include "taps.cuh"

namespace dtcwt {

constexpr int PACK_THREADS = 256;                // threads a block
constexpr size_t PACK_SMEM_MAX = 220 * 1024;     // dynamic shared memory cap
constexpr int HS_TILE = 32;                      // output tile side

// One value from device memory into shared memory, asynchronously
// (cp.async; the caller waits for it).
template <typename A>
__device__ __forceinline__ void cp_async_value(A* smem, const A* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(sizeof(A))
               : "memory");
}

// Shared memory of n_x staged images of xn values, two W-stage images of
// vn and two int maps of x.
template <typename A>
__host__ __device__ constexpr size_t hs_bytes(int n_x, int xn, int vn,
                                              int x) {
  return sizeof(A) * (static_cast<size_t>(n_x) * xn + 2 * vn) +
         sizeof(int) * 2 * x;
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
// for the copies (WAIT; else the caller waits with cp_async_wait_all(), so
// that the copies run on under other work).  The caller syncs.  A
// row-major geometry (G::ROWS), where vec (the row width and the inputs
// aligned to a chunk): an item is a chunk of CW cells of a row, copied as
// one vector where the map runs on in order (16-byte asynchronous copies;
// bfloat16 an 8-byte load, converted), else a cell at a time; otherwise
// (ifilt, its cells split by column parity) an item is a cell.
template <typename T, typename G, int NX, bool WAIT = true>
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
              cp_async16(dst + i * G::XN, src[i] + row + c0);
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
      if constexpr (WAIT && sizeof(T) == sizeof(A)) cp_async_wait_all();
      return;
    }
  }
  for (int it = threadIdx.x; it < G::X * G::X; it += PACK_THREADS) {
    const int r = it / G::X, col = it - r * G::X;
    hs_copy<T, NX, G::XN>(src,
                          static_cast<int64_t>(rmap[r]) * W + cmap[col],
                          xs + G::cell(r, col));
  }
  if constexpr (WAIT && sizeof(T) == sizeof(A)) cp_async_wait_all();
}

// The host's tile of a kernel on these pieces (ops/hwtile.py
// _hw22_geometry, _fwd_pack_geometry; ops/hw.py _sum_hw22_geometry): OH x
// OW output samples, the tap bound MT, the staged area XR x XC and the
// dynamic shared memory in bytes.
struct HwTile {
  int oh, ow, mt, xr, xc, smem;
};

// Launch kernel (geometry G) over the 32 x 32 output tiles of N slices of
// Ho x Wo if the host's tile is the instance's: kernel(args..., n_th,
// n_tw, tp).
template <typename G, typename K, typename Taps, typename... Args>
cudaError_t launch_tiles(K kernel, const HwTile& tile, int N, int Ho,
                         int Wo, cudaStream_t stream, const Taps& tp,
                         Args... args) {
  constexpr size_t smem = G::SMEM;
  if (tile.oh != HS_TILE || tile.ow != HS_TILE || tile.xr != G::X ||
      tile.xc != G::X || static_cast<size_t>(tile.smem) != smem)
    return cudaErrorInvalidValue;
  const int n_th = (Ho + HS_TILE - 1) / HS_TILE;
  const int n_tw = (Wo + HS_TILE - 1) / HS_TILE;
  const int64_t blocks = static_cast<int64_t>(N) * n_th * n_tw;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), PACK_THREADS, smem, stream>>>(
      args..., n_th, n_tw, tp);
  return cudaGetLastError();
}

// The plan's taps at the least tap bound of the instance set that holds
// them, which must be the host's (tile.mt); 0 otherwise.
template <typename A, int P>
int hs_fill(HsTaps<A, P>* tp, const double* taps, const int* lens,
            const int* offs, const HwTile& tile) {
  int mt = 0;
  for (int e = 0; e < HS_BOUNDS && !mt; ++e)
    if (make_hs_taps<A, P>(tp, taps, lens, offs, hs_bound<P>(e)))
      mt = hs_bound<P>(e);
  return mt == tile.mt ? mt : 0;
}

}  // namespace dtcwt
