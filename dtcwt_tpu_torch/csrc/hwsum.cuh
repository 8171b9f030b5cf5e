// The synthesis (H, W) stage-pair kernel of hw.cu, sum_hw22_kernel (CUDA
// C++, sm_90a): filter_sum_hw22 (P = 1 output stream a stage, the biort
// pair g0o / g1o) and ifilt_sum_hw22 (P = 4, the interpolating qshift
// pairs (g0b, g0a) / (g1b, g1a)).  Per depth slice a block writes the
// 32 x 32 output tile of
//
//   y = sum_{j,k} F_H(g_j) F_W(g_k) v[j][k].
//
// Replaces _build_sum_hw22 of dtcwt_tpu/ops/pallas_hw.py (two dense
// operator products a slice on the TPU's matrix unit; here a direct FIR).
//
// Bound on the H100: device memory bytes.  Each output sample reads four
// input samples (ifilt: one) and writes one, 20 bytes in f32 (ifilt 8),
// against 2 (m0 + m1) multiply-adds of the W stage a staged row sample and
// the H stage's per output.  What held the first port back was the work it
// issued per byte: it staged the four inputs one after another, a sample at
// a time with a reflect() on both axes and a division by the run-time row
// width, between two syncs each round; its W and H stages ran tap loops of
// run-time length over a copy of the taps in shared memory (two shared
// loads a multiply-add, the output stream found by a division), and the W
// stage summed its two branches by a read-modify-write in shared memory,
// a pass and a sync per branch.  This design (that of the 3-D synthesis
// kernels in ipack.cuh, in one round):
//
// * All of a block's loads in flight.  The rows and columns of the staged
//   area are folded once per block into maps (fold() of common.cuh, any
//   number of times, so extents shorter than the filter work).  A staging
//   item copies from all four inputs at one offset, asynchronously
//   (cp.async; bfloat16: loads, converted), then one wait and one sync.
//   filter's staged area starts 16 bytes aligned where the tile does, and
//   its item is a chunk of 4 values of a row (float64 2), one 16-byte copy
//   an input where the map runs on in order (inputs and rows aligned),
//   else a value an item (1.1x the time).  ifilt's item is a value (its
//   cells are split by parity: chunks loaded into registers and stored as
//   pairs took 1.24x the time).  Where the four images do not fit in
//   shared memory, the float64 qshift instance at the largest tap bound,
//   two rounds stage two images each.
// * Taps by value in the kernel's parameters (HsTaps), under a compile-time
//   bound MT the host chooses (filter 5, 7, 9, 19 or 31; ifilt 5, 7, 9, 17
//   or 33; every dtype), centred on a common halo MT / 2: every tap loop
//   runs to MT with register indices and no guard, the taps past a filter's
//   own being zero.  The largest bounds hold every filter the plans take
//   (odd filters of 31 taps, qshift pairs of 64).
// * Register windows.  The W stage's item is 4 consecutive outputs of a
//   staged row (ifilt: 8, two groups of the four streams) for one H branch
//   j, read from a window of each W branch k (ifilt: two parity windows),
//   both k summed in registers; it writes the W-stage image of j once.
//   The H stage: a thread owns 4 output rows of one column (ifilt: one
//   group of the four streams), both j summed in registers from windows
//   down the column, and stores with lanes on consecutive output columns.
// * ifilt reads every other sample (S = 2): its staged images and W-stage
//   images are split by column and by row parity, so that a stream's window
//   is contiguous.  The staged area starts on an even sample, so a cell's
//   parity is its sample's: the streams' order (ifilt_streams, the sign of
//   sum(ha hb) and m/2 % 2) is the swap sw of each branch.
// * No register cap: 31-40 registers in float32 and bfloat16, 39-64 in
//   float64, no spills but in the float64 ifilt instance at 33 taps; the
//   shared memory (36 KB for filter at 5-9 taps, 16 KB for ifilt at 5 in
//   float32) leaves an SM six and eight blocks.
//
// The host (ops/hw.py _sum_hw22_geometry, _sum_tap_bound) chooses the tile,
// the tap bound and the shared memory and passes them in; the C entry
// refuses any other (hw.cu launch_tiles, sum_hw22_mt).  tests/test_torch_hw_tiling.py
// replays the tiling on the CPU, block by block.  The pieces it shares with
// the analysis kernel hw22_kernel (hwana.cuh), which runs the same design
// the other way (one input staged, four outputs fanned out from the
// windows), are in hwtile.cuh: the tile side, HsTaps and make_hs_taps, the
// tap bounds, the staging through the maps (hs_stage over a geometry:
// HsGeo here).
#pragma once

#include "hwtile.cuh"

namespace dtcwt {

// The compile-time geometry of an instance: P streams (1: filter, 4:
// ifilt), tap bound MT, accumulator type A.
template <typename A, int P, int MT> struct HsGeo {
  static constexpr int PH = (MT - 1) / 2;  // the common halo
  // staged samples before the tile's first input sample: filter the halo
  // rounded up to 4, so that the staged area starts 16 bytes aligned where
  // the tile does; ifilt (input at half the output's resolution) 2 PH
  static constexpr int SO = P == 1 ? (PH + 3) / 4 * 4 : 2 * PH;
  // filter: the windows' shift into the staged area, SO - PH
  static constexpr int DL = P == 1 ? SO - PH : 0;
  // staged rows and columns (square), from an even sample: filter the
  // tile and SO each side; ifilt the tile's 16 and SO before, 2 (MT - 1)
  // - SO after
  static constexpr int X =
      P == 1 ? HS_TILE + 2 * SO : HS_TILE / 2 + 2 * MT - 2;
  // ifilt: a staged row's parity half, >= X / 2 and 4 (mod 8) wide, so
  // that the W stage's 8-byte window loads of 4 consecutive rows hit
  // distinct banks
  static constexpr int XH = P == 1 ? 0 : (X / 2 + 3) / 8 * 8 + 4;
  static constexpr int XS = P == 1 ? X : 2 * XH;  // staged row stride
  static constexpr int XN = X * XS;               // one staged image
  static constexpr int VN = X * HS_TILE;          // one W-stage image
  static constexpr int VV = 16 / sizeof(A);      // values a 16-byte vector
  // filter's W window: 4 outputs from sample DL on, in 16-byte vectors
  static constexpr int NW = (DL + MT + 3 + VV - 1) / VV * VV;
  // staging rounds: 1 (all four images), or 2 of two where four do not fit
  static constexpr int NR =
      hs_bytes<A>(4, XN, VN, X) <= PACK_SMEM_MAX ? 1 : 2;
  static constexpr int NX = 4 / NR;  // images staged a round
  // dynamic shared memory: the staged images [NX][X][XS], the W stage's
  // [2 j][X][32] and the row and column maps [X] each
  static constexpr size_t SMEM = hs_bytes<A>(NX, XN, VN, X);
  // staged cell (r, col) of an image: filter row-major, ifilt the
  // column's parity half
  static constexpr bool ROWS = P == 1;
  static __device__ __forceinline__ int cell(int r, int col) {
    if constexpr (P == 1) return r * XS + col;
    return r * XS + (col & 1) * XH + (col >> 1);
  }
  static_assert(P != 1 || (X % 4 == 0 && NW <= 4 + 2 * SO), "windows");
  static_assert(SMEM <= PACK_SMEM_MAX, "shared memory");
};

// The W stage of the H branches j0 .. j0 + NX / 2 - 1, staged as images
// 2 (j - j0) + k: vw[j] = sum_k F_W(g_k) v[j][k] at the tile's 32 output
// columns of every staged row (ifilt: vw split by row parity).
template <typename A, int P, int MT, int NX>
__device__ __forceinline__ void hs_wstage(const A* xs, A* vw, int j0,
                                          const HsTaps<A, P>& tp) {
  using G = HsGeo<A, P, MT>;
  constexpr int VV = G::VV;
  constexpr int NJ = NX / 2;  // H branches this round
  if constexpr (P == 1) {
    // an item: outputs 4 q .. 4 q + 3 of row r, H branch j0 + jj
    for (int it = threadIdx.x; it < NJ * G::X * 8; it += PACK_THREADS) {
      const int q = it & 7, rr = it >> 3;
      const int jj = rr / G::X, r = rr - jj * G::X;
      A acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        A w[G::NW];
        vec_window<A, G::NW>(xs + (2 * jj + k) * G::XN + r * G::XS + 4 * q,
                             G::NW, w);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const A t = tp.t[k][0][m];
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[v] += t * w[G::DL + v + m];
        }
      }
      A* o = vw + ((j0 + jj) * G::X + r) * HS_TILE + 4 * q;
#pragma unroll
      for (int e = 0; e < 4 / VV; ++e) {
        Vec<A, VV> pk;
#pragma unroll
        for (int t = 0; t < VV; ++t) pk.v[t] = acc[e * VV + t];
        reinterpret_cast<Vec<A, VV>*>(o)[e] = pk;
      }
    }
  } else {
    // an item: the 8 outputs of groups 2 q, 2 q + 1 (output 4 g + s) of
    // row r, H branch j0 + jj, from two parity windows of MT + 1 samples
    constexpr int NW = MT + 1;
    for (int it = threadIdx.x; it < NJ * G::X * 4; it += PACK_THREADS) {
      const int q = it & 3, rr = it >> 2;
      const int jj = rr / G::X, r = rr - jj * G::X;
      A acc[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[v] = 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const A* row = xs + (2 * jj + k) * G::XN + r * G::XS + 2 * q;
        const int sw = tp.sw[k];
        A wa[NW], wb[NW];
#pragma unroll
        for (int e = 0; e < NW / 2; ++e) {
          const Vec<A, 2> pa =
              reinterpret_cast<const Vec<A, 2>*>(row + sw * G::XH)[e];
          const Vec<A, 2> pb =
              reinterpret_cast<const Vec<A, 2>*>(row + (1 - sw) * G::XH)[e];
          wa[2 * e] = pa.v[0];
          wa[2 * e + 1] = pa.v[1];
          wb[2 * e] = pb.v[0];
          wb[2 * e + 1] = pb.v[1];
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const A t = tp.t[k][s][m];
            const A* w = s & 1 ? wb : wa;
#pragma unroll
            for (int v = 0; v < 2; ++v) acc[4 * v + s] += t * w[v + m];
          }
      }
      A* o = vw +
             ((j0 + jj) * G::X + (r & 1) * (G::X / 2) + (r >> 1)) * HS_TILE +
             8 * q;
#pragma unroll
      for (int e = 0; e < 8 / VV; ++e) {
        Vec<A, VV> pk;
#pragma unroll
        for (int t = 0; t < VV; ++t) pk.v[t] = acc[e * VV + t];
        reinterpret_cast<Vec<A, VV>*>(o)[e] = pk;
      }
    }
  }
}

// The H stage: acc[v] = sum_j F_H(g_j) vw[j] at this thread's 4 output
// rows 4 rg + v of column col.
template <typename A, int P, int MT>
__device__ __forceinline__ void hs_hstage(const A* vw, int rg, int col,
                                          const HsTaps<A, P>& tp,
                                          A acc[4]) {
  using G = HsGeo<A, P, MT>;
#pragma unroll
  for (int v = 0; v < 4; ++v) acc[v] = 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if constexpr (P == 1) {
      A w[MT + 3];
      const A* s = vw + (j * G::X + 4 * rg + G::DL) * HS_TILE + col;
#pragma unroll
      for (int t = 0; t < MT + 3; ++t) w[t] = s[t * HS_TILE];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const A t = tp.t[j][0][m];
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[v] += t * w[v + m];
      }
    } else {
      // output rows 4 rg + s read rows 2 (rg + m) + parity of the W-stage
      // image, its parity halves X / 2 rows apart
      const int sw = tp.sw[j];
      const A* s = vw + (j * G::X + rg) * HS_TILE + col;
      A wa[MT], wb[MT];
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        wa[t] = s[(sw * (G::X / 2) + t) * HS_TILE];
        wb[t] = s[((1 - sw) * (G::X / 2) + t) * HS_TILE];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4)
          acc[s4] += tp.t[j][s4][m] * (s4 & 1 ? wb : wa)[m];
    }
  }
}

// The kernel's body (the entries below differ in their launch bounds):
// v_jk [N, H, W] -> y [N, Ho, Wo], one 32 x 32 output tile a block.
template <typename T, int P, int MT>
__device__ __forceinline__ void sum_hw22_body(
    const T* __restrict__ v00, const T* __restrict__ v01,
    const T* __restrict__ v10, const T* __restrict__ v11, T* __restrict__ y,
    int H, int W, int Ho, int Wo, int n_th, int n_tw,
    const HsTaps<typename AccOf<T>::type, P>& tp) {
  using A = typename AccOf<T>::type;
  using G = HsGeo<A, P, MT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* xs = reinterpret_cast<A*>(smem_raw);  // [NX][X][XS]
  A* vw = xs + G::NX * G::XN;              // [2 j][X][32]
  int* rmap = reinterpret_cast<int*>(vw + 2 * G::VN);  // [X] source row
  int* cmap = rmap + G::X;                             // [X] source column

  const int tid = threadIdx.x;
  int64_t blk = blockIdx.x;
  const int tw = static_cast<int>(blk % n_tw);
  blk /= n_tw;
  const int th = static_cast<int>(blk % n_th);
  const int64_t n = blk / n_th;
  const int o0r = th * HS_TILE, o0c = tw * HS_TILE;
  // the staged area's first sample, even
  const int rs = (P == 1 ? o0r : o0r / 2) - G::SO;
  const int cs = (P == 1 ? o0c : o0c / 2) - G::SO;
  for (int t = tid; t < G::X; t += PACK_THREADS) {
    rmap[t] = fold(rs + t, H);
    cmap[t] = fold(cs + t, W);
  }
  __syncthreads();

  const int64_t slice = n * H * static_cast<int64_t>(W);
  const T* const v[4] = {v00 + slice, v01 + slice, v10 + slice, v11 + slice};
  // the chunked staging: rows and inputs aligned to a chunk
  constexpr int CB = hs_chunk<T>() * sizeof(T);
  const bool vec = W % hs_chunk<T>() == 0 &&
                   (reinterpret_cast<uintptr_t>(v00) |
                    reinterpret_cast<uintptr_t>(v01) |
                    reinterpret_cast<uintptr_t>(v10) |
                    reinterpret_cast<uintptr_t>(v11)) % CB == 0;
#pragma unroll
  for (int round = 0; round < G::NR; ++round) {
    // the images v[j][k] of this round's H branches, image 2 (j - j0) + k
    const T* src[G::NX];
#pragma unroll
    for (int i = 0; i < G::NX; ++i) src[i] = v[round * G::NX + i];
    hs_stage<T, G, G::NX>(src, xs, rmap, cmap, W, vec);
    __syncthreads();
    hs_wstage<A, P, MT, G::NX>(xs, vw, round * G::NX / 2, tp);
    __syncthreads();  // the W stage read xs and wrote vw
  }

  const int rg = tid >> 5, col = tid & 31;
  A acc[4];
  hs_hstage<A, P, MT>(vw, rg, col, tp, acc);
  const int goc = o0c + col;
  if (goc < Wo) {
#pragma unroll
    for (int v4 = 0; v4 < 4; ++v4) {
      const int gor = o0r + 4 * rg + v4;
      if (gor < Ho)
        store(y + (n * Ho + gor) * static_cast<int64_t>(Wo) + goc, acc[v4]);
    }
  }
}

// The kernel.  No register cap: ptxas gives the float32 instances 32-40
// registers; a cap for four blocks an SM (__launch_bounds__(256, 4)) gave
// them 38-40 and took 1.05x the time on ifilt (PERF.md).
template <typename T, int P, int MT>
__global__ void __launch_bounds__(PACK_THREADS) sum_hw22_kernel(
    const T* __restrict__ v00, const T* __restrict__ v01,
    const T* __restrict__ v10, const T* __restrict__ v11, T* __restrict__ y,
    int H, int W, int Ho, int Wo, int n_th, int n_tw,
    const __grid_constant__ HsTaps<typename AccOf<T>::type, P> tp) {
  sum_hw22_body<T, P, MT>(v00, v01, v10, v11, y, H, W, Ho, Wo, n_th, n_tw,
                          tp);
}

}  // namespace dtcwt
