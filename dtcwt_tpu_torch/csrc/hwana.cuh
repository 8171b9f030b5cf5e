// The analysis (H, W) stage-pair kernel of hw.cu, hw22_kernel (CUDA C++,
// sm_90a): filter_hw22 (P = 1 output stream a stage, the biort pair
// h0o / h1o: [N, H, W] -> four [N, H, W]) and dfilt_hw22 (P = 2, the
// decimating qshift pairs (h0b, h0a) / (h1b, h1a): four [N, H/2, W/2]).
// Per depth slice a block writes the 32 x 32 output tile of each of
//
//   u[j][k] = F_H(h_j) F_W(h_k) x.
//
// Replaces _build_hw22 of dtcwt_tpu/ops/pallas_hw.py (two dense operator
// products a slice on the TPU's matrix unit; here a direct FIR).  The 3-D
// analysis kernel of the unsharded transform (fpack.cuh) runs its stages,
// ha_wstage and ha_hcol, on each slice of a depth branch.
//
// Bound on the H100: device memory bytes.  Each input sample is read once
// and four outputs are written (filter: 20 bytes an f32 input sample, 80%
// of them stores; dfilt 8), against 2 m multiply-adds of the W stage a
// staged sample and 2 m of the H stage an output (m taps; dfilt m a
// stream, every other sample).  What the design avoids: staging a sample
// at a time (a reflect() on both axes and a division each), tap loops of
// run-time length over taps in shared memory (two shared loads a
// multiply-add), each output of each branch computed from its own loads
// (every window loaded once an output), and a row-major tile read two
// samples apart (two-way bank conflicts).  It is the synthesis kernel's
// design (hwsum.cuh) run the other way:
//
// * All of a block's loads in flight.  The rows and columns of the staged
//   area are folded once a block into maps (fold() of common.cuh, any
//   number of times, so extents shorter than the filter work); the one
//   input is staged row-major (hs_stage of hwtile.cuh) in 16-byte cp.async
//   chunks where the map runs on in order and the rows and input are
//   aligned, else a value an item (bfloat16: loaded and converted); then
//   one wait and one sync.  The staged area starts 16 bytes aligned where
//   the tile's first input sample does (SO: the halo rounded up to 4), and
//   the windows shift by the rest (DL).
// * Taps by value in the kernel's parameters (HsTaps), under a compile-time
//   bound MT the host chooses (filter 5, 7, 9, 19 or 31; dfilt 10, 14, 16,
//   18 or 32 a stream; every dtype), centred on the halo: every tap loop
//   runs to MT with register indices and no guard, the taps past a
//   filter's own being zero.  The largest bounds hold every filter the
//   plans take (odd filters of 31 taps, qshift pairs of 32).
// * Register windows, fanning out.  The W stage's item is 4 consecutive
//   outputs of a staged row: one window of the row (16-byte loads) feeds
//   both W branches k, and it writes each W-stage image once (16-byte
//   stores).  The H stage: a thread owns 4 output rows of one column; one
//   window down the column of W-stage image k feeds both H branches j, so
//   that it writes u[0][k] and u[1][k]; it stores with lanes on
//   consecutive output columns (a warp writes whole sectors), every output
//   sample of the four once.
// * dfilt reads every other sample (D = 4, S = 2): Y[2 g + s] = sum_k
//   t[s][k] x[4 g + off_s + 2 k], its two streams on the two parities in an
//   order set by the pair (level2.dfilt_streams: the sign of sum(ha hb)).
//   Its staged area starts on an even sample, so a cell's parity is its
//   sample's.  The window of 4 outputs (2 pairs) is 2 MT + 4 contiguous
//   samples read as 16-byte vectors; the parities are split in registers
//   (taps by parity, the host swapping a branch's streams where its first
//   stream reads the odd samples) and the swap sw places each parity's sum
//   on its output.  The W stage runs two rows by four items a 16-byte
//   phase and pads the row stride to 4 (mod 8) values, so that the
//   window loads hit distinct banks (8 items a row and no padding took
//   1.04x the time in float32 and 1.19x in float64 on the large shards).
// * No register cap: 32-40 registers in float32 and bfloat16, 42-61 in
//   float64, no spills; the shared memory (17 KB for filter at 5-9 taps,
//   47 KB for dfilt at 10 in float32) leaves an SM eight and four blocks.
//   A 16-row dfilt tile (twice the blocks) took 1.09x the time.
//
// The host (ops/hwtile.py _hw22_geometry, _hw22_tap_bound) chooses the
// tile, the tap bound and the shared memory and passes them in; the C entry
// refuses any other (hwtile.cuh launch_tiles, hw.cu hw22_mt).
// tests/test_torch_hw_tiling.py replays the tiling on the CPU, block by
// block.
#pragma once

#include "hwtile.cuh"

namespace dtcwt {

// The compile-time geometry of an instance: P streams (1: filter, 2:
// dfilt), tap bound MT, accumulator type A.
template <typename A, int P, int MT> struct HaGeo {
  static_assert(P == 1 || P == 2, "filter or dfilt");
  static constexpr int PH = (MT - 1) / 2;  // the halo in window steps
  static constexpr int HALO = P * PH;      // ... in input samples
  // staged samples before the tile's first input sample: the halo rounded
  // up to 4, so that the staged area starts 16 bytes aligned (and even)
  static constexpr int SO = (HALO + 3) / 4 * 4;
  static constexpr int DL = SO - HALO;  // the windows' shift
  // staged rows and columns (square): the tile's P x 32 input samples and
  // SO each side
  static constexpr int X = P * HS_TILE + 2 * SO;
  // staged row stride: dfilt's padded to 4 (mod 8) values
  static constexpr int XS = P == 1 || X % 8 == 4 ? X : X + 4;
  static constexpr int XN = X * XS;      // the staged image
  static constexpr int VN = X * HS_TILE;  // one W-stage image [X][32]
  static constexpr int VV = 16 / sizeof(A);  // values a 16-byte vector
  // samples a window of 4 outputs reads from DL on (filter MT + 3, dfilt
  // 2 (MT + 1) + 2), and the W stage's window in 16-byte vectors
  static constexpr int NS = P == 1 ? MT + 3 : 2 * MT + 4;
  static constexpr int NW = (DL + NS + VV - 1) / VV * VV;
  // dynamic shared memory: the staged image [X][XS], the W stage's
  // [2 k][X][32] and the row and column maps [X] each
  static constexpr size_t SMEM = hs_bytes<A>(1, XN, VN, X);
  static constexpr bool ROWS = true;
  static __device__ __forceinline__ int cell(int r, int col) {
    return r * XS + col;
  }
  static_assert(X % 4 == 0 && XS % 4 == 0 && NW <= 4 * P + 2 * SO,
                "windows");
  static_assert(SMEM <= PACK_SMEM_MAX, "shared memory");
};

// The W stage: vw[k] = F_W(h_k) x at the tile's 32 output columns of every
// staged row.  An item: outputs 4 q .. 4 q + 3 of staged row r, from one
// window of the row.
template <typename A, int P, int MT>
__device__ __forceinline__ void ha_wstage(const A* xs, A* vw,
                                          const HsTaps<A, P>& tp) {
  using G = HaGeo<A, P, MT>;
  constexpr int VV = G::VV;
  for (int it = threadIdx.x; it < G::X * 8; it += PACK_THREADS) {
    int q, r;
    if constexpr (P == 1) {
      // 8 items a row: a 16-byte phase reads 32 consecutive values
      q = it & 7;
      r = it >> 3;
    } else {
      // items 0-3 (or 4-7) of rows 2 i and 2 i + 1 a 16-byte phase: their
      // windows start 8 values apart, the rows 4 (mod 8) apart
      q = (it & 3) | (it >> 1 & 4);
      r = (it >> 4) * 2 + (it >> 2 & 1);
    }
    A w[G::NW];
    vec_window<A, G::NW>(xs + r * G::XS + 4 * P * q, G::NW, w);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      A acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if constexpr (P == 1) {
          const A t = tp.t[k][0][m];
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[v] += t * w[G::DL + v + m];
        } else {
          // pair gg, parity p: window sample 4 gg + p + 2 m
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const A t = tp.t[k][p][m];
#pragma unroll
            for (int gg = 0; gg < 2; ++gg)
              acc[2 * gg + p] += t * w[G::DL + 4 * gg + p + 2 * m];
          }
        }
      }
      if constexpr (P == 2) {
        // parity p is stream p ^ sw: output 2 gg + (p ^ sw)
        const bool sw = tp.sw[k];
#pragma unroll
        for (int gg = 0; gg < 2; ++gg) {
          const A a0 = acc[2 * gg], a1 = acc[2 * gg + 1];
          acc[2 * gg] = sw ? a1 : a0;
          acc[2 * gg + 1] = sw ? a0 : a1;
        }
      }
      A* o = vw + (k * G::X + r) * HS_TILE + 4 * q;
#pragma unroll
      for (int e = 0; e < 4 / VV; ++e) {
        Vec<A, VV> pk;
#pragma unroll
        for (int t = 0; t < VV; ++t) pk.v[t] = acc[e * VV + t];
        reinterpret_cast<Vec<A, VV>*>(o)[e] = pk;
      }
    }
  }
}

// The H stage of one W-stage image vk [X][32] at this thread's column col:
// acc[j][v] = output row 4 rg + v of H branch j (rg = the warp), both
// branches fed by one window down the column.
template <typename A, int P, int MT>
__device__ __forceinline__ void ha_hcol(const A* vk, const HsTaps<A, P>& tp,
                                        A (&acc)[2][4]) {
  using G = HaGeo<A, P, MT>;
  const int rg = threadIdx.x >> 5, col = threadIdx.x & 31;
  A w[G::NS];
  const A* s = vk + (4 * P * rg + G::DL) * HS_TILE + col;
#pragma unroll
  for (int t = 0; t < G::NS; ++t) w[t] = s[t * HS_TILE];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if constexpr (P == 1) {
        const A t = tp.t[j][0][m];
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[j][v] += t * w[v + m];
      } else {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const A t = tp.t[j][p][m];
#pragma unroll
          for (int gg = 0; gg < 2; ++gg)
            acc[j][2 * gg + p] += t * w[4 * gg + p + 2 * m];
        }
      }
    }
    if constexpr (P == 2) {
      const bool sw = tp.sw[j];
#pragma unroll
      for (int gg = 0; gg < 2; ++gg) {
        const A a0 = acc[j][2 * gg], a1 = acc[j][2 * gg + 1];
        acc[j][2 * gg] = sw ? a1 : a0;
        acc[j][2 * gg + 1] = sw ? a0 : a1;
      }
    }
  }
}

// The H stage and the stores: thread (rg, col) owns output rows 4 rg ..
// 4 rg + 3 of column col of all four outputs; for each W branch k one
// window down the column of vw[k] feeds both H branches j.
template <typename T, int P, int MT>
__device__ __forceinline__ void ha_hstage(
    const typename AccOf<T>::type* vw, T* const (&u)[4], int o0r, int o0c,
    int Ho, int Wo, const HsTaps<typename AccOf<T>::type, P>& tp) {
  using A = typename AccOf<T>::type;
  using G = HaGeo<A, P, MT>;
  const int rg = threadIdx.x >> 5, col = threadIdx.x & 31;
  const int goc = o0c + col;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    A acc[2][4];
    ha_hcol<A, P, MT>(vw + k * G::VN, tp, acc);
    if (goc < Wo) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int gor = o0r + 4 * rg + v;
          if (gor < Ho)
            store(u[2 * j + k] + static_cast<int64_t>(gor) * Wo + goc,
                  acc[j][v]);
        }
    }
  }
}

// The kernel: x [N, H, W] -> u_jk [N, Ho, Wo], one 32 x 32 output tile of
// each a block.  No register cap (as sum_hw22_kernel).
template <typename T, int P, int MT>
__global__ void __launch_bounds__(PACK_THREADS) hw22_kernel(
    const T* __restrict__ x, T* __restrict__ o00, T* __restrict__ o01,
    T* __restrict__ o10, T* __restrict__ o11, int H, int W, int Ho, int Wo,
    int n_th, int n_tw,
    const __grid_constant__ HsTaps<typename AccOf<T>::type, P> tp) {
  using A = typename AccOf<T>::type;
  using G = HaGeo<A, P, MT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* xs = reinterpret_cast<A*>(smem_raw);              // [X][XS]
  A* vw = xs + G::XN;                                  // [2 k][X][32]
  int* rmap = reinterpret_cast<int*>(vw + 2 * G::VN);  // [X] source row
  int* cmap = rmap + G::X;                             // [X] source column

  const int tid = threadIdx.x;
  int64_t blk = blockIdx.x;
  const int tw = static_cast<int>(blk % n_tw);
  blk /= n_tw;
  const int th = static_cast<int>(blk % n_th);
  const int64_t n = blk / n_th;
  const int o0r = th * HS_TILE, o0c = tw * HS_TILE;
  // the staged area's first sample, 16 bytes aligned and even
  const int rs = P * o0r - G::SO, cs = P * o0c - G::SO;
  for (int t = tid; t < G::X; t += PACK_THREADS) {
    rmap[t] = fold(rs + t, H);
    cmap[t] = fold(cs + t, W);
  }
  __syncthreads();

  // the chunked staging: rows and input aligned to a chunk
  constexpr int CB = hs_chunk<T>() * sizeof(T);
  const bool vec = W % hs_chunk<T>() == 0 &&
                   reinterpret_cast<uintptr_t>(x) % CB == 0;
  const T* const src[1] = {x + n * H * static_cast<int64_t>(W)};
  hs_stage<T, G, 1>(src, xs, rmap, cmap, W, vec);
  __syncthreads();
  ha_wstage<A, P, MT>(xs, vw, tp);
  __syncthreads();

  const int64_t out = n * Ho * static_cast<int64_t>(Wo);
  T* const u[4] = {o00 + out, o01 + out, o10 + out, o11 + out};
  ha_hstage<T, P, MT>(vw, u, o0r, o0c, Ho, Wo, tp);
}

}  // namespace dtcwt
