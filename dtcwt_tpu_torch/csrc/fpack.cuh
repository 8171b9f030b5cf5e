// The 3-D analysis kernel of fpack.cu, fwd_pack_kernel (CUDA C++, sm_90a):
// fwd_level1_pack (P = 1 output stream a stage, the biort pair h0o / h1o)
// and fwd_level2_pack (P = 2, the decimating qshift pairs (h0b, h0a) /
// (h1b, h1a)).
//
// For the depth-slice pair u of the branch volumes lo, hi [B, Dn, H, W]
// (the depth stage's outputs, in the compute type) and its depth branch i,
// a block reads the two slices of the branch, lo[2u] and lo[2u+1] (i = 0)
// or hi[2u] and hi[2u+1] (i = 1) (slice s = 2 i + c: depth parity c),
// filters each along W with both branch filters k and along H with both
// branch filters j,
//
//   u_s[j][k] = F_H(h_j) F_W(h_k) slice s,
//
// and writes, over one 32 x 32 output tile, the octants (i, j, k) of its
// branch: at i = 0 the LLL octant (0, 0, 0) at both depth parities and the
// octants 0, 3 and 4, at i = 1 the octants 1, 2, 5 and 6, each at the
// tile's 16 x 16 band locations as 4 of the 28 re/im subbands of the
// cube2c pack (the octant order of transforms/transform3d._OCTANTS),
// planes or interleaved.  A band location's octant is a 2 x 2 x 2 octet:
// depth parity c, row parity hp and column parity wp of u_{2i+c}[j][k].
//
// Bound on the H100: device memory bytes (level 1: 8 bytes of input
// against 4 + 28 bytes of output an f32 output sample, so its stores; level
// 2: 32 bytes of input against 8 of output), against 2 m multiply-adds of
// the W stage a staged sample and 2 m of the H stage an output.  What the
// design avoids: tap loops of run-time length over taps in shared memory
// (two shared loads a multiply-add), every output of every branch computed
// from its own loads, an H stage reading its column two samples apart
// (two-way bank conflicts) and a division an item in the W stage (4.2x and
// 7.8x the bound at the two levels).  It is hw22_kernel's (hwana.cuh) run
// on each slice of the branch, then the pack:
//
// * One depth branch a block, one slice at a time: the branch's slice c = 0
//   is staged (hs_stage of hwtile.cuh: maps folded once a block, 16-byte
//   cp.async chunks where the map runs on in order), its W stage
//   (ha_wstage) writes both W branches' images, and its H stage (ha_hcol)
//   reads them; then slice c = 1.  Its copies are issued as soon as the W
//   stage has read slice 0, so that they are in flight during slice 0's H
//   stage.  The shared memory is hw22's (one staged slice, two W-stage
//   images, the maps) and, interleaved, the restage: every instance fits,
//   float64 at the largest bounds included (213 KB at dfilt 32).  Both
//   branches a block in turn (the next branch's slice in flight under the
//   last H stage) took 1.18x the time at level 2 and 1.06x at level 1 in
//   float32 interleaved, 0.95x in level-1 planes (PERF.md).
// * Taps by value in the kernel's parameters (HsTaps of taps.cuh), under a
//   compile-time bound MT the host chooses from hw22's instance set (level
//   1: 5, 7, 9, 19 or 31; level 2: 10, 14, 16, 18 or 32 a stream; every
//   dtype): every tap loop runs to MT with register indices and no guard;
//   level 2's parities are split in registers and the swap sw places each
//   sum (hs_taps_by_parity).
// * Register windows, fanning out.  The W stage's item is 4 outputs of a
//   staged row, one window (16-byte loads) feeding both W branches, stored
//   as 16-byte vectors.  The H stage: a thread owns output rows 4 rg ..
//   4 rg + 3 of one column (rg its warp; lanes on consecutive columns, no
//   bank conflict); one window down the column of W-stage image k feeds
//   both H branches j.  Depth parity 0's 16 sums (2 k x 2 j x 4 rows) wait
//   in registers for parity 1's.
// * The pack in registers.  A lane pair (columns 2 qx and 2 qx + 1) holds
//   two band locations of the octant at both depth parities: band rows
//   2 rg and 2 rg + 1.  The even lane takes band row 2 rg, the odd one
//   2 rg + 1; each sends its partner the 4 values of the partner's band row
//   (__shfl_xor_sync(..., 1)) and so holds all 8 corners of its location.
//   (A thread owning two adjacent columns instead would have held 32 sums
//   and two windows.)
// * The stores: the LLL as 2-vectors (a location's two columns); the
//   subband planes one value a lane, each warp writing 16 consecutive band
//   locations of two band rows; the interleaved subbands (an octant's 8
//   values, 32 contiguous, sector-aligned bytes; 64 in double) through a
//   restage in each warp, [32 lanes][8], so that every 32-byte sector
//   leaves whole in one store instruction (fwd_slot: an XOR swizzle on
//   which the 16-byte phases of the writes and of the reads hit distinct
//   banks).
// * Blocks an SM at the main path's bounds in float32 (near_sym_a 7,
//   qshift_a 10; the first design's: 5 and 2): four and four, set by the
//   registers (58-64, no spills; ptxas, PERF.md), the shared memory
//   (25 KB and 55 KB interleaved) allowing eight and four.  No register
//   cap: one at 48 (five blocks) took 1.02x the time at level 1
//   interleaved, 0.96x in its planes, and gained nothing at level 2.
//
// The host (ops/hwtile.py _fwd_pack_geometry, _hw22_tap_bound) chooses the
// tap bound and passes the tile; the C entry refuses any other (fpack.cu
// run_fwd_pack, hwtile.cuh launch_tiles).  tests/test_torch_pack3d_tiling.py
// replays the tiling on the CPU, block by block.
#pragma once

#include "hwana.cuh"

namespace dtcwt {

// The band order n of octant (depth branch i, H branch j, W branch k) other
// than (0, 0, 0): (0, 1, 0), (1, 0, 0), (1, 1, 0), (0, 0, 1), (0, 1, 1),
// (1, 0, 1), (1, 1, 1) (transforms/transform3d._OCTANTS); subbands 4 n ..
// 4 n + 3.
__host__ __device__ constexpr int oct_n(int i, int j, int k) {
  return k ? 3 + 2 * i + j : 2 * i + j - 1;
}

// The interleaved restage: an octant's 8 values at a band location are
// fwd_np() pieces of fwd_vn() values (16 bytes each); row l of a warp's
// [32][8] holds the 8 values of lane l's location.
template <typename A> __host__ __device__ constexpr int fwd_vn() {
  return 16 / static_cast<int>(sizeof(A));  // values a 16-byte piece
}
template <typename A> __host__ __device__ constexpr int fwd_np() {
  return 8 / fwd_vn<A>();  // pieces of a location's octant: 2, double 4
}
constexpr int FWD_RS = PACK_THREADS * 8;  // the restage: [8 warps][32][8]

// Slot of piece v of row l in the restage, XOR-swizzled so that the 8
// lanes of a 16-byte phase write distinct banks (the reads are contiguous).
template <typename A> __device__ __forceinline__ int fwd_slot(int l, int v) {
  constexpr int NP = fwd_np<A>();
  return v ^ ((l / (8 / NP)) & (NP - 1));
}

// The compile-time geometry of an instance: a slice's (HaGeo: the staged
// area, its windows) and the restage of the interleaved layout.  Shared
// memory: the staged slice [X][XS], the W stage's [2 k][X][32], the
// restage [RS], the row and column maps [X] each.
template <typename A, bool PLANES, int P, int MT>
struct FpGeo : HaGeo<A, P, MT> {
  static constexpr int RS = PLANES ? 0 : FWD_RS;
  static constexpr size_t SMEM =
      HaGeo<A, P, MT>::SMEM + sizeof(A) * static_cast<size_t>(RS);
  static_assert(SMEM <= PACK_SMEM_MAX, "shared memory");
};

template <typename T, bool PLANES, int P, int MT>
__global__ void __launch_bounds__(PACK_THREADS) fwd_pack_kernel(
    const typename AccOf<T>::type* __restrict__ lo,
    const typename AccOf<T>::type* __restrict__ hi, T* __restrict__ lll,
    void* band_a, void* band_b, int Dn, int H, int W, int Ho, int Wo,
    int n_th, int n_tw,
    const __grid_constant__ HsTaps<typename AccOf<T>::type, P> tp) {
  using A = typename AccOf<T>::type;
  using G = FpGeo<A, PLANES, P, MT>;
  constexpr int VN = fwd_vn<A>(), NP = fwd_np<A>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* xs = reinterpret_cast<A*>(smem_raw);        // [X][XS] one slice
  A* vw = xs + G::XN;                            // [2 k][X][32]
  A* ws = vw + 2 * G::VN;                        // [8 warps][32][8]
  int* rmap = reinterpret_cast<int*>(ws + G::RS);  // [X] source row
  int* cmap = rmap + G::X;                         // [X] source column

  const int tid = threadIdx.x;
  int64_t blk = blockIdx.x;
  const int tw = static_cast<int>(blk % n_tw);
  blk /= n_tw;
  const int th = static_cast<int>(blk % n_th);
  blk /= n_th;
  const int i = static_cast<int>(blk & 1);  // the block's depth branch
  blk >>= 1;
  const int Dh = Dn / 2;
  const int u = static_cast<int>(blk % Dh);
  const int64_t b = blk / Dh;
  const int o0r = th * HS_TILE, o0c = tw * HS_TILE;
  // the staged area's first sample, 16 bytes aligned and even
  const int rs = P * o0r - G::SO, cs = P * o0c - G::SO;
  for (int t = tid; t < G::X; t += PACK_THREADS) {
    rmap[t] = fold(rs + t, H);
    cmap[t] = fold(cs + t, W);
  }
  __syncthreads();
  // the chunked staging: rows and inputs aligned to a chunk
  constexpr int CB = hs_chunk<A>() * sizeof(A);
  const bool vec = W % hs_chunk<A>() == 0 &&
                   reinterpret_cast<uintptr_t>(lo) % CB == 0 &&
                   reinterpret_cast<uintptr_t>(hi) % CB == 0;
  const int64_t hw = static_cast<int64_t>(H) * W;
  // the branch's slice c into xs, its copies left in flight
  const A* const br = (i ? hi : lo) + (b * Dn + 2 * u) * hw;
  auto stage = [&](int c) {
    const A* const src[1] = {br + c * hw};
    hs_stage<A, G, 1, false>(src, xs, rmap, cmap, W, vec);
  };

  // this lane's band location: band row 2 rg + e of the tile (e its column
  // parity), band column lane / 2
  const int rg = tid >> 5, lane = tid & 31, e = lane & 1;
  const int Hb = Ho / 2, Wb = Wo / 2;
  const int p = o0r / 2 + 2 * rg + e, q = o0c / 2 + (lane >> 1);
  const bool in = p < Hb && q < Wb;
  // interleaved: the destination of piece v this lane stores, piece
  // kk = 32 v + lane of the warp's restage (row kk / NP, that lane's
  // location; part kk % NP)
  A* zp[NP] = {};
  A* wsw = ws + rg * 32 * 8;  // this warp's restage
  if constexpr (!PLANES) {
#pragma unroll
    for (int v = 0; v < NP; ++v) {
      const int kk = 32 * v + lane, r = kk / NP;
      const int lp = o0r / 2 + 2 * rg + (r & 1), lq = o0c / 2 + (r >> 1);
      zp[v] = lp < Hb && lq < Wb
                  ? static_cast<A*>(band_a) +
                        (((b * Dh + u) * Hb + lp) * static_cast<int64_t>(Wb) +
                         lq) * 56 + VN * (kk % NP)
                  : nullptr;
    }
  }

  // octant (i, j, k) from depth parity 0's sums x0 and parity 1's x1 (rows
  // 4 rg .. 4 rg + 3 of this lane's column)
  auto octant = [&](int i, int j, int k, const A (&x0)[4],
                    const A (&x1)[4]) {
    // corners [c][hp] at column parity 0 (w0) and 1 (w1): this lane's own
    // column, and its partner's through the shuffle
    A w0[2][2], w1[2][2];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int hp = 0; hp < 2; ++hp) {
        const A top = c ? x1[hp] : x0[hp], bot = c ? x1[2 + hp] : x0[2 + hp];
        const A own = e ? bot : top;
        const A other = __shfl_xor_sync(0xffffffffu, e ? top : bot, 1);
        w0[c][hp] = e ? other : own;
        w1[c][hp] = e ? own : other;
      }
    if (i == 0 && j == 0 && k == 0) {
      if (in) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int hp = 0; hp < 2; ++hp) {
            Vec<T, 2> v;
            store(&v.v[0], w0[c][hp]);
            store(&v.v[1], w1[c][hp]);
            *reinterpret_cast<Vec<T, 2>*>(
                lll + ((b * Dn + 2 * u + c) * Ho + 2 * p + hp) *
                          static_cast<int64_t>(Wo) + 2 * q) = v;
          }
      }
      return;
    }
    const int n = oct_n(i, j, k);
    const A cA = w0[0][0], cB = w0[0][1], cC = w0[1][0], cD = w0[1][1];
    const A cE = w1[0][0], cF = w1[0][1], cG = w1[1][0], cH = w1[1][1];
    const A h = static_cast<A>(0.5);
    const A re[4] = {(cA - cG - cD - cF) * h, (cA - cG + cD + cF) * h,
                     (cA + cG + cD - cF) * h, (cA + cG - cD + cF) * h};
    const A im[4] = {(cB - cH + cC + cE) * h, (-cB + cH + cC + cE) * h,
                     (cB + cH - cC + cE) * h, (-cB - cH - cC + cE) * h};
    if constexpr (PLANES) {
      if (in) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int64_t off = (((b * 28 + 4 * n + m) * Dh + u) * Hb + p) *
                                  static_cast<int64_t>(Wb) + q;
          store(static_cast<T*>(band_a) + off, re[m]);
          store(static_cast<T*>(band_b) + off, im[m]);
        }
      }
    } else {
      // value 2 m is re[m], 2 m + 1 is im[m]; every lane restages its row,
      // then stores NP of the warp's pieces
#pragma unroll
      for (int v = 0; v < NP; ++v) {
        Vec<A, VN> pk;
#pragma unroll
        for (int t = 0; t < VN; ++t) {
          const int z = v * VN + t;
          pk.v[t] = z % 2 ? im[z / 2] : re[z / 2];
        }
        *reinterpret_cast<Vec<A, VN>*>(wsw + 8 * lane +
                                       VN * fwd_slot<A>(lane, v)) = pk;
      }
      __syncwarp();
#pragma unroll
      for (int v = 0; v < NP; ++v) {
        const int kk = 32 * v + lane, r = kk / NP;
        if (zp[v])
          *reinterpret_cast<Vec<A, VN>*>(zp[v] + 8 * n) =
              *reinterpret_cast<const Vec<A, VN>*>(
                  wsw + 8 * r + VN * fwd_slot<A>(r, kk % NP));
      }
      __syncwarp();  // the restage is read before it is written again
    }
  };

  A a0[2][2][4];  // depth parity 0's H stage: [k][j][output row]
  stage(0);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    cp_async_wait_all();
    __syncthreads();  // slice c (and the maps) staged; slice 0's H stage
                      // has read vw
    ha_wstage<A, P, MT>(xs, vw, tp);
    __syncthreads();  // vw written; xs read
    if (c == 0) stage(1);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      A acc[2][4];
      ha_hcol<A, P, MT>(vw + k * G::VN, tp, acc);
      if (c == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) a0[k][j][v] = acc[j][v];
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) octant(i, j, k, a0[k][j], acc[j]);
      }
    }
  }
}

}  // namespace dtcwt
