// The 3-D synthesis kernel of pack3d.cu, inv_pack_kernel (CUDA C++,
// sm_90a): inv_level1_pack (P = 1, the biort pair g0o / g1o) and
// inv_level2_pack (P = 4, the qshift pairs (g0b, g0a) / (g1b, g1a)).
//
// For the depth-slice pair u a block writes, per depth branch i and parity
// c, the OH x OW output tile of
//
//   U_i[2u + c] = sum_{j,k} F_H(g_j) F_W(g_k) octant(i, j, k)[2u + c],
//
// the octant (0, 0, 0) being the LLL slice pair and the other 7 the c2cube
// corners of the 28 subbands (the octant order of pack3d.cu).
//
// Bound on the H100: device memory bytes.  Level 1 reads 7 values of
// subbands and one LLL sample per output sample of a branch and writes
// two, 40 bytes in f32, against 4 (m0 + m1) multiply-adds.  What held the
// first design back was the work it issued per byte: it staged each
// octant's corners sample by sample, each sample loading its band
// location's 8 values (so every value four times, 224 bytes apart between
// lanes in the interleaved layout) with two modulos and a division, one
// load at a time; and its W and H stages ran tap loops of run-time length
// over a copy of the taps in shared memory (two shared loads a
// multiply-add).  This design:
//
// * One tile of 32 x 32 output samples a block, 256 threads, and four
//   rounds, one per (i, j): a round stages the two octants (i, j, 0) and
//   (i, j, 1) (round (0, 0): the LLL slice pair and octant 3) over the
//   tile and its halo, runs the W stage of both W branches into shared
//   memory, summed in registers, and the H stage of branch j into
//   registers that each thread keeps across the two rounds of a branch i;
//   it then stores U_i.  The shared memory (36 KB at level 1 in f32, 16 KB
//   at level 2) leaves an SM to the registers' count of blocks: 64
//   registers, four blocks an SM, on the main path (ip_capped).  At 128
//   registers (two items' loads in flight a thread, two blocks an SM) the
//   kernel took 1.1-1.4x the time; a cp.async prefetch of the next
//   round's band values into a third buffer gained nothing (PERF.md).
// * The corners of a band location are built once: a staging item is one
//   band location of the staged area and reads each of its octants' 8
//   values once (interleaved: the 32 contiguous, sector-aligned bytes as
//   16-byte pieces where the host says the pointer allows; planes: a value
//   a plane, lanes on consecutive locations), forms all four (H, W)
//   parities of both depth parities from the same registers (c2cube), and
//   writes them to the staged images as pairs.  The staged area starts on
//   an even sample, and H and W are even, so symmetric reflection maps a
//   band location onto a whole band location, with its parities swapped
//   where the reflected index is odd (as stage_quads, common.cuh): the
//   rows and columns are folded once per block into maps, and an item
//   loads all of its octants before it writes any.  The corners stay in
//   registers: the swaps are selects, not indices (indexed by the swap,
//   they went to local memory and cost 4-14%).  The LLL is staged with one
//   asynchronous copy (cp.async) a sample (bfloat16: a load and a
//   conversion).
// * Taps by value in the kernel's parameters (IpTaps), under a
//   compile-time bound MT chosen by the host (level 1: 9 (near_sym_a,
//   antonini, legall), 21 (near_sym_b) or 33; level 2: 5 (qshift_a), 7
//   (qshift_b), 9 (qshift_c, qshift_d) or 17 (qshift_32); f64 only the
//   largest), centred on a common halo MT / 2: every tap loop runs to MT
//   with compile-time register indices and no guard (the taps past a
//   filter's own are zero, the samples they meet staged).
// * Register windows.  Level 1's W stage: an item is 4 outputs of a row,
//   its window of MT + 3 staged samples of each W branch loaded as 16-byte
//   vectors (lanes 16 bytes apart); its H stage: a thread owns 4 output
//   rows of a column for both depth parities, its window MT + 3 samples
//   down the column (lanes on consecutive columns).  Level 2 (four output
//   streams a stage, ilevel2.cu's I2Taps form): the staged images and the
//   W stage's images are split by column and by row parity, so that a
//   stream's window of one parity is contiguous: the W stage's item is 8
//   outputs of a row from two parity windows of MT + 1 samples (8-byte
//   pairs) of each branch, the H stage's a thread's 4 output rows (one
//   group of the four streams) of a column from two parity windows of MT.
// * Stores: lanes on consecutive output columns, a warp row of 128 bytes
//   a store.
//
// The host (ops/pack3d.py _inv_pack_geometry) chooses the tile, the tap
// bound and the 16-byte loads and passes them in; the kernel refuses any
// other (run_inv_pack, inv_pack_mt: pack3d.cu).
// tests/test_torch_ipack3d_tiling.py replays the tiling on the CPU, block
// by block.
#pragma once

#include "hwtile.cuh"

namespace dtcwt {

constexpr int IP_TILE = 32;  // output tile side
constexpr int IP_K1 = 33;    // the largest level-1 tap bound (31 taps)
constexpr int IP_K2 = 17;    // the largest level-2 one (m2 = 16, qshift_32)

// The two branch filters' taps by value: t[b][s][k] multiplies the
// window sample k of stream s of branch b (level 2: of the parity
// (s & 1) ^ sw[b]).  Level 1 has one stream, level 2 four.
template <typename A, int P> struct IpTaps {
  A t[2][P][P == 1 ? IP_K1 : IP_K2];
  int sw[2];
};

// The compile-time geometry of an instance: P streams (1: level 1, 4:
// level 2), tap bound MT.
template <int P, int MT> struct IpGeo {
  static constexpr int PH = (MT - 1) / 2;  // the common halo
  // staged rows and columns (square), from an even sample: level 1 the
  // tile and PH each side; level 2 (input at half the output's
  // resolution) 2 PH before the tile's 16 and 2 (MT - 1) - 2 PH after
  static constexpr int X = P == 1 ? IP_TILE + MT - 1 : IP_TILE / 2 + 2 * MT - 2;
  // level 2: a staged row's parity half, >= X / 2 and 4 (mod 8) wide, so
  // that the W stage's 8-byte window loads of 4 consecutive rows hit
  // distinct banks
  static constexpr int XH = P == 1 ? 0 : (X / 2 + 3) / 8 * 8 + 4;
  static constexpr int XS = P == 1 ? X : 2 * XH;  // staged row stride
  static constexpr int XN = X * XS;               // one staged image
  static constexpr int VN = X * IP_TILE;          // one W-stage image
  static constexpr int NBC = X / 2;               // staged band columns
  static constexpr int NB = NBC * NBC;            // staged band locations
  // level 1's W window: 4 outputs and MT taps
  static constexpr int NW1 = MT + 3;
};

// Dynamic shared memory of an instance: the staged images [2 k][2 c][X][XS],
// the W stage's [2 c][X][32] and the row and column maps [X] each.
template <typename A, int P, int MT> constexpr size_t ip_smem() {
  using G = IpGeo<P, MT>;
  return sizeof(A) * (4 * static_cast<size_t>(G::XN) + 2 * G::VN) +
         sizeof(int) * 2 * G::X;
}

// The 8 values of octant n at band location (y, x) of subband slice u:
// z[2 m] = Re, z[2 m + 1] = Im of subband 4 n + m.
template <typename T, bool PLANES, typename A>
__device__ __forceinline__ void load_octant(const void* band_a,
                                            const void* band_b, int64_t b,
                                            int u, int Dh, int Hb, int Wb,
                                            int y, int x, int n, int vq,
                                            A z[8]) {
  const int64_t hw = static_cast<int64_t>(Hb) * Wb;
  if constexpr (PLANES) {
    const int64_t plane = Dh * hw;
    const int64_t off = ((b * 28 + 4 * n) * Dh + u) * hw +
                        static_cast<int64_t>(y) * Wb + x;
    const T* ra = static_cast<const T*>(band_a) + off;
    const T* ia = static_cast<const T*>(band_b) + off;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      z[2 * m] = load(ra + m * plane);
      z[2 * m + 1] = load(ia + m * plane);
    }
  } else {
    const A* p = static_cast<const A*>(band_a) +
                 ((b * Dh + u) * hw + static_cast<int64_t>(y) * Wb + x) * 56 +
                 8 * n;
    if (vq) {
      constexpr int VN = 16 / sizeof(A);
#pragma unroll
      for (int e = 0; e < 8 / VN; ++e) {
        const Vec<A, VN> pk = reinterpret_cast<const Vec<A, VN>*>(p)[e];
#pragma unroll
        for (int t = 0; t < VN; ++t) z[e * VN + t] = pk.v[t];
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) z[e] = p[e];
    }
  }
}

// c2cube of one octant's 8 values: q[c][hp][wp], the corner at depth
// parity c and (H, W) parities (hp, wp).
template <typename A>
__device__ __forceinline__ void c2cube8(const A z[8], A q[2][2][2]) {
  const A h = static_cast<A>(0.5);
  const A pr = z[0], pi = z[1], qr = z[2], qi = z[3];
  const A rr = z[4], ri = z[5], sr = z[6], si = z[7];
  q[0][0][0] = (pr + qr + rr + sr) * h;
  q[1][0][0] = (pi + qi - ri - si) * h;
  q[0][0][1] = (pi + qi + ri + si) * h;
  q[1][0][1] = (-pr - qr + rr + sr) * h;
  q[0][1][0] = (pi - qi + ri - si) * h;
  q[1][1][0] = (-pr + qr + rr - sr) * h;
  q[0][1][1] = (-pr + qr - rr + sr) * h;
  q[1][1][1] = (-pi + qi + ri - si) * h;
}

// Staged cell (r, col) of an image: level 1 row-major, level 2 the
// column's parity half.
template <int P, int MT>
__device__ __forceinline__ int ip_cell(int r, int col) {
  using G = IpGeo<P, MT>;
  if constexpr (P == 1) return r * G::XS + col;
  return r * G::XS + (col & 1) * G::XH + (col >> 1);
}

// Write the staged pair (a0, a1) at columns 2 x, 2 x + 1 of row r.
template <int P, int MT, typename A>
__device__ __forceinline__ void ip_put(A* img, int r, int x, A a0, A a1) {
  using G = IpGeo<P, MT>;
  if constexpr (P == 1) {
    Vec<A, 2> v;
    v.v[0] = a0;
    v.v[1] = a1;
    *reinterpret_cast<Vec<A, 2>*>(img + r * G::XS + 2 * x) = v;
  } else {
    img[r * G::XS + x] = a0;
    img[r * G::XS + G::XH + x] = a1;
  }
}

// Stage round (i, j): the octants (i, j, k), k = 0, 1, into xs[k][c].
// n0 < 0: the LLL slice pair in the place of k = 0.
template <typename T, bool PLANES, int P, int MT>
__device__ __forceinline__ void ip_stage(
    const T* __restrict__ lll, const void* band_a, const void* band_b,
    typename AccOf<T>::type* xs, const int* rmap, const int* cmap,
    int64_t b, int u, int Dn, int H, int W, int n0, int n1, int vq) {
  using A = typename AccOf<T>::type;
  using G = IpGeo<P, MT>;
  const int tid = threadIdx.x;
  const int Dh = Dn / 2, Hb = H / 2, Wb = W / 2;
  if (n0 < 0) {
    // the LLL slice pair, a sample an item: [c][row][column]
    const T* l0 = lll + (b * Dn + 2 * u) * static_cast<int64_t>(H) * W;
    for (int it = tid; it < 2 * G::X * G::X; it += PACK_THREADS) {
      const int c = it / (G::X * G::X), rem = it - c * G::X * G::X;
      const int r = rem / G::X, col = rem - r * G::X;
      const T* src = l0 + c * static_cast<int64_t>(H) * W +
                     static_cast<int64_t>(rmap[r]) * W + cmap[col];
      A* dst = xs + c * G::XN + ip_cell<P, MT>(r, col);
      if constexpr (sizeof(T) == sizeof(A))
        cp_async_value(dst, src);
      else
        *dst = load(src);
    }
  }
  // the octants, a band location an item: its loads, then its corners
  for (int it = tid; it < G::NB; it += PACK_THREADS) {
    const int tb = it / G::NBC, tcb = it - tb * G::NBC;
    const int tr = rmap[2 * tb], tc = cmap[2 * tcb];
    A z[2][8];
    if (n0 >= 0)
      load_octant<T, PLANES>(band_a, band_b, b, u, Dh, Hb, Wb, tr >> 1,
                             tc >> 1, n0, vq, z[0]);
    load_octant<T, PLANES>(band_a, band_b, b, u, Dh, Hb, Wb, tr >> 1,
                           tc >> 1, n1, vq, z[1]);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k == 0 && n0 < 0) continue;
      A q[2][2][2];
      c2cube8(z[k], q);
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int hp = 0; hp < 2; ++hp) {
          // staged row 2 tb + hp holds the source parity hp ^ (tr & 1),
          // its columns swapped where tc is odd (selects, not an index:
          // q stays in registers)
          const A s0 = tr & 1 ? q[c][hp ^ 1][0] : q[c][hp][0];
          const A s1 = tr & 1 ? q[c][hp ^ 1][1] : q[c][hp][1];
          ip_put<P, MT>(xs + (2 * k + c) * G::XN, 2 * tb + hp, tcb,
                        tc & 1 ? s1 : s0, tc & 1 ? s0 : s1);
        }
    }
  }
  if (n0 < 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The W stage of a round: vs[c] = sum_k F_W(g_k) xs[k][c], the tile's 32
// output columns of every staged row (level 2: vs split by row parity).
template <typename A, int P, int MT>
__device__ __forceinline__ void ip_wstage(const A* xs, A* vs,
                                          const IpTaps<A, P>& tp) {
  using G = IpGeo<P, MT>;
  constexpr int VV = 16 / sizeof(A);  // values a 16-byte vector
  if constexpr (P == 1) {
    // an item: 4 outputs (4 q ..) of row r, depth parity c
    for (int it = threadIdx.x; it < 2 * G::X * 8; it += PACK_THREADS) {
      const int q = it & 7, rr = it >> 3;
      const int c = rr / G::X, r = rr - c * G::X;
      A acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        A w[G::NW1];
        vec_window<A, G::NW1>(xs + (2 * k + c) * G::XN + r * G::XS + 4 * q,
                              G::NW1, w);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const A t = tp.t[k][0][m];
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[v] += t * w[v + m];
        }
      }
      A* o = vs + (c * G::X + r) * IP_TILE + 4 * q;
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
    // row r, depth parity c, from two parity windows of MT + 1 samples
    constexpr int NW = MT + 1;
    for (int it = threadIdx.x; it < 2 * G::X * 4; it += PACK_THREADS) {
      const int q = it & 3, rr = it >> 2;
      const int c = rr / G::X, r = rr - c * G::X;
      A acc[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[v] = 0;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const A* row = xs + (2 * k + c) * G::XN + r * G::XS + 2 * q;
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
      A* o = vs + ((2 * c + (r & 1)) * (G::X / 2) + (r >> 1)) * IP_TILE +
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

// The H stage of a round with H branch J: acc[c][v] += F_H(g_J) vs[c] at
// this thread's 4 output rows 4 rg + v of column col.
template <typename A, int P, int MT, int J>
__device__ __forceinline__ void ip_hstage(const A* vs, int rg, int col,
                                          const IpTaps<A, P>& tp,
                                          A acc[2][4]) {
  using G = IpGeo<P, MT>;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if constexpr (P == 1) {
      A w[MT + 3];
      const A* s = vs + (c * G::X + 4 * rg) * IP_TILE + col;
#pragma unroll
      for (int t = 0; t < MT + 3; ++t) w[t] = s[t * IP_TILE];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const A t = tp.t[J][0][m];
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[c][v] += t * w[v + m];
      }
    } else {
      // output rows 4 rg + s read rows 2 (rg + m) + parity of the W
      // stage's image, its parity halves X / 2 rows apart
      const int sw = tp.sw[J];
      const A* s = vs + (2 * c * (G::X / 2) + rg) * IP_TILE + col;
      A wa[MT], wb[MT];
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        wa[t] = s[(sw * (G::X / 2) + t) * IP_TILE];
        wb[t] = s[((1 - sw) * (G::X / 2) + t) * IP_TILE];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int s4 = 0; s4 < 4; ++s4)
          acc[c][s4] += tp.t[J][s4][m] * (s4 & 1 ? wb : wa)[m];
    }
  }
}

// One round (i, J): stage, W stage, H stage.  The sync before the W stage
// also orders the last round's H stage (reading vs) before this W stage
// writes it; the one after orders the W stage before the H stage and the
// next round's staging.
template <typename T, bool PLANES, int P, int MT, int J>
__device__ __forceinline__ void ip_round(
    const T* __restrict__ lll, const void* band_a, const void* band_b,
    typename AccOf<T>::type* xs, typename AccOf<T>::type* vs,
    const int* rmap, const int* cmap, int64_t b, int u, int Dn, int H,
    int W, int i, int vq, const IpTaps<typename AccOf<T>::type, P>& tp,
    typename AccOf<T>::type acc[2][4]) {
  using A = typename AccOf<T>::type;
  const int n0 = 2 * i + J - 1, n1 = 3 + 2 * i + J;  // n0 < 0: the LLL
  ip_stage<T, PLANES, P, MT>(lll, band_a, band_b, xs, rmap, cmap, b, u, Dn,
                             H, W, n0, n1, vq);
  __syncthreads();
  ip_wstage<A, P, MT>(xs, vs, tp);
  __syncthreads();
  ip_hstage<A, P, MT, J>(vs, threadIdx.x >> 5, threadIdx.x & 31, tp, acc);
}

// The kernel's body (the entries below differ in their launch bounds).
template <typename T, bool PLANES, int P, int MT>
__device__ __forceinline__ void inv_pack_body(
    const T* __restrict__ lll, const void* band_a, const void* band_b,
    typename AccOf<T>::type* __restrict__ ulo,
    typename AccOf<T>::type* __restrict__ uhi, int Dn, int H, int W, int Ho,
    int Wo, int n_th, int n_tw, int vq,
    const IpTaps<typename AccOf<T>::type, P>& tp) {
  using A = typename AccOf<T>::type;
  using G = IpGeo<P, MT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* xs = reinterpret_cast<A*>(smem_raw);  // [2 k][2 c][X][XS]
  A* vs = xs + 4 * G::XN;                  // [2 c][X][32]
  int* rmap = reinterpret_cast<int*>(vs + 2 * G::VN);  // [X] source row
  int* cmap = rmap + G::X;                             // [X] source column

  const int tid = threadIdx.x;
  int64_t blk = blockIdx.x;
  const int tw = static_cast<int>(blk % n_tw);
  blk /= n_tw;
  const int th = static_cast<int>(blk % n_th);
  blk /= n_th;
  const int Dh = Dn / 2;
  const int u = static_cast<int>(blk % Dh);
  const int64_t b = blk / Dh;
  const int o0r = th * IP_TILE, o0c = tw * IP_TILE;
  // the staged area's first sample, even
  const int rs = P == 1 ? o0r - G::PH : o0r / 2 - 2 * G::PH;
  const int cs = P == 1 ? o0c - G::PH : o0c / 2 - 2 * G::PH;
  for (int t = tid; t < G::X; t += PACK_THREADS) {
    rmap[t] = fold(rs + t, H);
    cmap[t] = fold(cs + t, W);
  }
  __syncthreads();

  const int rg = tid >> 5, col = tid & 31;
  const int goc = o0c + col;
#pragma unroll 1
  for (int i = 0; i < 2; ++i) {
    A acc[2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[c][v] = 0;
    ip_round<T, PLANES, P, MT, 0>(lll, band_a, band_b, xs, vs, rmap, cmap, b,
                                  u, Dn, H, W, i, vq, tp, acc);
    ip_round<T, PLANES, P, MT, 1>(lll, band_a, band_b, xs, vs, rmap, cmap, b,
                                  u, Dn, H, W, i, vq, tp, acc);
    if (goc < Wo) {
      A* out = i ? uhi : ulo;
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int gor = o0r + 4 * rg + v;
          if (gor < Ho)
            out[((b * Dn + 2 * u + c) * Ho + gor) * static_cast<int64_t>(Wo) +
                goc] = acc[c][v];
        }
    }
  }
}

// Whether an instance caps its registers at 64 for four blocks an SM:
// measured on the H100 (PERF.md), the float32 interleaved and the
// level-2 instances run fastest so (some spill 8-196 bytes), the
// level-1 planes instances (float32, bfloat16) at the 64 registers ptxas
// gives them uncapped (capped, they spill ~100 bytes and take 1.2x the
// time), and float64 (for tests) uncapped.
template <typename T, bool PLANES, int P> constexpr bool ip_capped() {
  return sizeof(T) != 8 && (P > 1 || !PLANES);
}

#define DTCWT_INV_PACK_ARGS                                                  \
  const T *__restrict__ lll, const void *band_a, const void *band_b,         \
      typename AccOf<T>::type *__restrict__ ulo,                             \
      typename AccOf<T>::type *__restrict__ uhi, int Dn, int H, int W,       \
      int Ho, int Wo, int n_th, int n_tw, int vq,                            \
      const __grid_constant__ IpTaps<typename AccOf<T>::type, P> tp
template <typename T, bool PLANES, int P, int MT>
__global__ void __launch_bounds__(PACK_THREADS, 4)
    inv_pack_kernel_capped(DTCWT_INV_PACK_ARGS) {
  inv_pack_body<T, PLANES, P, MT>(lll, band_a, band_b, ulo, uhi, Dn, H, W,
                                  Ho, Wo, n_th, n_tw, vq, tp);
}
template <typename T, bool PLANES, int P, int MT>
__global__ void __launch_bounds__(PACK_THREADS)
    inv_pack_kernel(DTCWT_INV_PACK_ARGS) {
  inv_pack_body<T, PLANES, P, MT>(lll, band_a, band_b, ulo, uhi, Dn, H, W,
                                  Ho, Wo, n_th, n_tw, vq, tp);
}
#undef DTCWT_INV_PACK_ARGS

// The tap bounds of an instance set: level 1 9, 21, 33; level 2 5, 7, 9,
// 17; float64 only the largest.
template <typename A, int P> constexpr int ip_bound_count() {
  return sizeof(A) == 8 ? 1 : P == 1 ? 3 : 4;
}
template <typename A, int P> constexpr int ip_bound(int e) {
  return sizeof(A) == 8 ? (P == 1 ? IP_K1 : IP_K2)
         : P == 1       ? (e == 0 ? 9 : e == 1 ? 21 : 33)
                        : (e == 0 ? 5 : e == 1 ? 7 : e == 2 ? 9 : 17);
}

// Fill *tp from the host plan (taps [2][P][MAX_TAPS], lens and offs
// [2][P]: stream s of branch b reads x[D g + offs + S k], k < lens) centred
// on the halo of bound mt; false where a stream does not fit in it.
template <typename A, int P>
bool make_ip_taps(IpTaps<A, P>* tp, const double* taps, const int* lens,
                  const int* offs, int mt) {
  constexpr int K = P == 1 ? IP_K1 : IP_K2;
  if (mt > K) return false;
  const int ph = (mt - 1) / 2;
  for (int b = 0; b < 2; ++b) {
    // level 2: the parity of stream 0's first sample sets the swap
    const int sw = P == 1 ? 0 : (offs[b * P] + 2 * ph) & 1;
    tp->sw[b] = sw;
    for (int s = 0; s < P; ++s) {
      const int len = lens[b * P + s];
      // the stream's first tap's window index: level 1 ph + off;
      // level 2 the half-index shift d / 2 of d = off + 2 ph
      const int d = P == 1 ? ph + offs[b * P + s] : offs[b * P + s] + 2 * ph;
      const int sh = P == 1 ? d : d >> 1;
      if (len < 1 || d < 0 || sh + len > mt ||
          (P > 1 && (d & 1) != ((s & 1) ^ sw)))
        return false;
      for (int k = 0; k < K; ++k) {
        const int kk = k - sh;
        tp->t[b][s][k] = kk >= 0 && kk < len
                             ? static_cast<A>(
                                   taps[(b * P + s) * MAX_TAPS + kk])
                             : A(0);
      }
    }
  }
  return true;
}

}  // namespace dtcwt
