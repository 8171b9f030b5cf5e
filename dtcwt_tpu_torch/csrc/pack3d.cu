// The four (H, W) level kernels of the 3-D DTCWT, one per depth-slice pair
// (CUDA C++, sm_90a):
//
//   fwd_level1_pack  level-1 analysis: both biort filters along W and H of
//                    the four depth-filtered slices + the cube2c pack
//   inv_level1_pack  level-1 synthesis: c2cube unpack + both biort
//                    synthesis filters along W and H, summed per branch
//   fwd_level2_pack  the same as fwd_level1_pack with the decimating
//                    qshift pair (dfilt) along W and H
//   inv_level2_pack  the same as inv_level1_pack with the interpolating
//                    qshift pair (ifilt) along W and H
//
// Replace the Pallas kernels of dtcwt_tpu/ops/pallas_pack3d.py
// (_build_pack_pairs, _build_unpack_pairs, _build_pack_pairs2,
// _build_unpack_pairs2; entries fwd_level1_pack, inv_level1_pack,
// fwd_level2_pack, inv_level2_pack).  The depth stage of each level runs
// before (analysis) or after (synthesis) these kernels on the dual-stream
// kernels of dual.cu along axis -3.
//
// What they compute.  The depth stage turns a level's input into two branch
// volumes lo, hi [B, Dn, H, W].  For the depth-slice pair u the analysis
// kernel reads the slices lo[2u], lo[2u+1], hi[2u], hi[2u+1] (slice
// sl = 2 i + c: depth branch i, depth parity c), filters each along W with
// both branch filters k and then along H with both branch filters j: 16
// images.  The octant (i, j, k) of the separable tree, at depth parity c
// and (H, W) parities (hp, wp) of its output grid, is one corner of a
// 2 x 2 x 2 octet; the kernel writes the LLL octant (0, 0, 0) at full
// output resolution and the other 7 octants as the 28 re/im subbands of
// eqs. (6)-(9) (packing._cube_corner_combos), in the octant order of
// transforms/transform3d._OCTANTS.  The synthesis kernel reads the 28
// subbands and the LLL slice pair, forms the 7 octants' corners with
// c2cube while staging them, and writes, per depth branch i and parity c,
// U_i[2u + c] = sum_{j,k} F_H(g_j) F_W(g_k) octant(i, j, k)[2u + c].
//
// Every filter is a set of P output streams (host plans, ops/pack3d.py)
// applied along W and along H, as hwstage.cuh sets out (the analysis
// kernel takes the stream plan and the FIR from there; the synthesis
// kernel takes the same plans as taps by value, ipack.cuh),
// so the kernels hold no parity logic.  x is read at symmetric reflection
// (reflect() of common.cuh, folded as often as needed, so H or W shorter
// than the filter works).
//
// Layouts: the subbands are band-major planes [B, 28, Dn/2, Hb, Wb] of the
// storage type (float, bfloat16 or double), or interleaved complex
// band-minor [B, Dn/2, Hb, Wb, 28] (float or double pairs), written and
// read directly, so that layout costs no extra pass.  The branch volumes lo,
// hi (analysis input) and U_0, U_1 (synthesis output) are in the compute
// type (float for float and bfloat16 storage, double for double): the
// depth stage runs at that precision and the transform rounds to storage
// once per level.  All offsets into device memory are 64-bit.
//
// Bound on the H100: device memory bytes.  An output costs ~4 m
// multiply-adds (m taps) against ~12 bytes moved per input sample, well
// below the card's ~20 float32 operations per byte.  The design: one block
// per (batch, depth pair, OH x OW output tile) stages each input slice (or
// each round's octants' c2cube corners) with a reflected halo in dynamic
// shared memory, runs the W stage into shared memory and the H stage plus
// the (un)pack in registers, and writes every output once.
//
// The analysis kernel takes its tile from the host (ops/pack3d.py
// _fwd_pack_geometry; the largest that fits) and refuses any other.  It
// stages a slice with lanes on consecutive columns, one asynchronous copy
// (cp.async) an item so that all of a thread's loads are in flight at
// once, reading an interior tile directly and an edge tile through row and
// column maps folded once per block (no modulo or division per sample); it
// stores the LLL as 2-vectors and sends the interleaved subbands through a
// restage in each warp so that every 32-byte sector leaves whole in one
// store (fwd_slot).  Its W and H stages are still the first port's
// (runtime-length FIRs with their taps in shared memory); the times are in
// PERF.md.  The synthesis kernel, inv_pack_kernel, has a design of its own
// (ipack.cuh: corners built once per band location, taps by value under a
// compile-time bound, register windows) and takes its tile from the host
// too (_inv_pack_geometry).
#include "hwstage.cuh"
#include "ipack.cuh"

namespace dtcwt {

// octants (depth branch i, H branch j, W branch k) in band order
__device__ __forceinline__ int oct_i(int n) { return (0x66 >> n) & 1; }
__device__ __forceinline__ int oct_j(int n) { return (0x55 >> n) & 1; }
__device__ __forceinline__ int oct_k(int n) { return n >= 3; }

// ---------------------------------------------------------------------------
// analysis: lo, hi [B, Dn, H, W] (compute type) -> lll [B, Dn, Ho, Wo] and
// the 28 subbands [.., Dn/2, Ho/2, Wo/2]
// ---------------------------------------------------------------------------

// The interleaved subbands leave through a restage in the warp: an octant's
// 8 values at a band location are 32 contiguous, sector-aligned bytes (64
// in double), so each warp writes its octant to shared memory, 16 of its
// 32 locations at a time, and stores it as 16-byte pieces, consecutive
// lanes on the pieces of one location: every 32-byte sector is written
// whole by one store instruction (a lane's own 8 scalars touched 8 sectors
// a warp instruction, 4 bytes of each).  Half a warp at a time keeps the
// restage at 4 KB a block (8 in double).
template <typename A> __host__ __device__ constexpr int fwd_vn() {
  return 16 / static_cast<int>(sizeof(A));  // values a 16-byte piece
}
template <typename A> __host__ __device__ constexpr int fwd_np() {
  return 8 / fwd_vn<A>();  // pieces of a location's octant: 2, double 4
}
constexpr int FWD_RS = PACK_THREADS / 2 * 8;  // the restage: [warp][16][8]

// Slot of piece v of location l in the restage, XOR-swizzled so that the 8
// lanes of a 16-byte phase write distinct banks (the reads are contiguous).
template <typename A> __device__ __forceinline__ int fwd_slot(int l, int v) {
  constexpr int NP = fwd_np<A>();
  return v ^ ((l / (8 / NP)) & (NP - 1));
}

// One value from device memory into shared memory, asynchronously.
template <typename A>
__device__ __forceinline__ void cp_async_elem(A* smem, const A* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(sizeof(A))
               : "memory");
}

template <typename T, bool PLANES, int P, int D, int S>
__global__ void __launch_bounds__(PACK_THREADS)
    fwd_pack_kernel(const typename AccOf<T>::type* __restrict__ lo,
                    const typename AccOf<T>::type* __restrict__ hi,
                    T* __restrict__ lll, void* band_a, void* band_b, int Dn,
                    int H, int W, int Ho, int Wo, int OH, int OW, int XR,
                    int XC, int XN, int cmin, int n_th, int n_tw,
                    PackPlan<typename AccOf<T>::type, P> plan) {
  using A = typename AccOf<T>::type;
  constexpr int VN = fwd_vn<A>(), NP = fwd_np<A>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ PackPlan<A, P> sp;
  A* xs = reinterpret_cast<A*>(smem_raw);  // [XR][XC] one input slice;
                                           // later the restage [8][16][8]
  A* wi = xs + XN;                         // [4 slices][2 k][XR][OW]
  int* cmap = reinterpret_cast<int*>(wi + 8 * XR * OW);  // [XC] input column
  int* rmap = cmap + XC;                                 // [XR] input row

  const int tid = threadIdx.x;
  int64_t blk = blockIdx.x;
  const int tw = static_cast<int>(blk % n_tw);
  blk /= n_tw;
  const int th = static_cast<int>(blk % n_th);
  blk /= n_th;
  const int Dh = Dn / 2;
  const int u = static_cast<int>(blk % Dh);
  const int64_t b = blk / Dh;
  const int o0r = th * OH, o0c = tw * OW;
  const int rstart = D * (o0r / P) + cmin, cstart = D * (o0c / P) + cmin;
  // a tile whose staged rows and columns all lie inside the slice reads
  // them directly; the others through the maps, folded once per block
  const bool inner = rstart >= 0 && rstart + XR <= H && cstart >= 0 &&
                     cstart + XC <= W;

  stage_plan(plan, &sp);
  if (!inner) {
    for (int i = tid; i < XC; i += PACK_THREADS) cmap[i] = fold(cstart + i, W);
    for (int i = tid; i < XR; i += PACK_THREADS) rmap[i] = fold(rstart + i, H);
  }
  // staging item i = r XC + c, lanes on consecutive columns: this thread's
  // first (r, c) and its step of PACK_THREADS items, carried without a
  // division; each item an asynchronous copy (cp.async), so that all of a
  // thread's loads are in flight at once
  const int r0 = tid / XC, c0 = tid - r0 * XC;
  const int dr = PACK_THREADS / XC, dc = PACK_THREADS - dr * XC;
  for (int sl = 0; sl < 4; ++sl) {
    const A* src = (sl < 2 ? lo : hi) +
                   (b * Dn + 2 * u + (sl & 1)) * static_cast<int64_t>(H) * W;
    __syncthreads();  // the plan and maps are staged / the last W stage
                      // read xs
    if (inner) {
      const A* s0 = src + static_cast<int64_t>(rstart) * W + cstart;
      for (int i = tid, r = r0, c = c0; i < XR * XC; i += PACK_THREADS) {
        cp_async_elem(xs + i, s0 + static_cast<int64_t>(r) * W + c);
        r += dr;
        c += dc;
        if (c >= XC) {
          c -= XC;
          ++r;
        }
      }
    } else {
      for (int i = tid, r = r0, c = c0; i < XR * XC; i += PACK_THREADS) {
        cp_async_elem(xs + i,
                      src + static_cast<int64_t>(rmap[r]) * W + cmap[c]);
        r += dr;
        c += dc;
        if (c >= XC) {
          c -= XC;
          ++r;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int idx = tid; idx < 2 * XR * OW; idx += PACK_THREADS) {
      const int k = idx / (XR * OW), rem = idx - k * XR * OW;
      const int r = rem / OW, ow = rem - r * OW;
      wi[(sl * 2 + k) * XR * OW + rem] =
          fir<A, P, D, S>(sp, k, ow, xs + r * XC, 1);
    }
  }
  __syncthreads();  // xs is free: the restage may use it

  // the H stage and the pack: a warp takes 32 consecutive band locations
  // of the tile, row-major
  const int Hb = Ho / 2, Wb = Wo / 2;
  const int BX = OW / 2, NL = (OH / 2) * BX;
  const int lane = tid & 31, warp = tid >> 5;
  A* ws = xs + warp * 16 * 8;  // this warp's restage [16 locations][8]
  for (int base = 32 * warp; base < NL; base += PACK_THREADS) {
    const int idx = base + lane;
    const int py = idx / BX, qx = idx - py * BX;
    const int p = o0r / 2 + py, q = o0c / 2 + qx;
    const bool in = idx < NL && p < Hb && q < Wb;
    // octant image of slice sl, H branch j, W branch k at (hp, wp)
    auto corner = [&](int sl, int j, int k, int hp, int wp) -> A {
      return fir<A, P, D, S>(sp, j, 2 * py + hp,
                                wi + (sl * 2 + k) * XR * OW + 2 * qx + wp,
                                OW);
    };
    if (in) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        T* lp = lll + ((b * Dn + 2 * u + c) * Ho + 2 * p) *
                          static_cast<int64_t>(Wo) + 2 * q;
#pragma unroll
        for (int hp = 0; hp < 2; ++hp) {
          Vec<T, 2> v;
          store(&v.v[0], corner(c, 0, 0, hp, 0));
          store(&v.v[1], corner(c, 0, 0, hp, 1));
          *reinterpret_cast<Vec<T, 2>*>(lp + hp * static_cast<int64_t>(Wo)) =
              v;
        }
      }
    }
    // interleaved: the destination of each piece this lane stores (half
    // h = e / (NP / 2) of the warp's run; piece k = 32 (e % (NP / 2)) +
    // lane: location 16 h + k / NP, part k % NP)
    A* zp[NP];
    if constexpr (!PLANES) {
#pragma unroll
      for (int e = 0; e < NP; ++e) {
        const int k = 32 * (e % (NP / 2)) + lane;
        const int li = base + 16 * (e / (NP / 2)) + k / NP;
        const int ly = li / BX, lx = li - ly * BX;
        const int lp = o0r / 2 + ly, lq = o0c / 2 + lx;
        zp[e] = li < NL && lp < Hb && lq < Wb
                    ? static_cast<A*>(band_a) +
                          (((b * Dh + u) * Hb + lp) *
                               static_cast<int64_t>(Wb) + lq) * 56 +
                          VN * (k % NP)
                    : nullptr;
      }
    }
#pragma unroll 1
    for (int n = 0; n < 7; ++n) {
      A z[NP][VN];  // interleaved: the octant's 8 values, as NP pieces
      if (in) {
        const int s0 = 2 * oct_i(n), j = oct_j(n), k = oct_k(n);
        const A cA = corner(s0, j, k, 0, 0), cB = corner(s0, j, k, 1, 0);
        const A cC = corner(s0 + 1, j, k, 0, 0),
                cD = corner(s0 + 1, j, k, 1, 0);
        const A cE = corner(s0, j, k, 0, 1), cF = corner(s0, j, k, 1, 1);
        const A cG = corner(s0 + 1, j, k, 0, 1),
                cH = corner(s0 + 1, j, k, 1, 1);
        const A h = static_cast<A>(0.5);
        const A re[4] = {(cA - cG - cD - cF) * h, (cA - cG + cD + cF) * h,
                         (cA + cG + cD - cF) * h, (cA + cG - cD + cF) * h};
        const A im[4] = {(cB - cH + cC + cE) * h, (-cB + cH + cC + cE) * h,
                         (cB + cH - cC + cE) * h, (-cB - cH - cC + cE) * h};
        if constexpr (PLANES) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int64_t off =
                (((b * 28 + 4 * n + m) * Dh + u) * Hb + p) *
                    static_cast<int64_t>(Wb) + q;
            store(static_cast<T*>(band_a) + off, re[m]);
            store(static_cast<T*>(band_b) + off, im[m]);
          }
        } else {
          // value 2 m is re[m], 2 m + 1 is im[m]
#pragma unroll
          for (int v = 0; v < NP; ++v)
#pragma unroll
            for (int t = 0; t < VN; ++t) {
              const int e = v * VN + t;
              z[v][t] = e % 2 ? im[e / 2] : re[e / 2];
            }
        }
      }
      if constexpr (!PLANES) {
        // the warp's two halves in turn: lanes 16 h .. 16 h + 15 restage,
        // then all 32 store the half's pieces
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (in && lane >> 4 == h) {
            const int l = lane & 15;
#pragma unroll
            for (int v = 0; v < NP; ++v) {
              Vec<A, VN> pk;
#pragma unroll
              for (int t = 0; t < VN; ++t) pk.v[t] = z[v][t];
              *reinterpret_cast<Vec<A, VN>*>(
                  ws + 8 * l + VN * fwd_slot<A>(l, v)) = pk;
            }
          }
          __syncwarp();
#pragma unroll
          for (int e = 0; e < NP / 2; ++e) {
            const int k = 32 * e + lane, l = k / NP;
            A* dst = zp[h * (NP / 2) + e];
            if (dst)
              *reinterpret_cast<Vec<A, VN>*>(dst + 8 * n) =
                  *reinterpret_cast<const Vec<A, VN>*>(
                      ws + 8 * l + VN * fwd_slot<A>(l, k % NP));
          }
          __syncwarp();  // the restage is read before it is written again
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The forward tile the host chose (ops/pack3d.py _fwd_pack_geometry): OH x
// OW output samples, the staged slice XR x XC, the first shared region XN
// (the slice, or the interleaved restage where that is larger) and the
// dynamic shared memory in bytes.
struct FwdTile {
  int oh, ow, xr, xc, xn, smem;
};

// True if the host's tile is the kernel's for a plan of this span: sides
// powers of two of at most PACK_TILE and multiples of mult, and the staged
// slice, the regions and the bytes that follow from them.
template <typename A, bool PLANES, int P, int D>
bool fwd_tile_ok(const FwdTile& t, int span, int mult) {
  auto side = [mult](int v) {
    return v >= mult && v <= PACK_TILE && v % mult == 0 && !(v & (v - 1));
  };
  if (!side(t.oh) || !side(t.ow) || t.xr != D * (t.oh / P - 1) + span ||
      t.xc != D * (t.ow / P - 1) + span)
    return false;
  const int xn = !PLANES && t.xr * t.xc < FWD_RS ? FWD_RS : t.xr * t.xc;
  const size_t bytes =
      sizeof(A) * (static_cast<size_t>(xn) + 8 * static_cast<size_t>(t.xr) *
                                                 t.ow) +
      sizeof(int) * static_cast<size_t>(t.xr + t.xc);
  return t.xn == xn && bytes == static_cast<size_t>(t.smem) &&
         bytes <= PACK_SMEM_MAX;
}

template <typename T, bool PLANES, int P, int D, int S>
cudaError_t run_pack(const void* in_a, const void* in_b, void* out_a,
                     void* out_b, void* out_c, int B, int Dn, int H, int W,
                     int Ho, int Wo, const double* taps, const int* lens,
                     const int* offs, const FwdTile& tile,
                     cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  PackPlan<A, P> plan;
  int cmin, span;
  if (!make_pack_plan<A, P, S>(&plan, taps, lens, offs, &cmin, &span))
    return cudaErrorInvalidValue;
  const int mult = P > 2 ? P : 2;
  // the host's tile; the LLL's 2-vectors and the 16-byte pieces of the
  // interleaved subbands need their outputs aligned
  if (!fwd_tile_ok<A, PLANES, P, D>(tile, span, mult) ||
      reinterpret_cast<uintptr_t>(out_a) % (2 * sizeof(T)) ||
      (!PLANES && reinterpret_cast<uintptr_t>(out_b) % 16))
    return cudaErrorInvalidValue;
  const int OH = tile.oh, OW = tile.ow;
  const size_t smem = static_cast<size_t>(tile.smem);
  const int n_th = (Ho + OH - 1) / OH, n_tw = (Wo + OW - 1) / OW;
  const int64_t blocks =
      static_cast<int64_t>(B) * (Dn / 2) * n_th * static_cast<int64_t>(n_tw);
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = fwd_pack_kernel<T, PLANES, P, D, S>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), PACK_THREADS, smem, stream>>>(
      static_cast<const A*>(in_a), static_cast<const A*>(in_b),
      static_cast<T*>(out_a), out_b, out_c, Dn, H, W, Ho, Wo, OH, OW,
      tile.xr, tile.xc, tile.xn, cmin, n_th, n_tw, plan);
  return cudaGetLastError();
}

// The synthesis tile the host chose (ops/pack3d.py _inv_pack_geometry):
// OH x OW output samples, the tap bound MT, the staged area XR x XC, the
// dynamic shared memory in bytes, and vq = 1 for the interleaved subbands
// read as 16-byte pieces.
struct InvTile {
  int oh, ow, mt, xr, xc, smem, vq;
};

template <typename T, bool PLANES, int P, int MT>
cudaError_t run_inv_pack(const void* lll, const void* band_a,
                         const void* band_b, void* out_a, void* out_b, int B,
                         int Dn, int H, int W, int Ho, int Wo,
                         const IpTaps<typename AccOf<T>::type, P>& tp,
                         const InvTile& tile, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  using G = IpGeo<P, MT>;
  constexpr size_t smem = ip_smem<A, P, MT>();
  // the instance's tile and no other
  if (tile.oh != IP_TILE || tile.ow != IP_TILE || tile.xr != G::X ||
      tile.xc != G::X || static_cast<size_t>(tile.smem) != smem ||
      smem > PACK_SMEM_MAX)
    return cudaErrorInvalidValue;
  const int n_th = (Ho + IP_TILE - 1) / IP_TILE;
  const int n_tw = (Wo + IP_TILE - 1) / IP_TILE;
  const int64_t blocks =
      static_cast<int64_t>(B) * (Dn / 2) * n_th * static_cast<int64_t>(n_tw);
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;
  auto launch = [&](auto kernel) -> cudaError_t {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    kernel<<<static_cast<unsigned>(blocks), PACK_THREADS, smem, stream>>>(
        static_cast<const T*>(lll), band_a, band_b, static_cast<A*>(out_a),
        static_cast<A*>(out_b), Dn, H, W, Ho, Wo, n_th, n_tw, tile.vq, tp);
    return cudaGetLastError();
  };
  if constexpr (ip_capped<T, PLANES, P>())
    return launch(inv_pack_kernel_capped<T, PLANES, P, MT>);
  else
    return launch(inv_pack_kernel<T, PLANES, P, MT>);
}

// The plan's taps at the least tap bound of the instance set that holds
// them, which must be the host's; then that instance.
template <typename T, bool PLANES, int P>
cudaError_t inv_pack_mt(const void* lll, const void* band_a,
                        const void* band_b, void* out_a, void* out_b, int B,
                        int Dn, int H, int W, int Ho, int Wo,
                        const double* taps, const int* lens, const int* offs,
                        const InvTile& tile, cudaStream_t st) {
  using A = typename AccOf<T>::type;
  IpTaps<A, P> tp{};
  int mt = 0;
  for (int e = 0; e < ip_bound_count<A, P>() && !mt; ++e)
    if (make_ip_taps<A, P>(&tp, taps, lens, offs, ip_bound<A, P>(e)))
      mt = ip_bound<A, P>(e);
  if (!mt || tile.mt != mt ||
      (tile.vq && (PLANES || reinterpret_cast<uintptr_t>(band_a) % 16)))
    return cudaErrorInvalidValue;
#define DTCWT_RUN_INV(MT_)                                                  \
  return run_inv_pack<T, PLANES, P, MT_>(lll, band_a, band_b, out_a, out_b, \
                                         B, Dn, H, W, Ho, Wo, tp, tile, st)
  if constexpr (sizeof(A) == 8) {
    DTCWT_RUN_INV((P == 1 ? IP_K1 : IP_K2));
  } else if constexpr (P == 1) {
    if (mt == 9) DTCWT_RUN_INV(9);
    if (mt == 21) DTCWT_RUN_INV(21);
    DTCWT_RUN_INV(33);
  } else {
    if (mt == 5) DTCWT_RUN_INV(5);
    if (mt == 7) DTCWT_RUN_INV(7);
    if (mt == 9) DTCWT_RUN_INV(9);
    DTCWT_RUN_INV(17);
  }
#undef DTCWT_RUN_INV
}

// One kernel of the four for storage type T and layout PLANES.
template <typename T, bool PLANES, int P, int D, int S, bool FWD>
cudaError_t run_one(const void* in_a, const void* in_b, const void* bands_a,
                    const void* bands_b, void* out_a, void* out_b,
                    void* out_c, int B, int Dn, int H, int W, int Ho, int Wo,
                    const double* taps, const int* lens, const int* offs,
                    const FwdTile& ftile, const InvTile& itile,
                    cudaStream_t st) {
  if constexpr (FWD)
    return run_pack<T, PLANES, P, D, S>(in_a, in_b, out_a, out_b, out_c, B,
                                        Dn, H, W, Ho, Wo, taps, lens, offs,
                                        ftile, st);
  else
    return inv_pack_mt<T, PLANES, P>(in_a, bands_a, bands_b, out_a, out_b, B,
                                     Dn, H, W, Ho, Wo, taps, lens, offs,
                                     itile, st);
}

template <int P, int D, int S, bool FWD>
int dispatch_pack(const void* in_a, const void* in_b, const void* bands_a,
                  const void* bands_b, void* out_a, void* out_b, void* out_c,
                  int B, int Dn, int H, int W, int Ho, int Wo,
                  const double* taps, const int* lens, const int* offs,
                  int dtype, int planes, const FwdTile& ftile,
                  const InvTile& itile, void* stream) {
  if (B < 1 || Dn < 2 || Dn % 2 || H < 2 || W < 2 || Ho < 2 || Wo < 2 ||
      Ho % 2 || Wo % 2 || (!FWD && (H % 2 || W % 2)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DTCWT_RUN_PACK(T, PL)                                               \
  run_one<T, PL, P, D, S, FWD>(in_a, in_b, bands_a, bands_b, out_a, out_b,  \
                               out_c, B, Dn, H, W, Ho, Wo, taps, lens, offs, \
                               ftile, itile, st)
  switch (dtype) {
    case DT_F32:
      return planes ? DTCWT_RUN_PACK(float, true)
                    : DTCWT_RUN_PACK(float, false);
    case DT_BF16:
      if (!planes) return cudaErrorInvalidValue;
      return DTCWT_RUN_PACK(__nv_bfloat16, true);
    case DT_F64:
      return planes ? DTCWT_RUN_PACK(double, true)
                    : DTCWT_RUN_PACK(double, false);
  }
#undef DTCWT_RUN_PACK
  return cudaErrorInvalidValue;
}

}  // namespace dtcwt

// C interface of the four kernels.  dtype: the storage type.
//   analysis:  in_a / in_b = lo / hi [B, Dn, H, W] (compute type);
//              out_a = lll [B, Dn, Ho, Wo] (storage type); out_b / out_c =
//              re / im planes [B, 28, Dn/2, Ho/2, Wo/2] (planes = 1) or
//              out_b = the interleaved complex [B, Dn/2, Ho/2, Wo/2, 28]
//              (planes = 0); bands_a / bands_b unused; oh .. smem the
//              host's tile (FwdTile), refused unless it is the kernel's.
//   synthesis: in_a = lll [B, Dn, H, W] (storage type); bands_a / bands_b =
//              re / im planes [B, 28, Dn/2, H/2, W/2] (planes = 1) or
//              bands_a = the interleaved complex level (planes = 0);
//              out_a / out_b = U_0 / U_1 [B, Dn, Ho, Wo] (compute type);
//              oh .. vq the host's tile (InvTile), refused unless it is the
//              kernel's.
// taps: host float64 [2 branches][P streams][MAX_TAPS]; lens, offs: host
// [2][P].  Returns the launch's CUDA error code.
#define DTCWT_FWD_PACK_EXPORT(name, P, D, S)                                   \
  extern "C" int name(const void* in_a, const void* in_b,                     \
                      const void* bands_a, const void* bands_b, void* out_a,  \
                      void* out_b, void* out_c, int B, int Dn, int H, int W,  \
                      int Ho, int Wo, const double* taps, const int* lens,    \
                      const int* offs, int dtype, int planes, int oh, int ow, \
                      int xr, int xc, int xn, int smem, void* stream) {       \
    return dtcwt::dispatch_pack<P, D, S, true>(                               \
        in_a, in_b, bands_a, bands_b, out_a, out_b, out_c, B, Dn, H, W, Ho,   \
        Wo, taps, lens, offs, dtype, planes,                                  \
        dtcwt::FwdTile{oh, ow, xr, xc, xn, smem}, dtcwt::InvTile{}, stream);  \
  }
#define DTCWT_INV_PACK_EXPORT(name, P, D, S)                                   \
  extern "C" int name(const void* in_a, const void* in_b,                     \
                      const void* bands_a, const void* bands_b, void* out_a,  \
                      void* out_b, void* out_c, int B, int Dn, int H, int W,  \
                      int Ho, int Wo, const double* taps, const int* lens,    \
                      const int* offs, int dtype, int planes, int oh, int ow, \
                      int mt, int xr, int xc, int smem, int vq,               \
                      void* stream) {                                         \
    return dtcwt::dispatch_pack<P, D, S, false>(                              \
        in_a, in_b, bands_a, bands_b, out_a, out_b, out_c, B, Dn, H, W, Ho,   \
        Wo, taps, lens, offs, dtype, planes, dtcwt::FwdTile{},                \
        dtcwt::InvTile{oh, ow, mt, xr, xc, smem, vq}, stream);                \
  }

DTCWT_FWD_PACK_EXPORT(dtcwt_fwd_level1_pack, 1, 1, 1)
DTCWT_INV_PACK_EXPORT(dtcwt_inv_level1_pack, 1, 1, 1)
DTCWT_FWD_PACK_EXPORT(dtcwt_fwd_level2_pack, 2, 4, 2)
DTCWT_INV_PACK_EXPORT(dtcwt_inv_level2_pack, 4, 2, 2)
