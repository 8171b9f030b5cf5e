// One decimating (qshift, level >= 2) forward level of the 2-D DTCWT in one
// kernel (CUDA C++, sm_90a).
//
// Replaces the Pallas kernel dtcwt_tpu/ops/pallas_level2.py:fwd_level2
// (built by _build_level2).  With the dual-tree decimator
// dfilt(x, ha, hb): Y[2i + s] = sum_k t[s][k] x[4i + c[s] + 2k] (streams and
// their order fixed on the host from the sign of sum(ha*hb)):
//
//   lo = coldfilt(x, h0b, h0a)   hi = coldfilt(x, h1b, h1a)   -> [R/2, C]
//   lolo = rowdfilt(lo, h0b, h0a)                             -> [R/2, C/2]
//   q2c(rowdfilt(hi, h0b, h0a)) -> bands 0, 5
//   q2c(rowdfilt(lo, h1b, h1a)) -> bands 2, 3                 -> [R/4, C/4, 6]
//   q2c(rowdfilt(hi, h1b, h1a)) -> bands 1, 4                   or planes
//
// The bandpass families (qshift_b_bp) add a third pair h2a/h2b of the same
// even length, the third stream (template flag BP): bands 1, 4 become
// q2c(rowdfilt(coldfilt(x, h2b, h2a), h2b, h2a)), from a third column
// image.
//
// Bound on the H100: device memory bytes.  Per input sample it reads 1
// value and writes 1 (a quarter-size lowpass and, at a sixteenth, six
// complex subbands) for about 2 m multiply-adds, far under the card's
// ratio of operations to bytes.  What held the first design back was the
// work it issued per byte: it staged its input tile and halo in shared
// memory with a division and two modulos a sample, ran tap loops of
// run-time length reading the taps from memory and every sample from
// shared memory, read its row windows with 4-way bank conflicts and stored
// its subbands as scalars 48 bytes apart.  This design:
//
// * Taps travel by value in the kernel's parameters (L2Taps), by branch of
//   the decimator, zero past m, so every tap loop runs to MT (10, 14, 16,
//   24 or 32 >= m, chosen by the host) with no guard and compile-time
//   register indices; which branch gives the even output is a uniform
//   select.
// * A block owns QH (4, 8 or 16) quad rows by 64 quads: 4 QH x 256 input
//   pixels, with 256 threads and at most 128 registers a thread up to 16
//   taps (two blocks an SM).  Column stage: an item is one staged column
//   (256 + 2m of them, lanes on consecutive columns, coalesced) by G quad
//   rows (4; float64 2); it loads the 4 G + 2 m - 4 input samples it needs
//   once into registers and writes both branches of each pair (2, or 3
//   with BP) to shared column images split by column parity (l2tile.cuh),
//   whose rows' tails past the window then hold finite samples.  Only tiles
//   whose rows reach past the image reflect their rows; a column reflects
//   once an item, with one fold (two compares) and the modulo of reflect()
//   left to axes shorter than the reach.  No input tile is staged.
// * Row stage: an item is one quad row by 2 quads (4 lowpass columns), a
//   warp one quad row of 64 quads; it reads each parity's window of m + 2
//   samples with 16-byte shared loads (lanes 16 bytes apart: no bank
//   conflict) and runs both row filters of an image on the one window.
//   The lowpass leaves as 4-wide vectors, the planes as 2-wide vectors per
//   band plane; in the interleaved layout a warp's 64 quads are 3 KB of
//   contiguous output, so the warp stages them in shared memory and stores
//   them as 16-byte pieces, lanes on consecutive pieces.  The host says
//   where a row or plane is too short for the vectors.
//
// The host (ops/level2.py, _level2_geometry) chooses QH, MT and the store
// vectors and passes them in; the kernel refuses any other combination.
// The tiling's pieces a qshift level shares are in l2tile.cuh.
#include "l2tile.cuh"

namespace dtcwt {
namespace {

// Quad rows a column-stage item: 4, or 2 in float64 (whose registers are
// twice as wide).
template <typename A> __host__ __device__ constexpr int l2_g() {
  return sizeof(A) == 8 ? 2 : 4;
}

// Blocks an SM whose registers a thread leaves room for (the register cap
// of __launch_bounds__): 2 up to 16 taps (128 registers), else 1.  With
// no cap ptxas takes 167-255 registers at every bound; with a cap of 128
// the bounds 24 and 32 spill 100-730 bytes.
template <typename A, int MT> __host__ __device__ constexpr int l2_blocks() {
  return sizeof(A) == 8 || MT > 16 ? 1 : 2;
}

// Column stage: pair p's column image of tile rows 0 .. 2 qh - 1 (row 2i +
// s of the decimated image, i the tile's quad row) and staged columns 0 ..
// 255 + 2m (input column c0 + 2 - m + lc) into st[p][row][parity][lc / 2].
template <typename T, int MT, int NP>
__device__ __forceinline__ void col_stage(
    const T* __restrict__ xb, typename AccOf<T>::type* st, int R, int C,
    int r0, int c0, int qh, int m,
    const L2Taps<typename AccOf<T>::type>& tp) {
  using A = typename AccOf<T>::type;
  constexpr int G = l2_g<A>();
  const int xw = L2_TW + 2 * m, xh = l2_xh(m), rst = 2 * xh;
  const int img = 2 * qh * rst;
  const int items = qh / G * xw;
  const bool rows_in = r0 + 2 - m >= 0 && r0 + 4 * qh + m - 3 < R;
  for (int it = threadIdx.x; it < items; it += L2_THREADS) {
    const int g = it / xw, lc = it - g * xw;
    const int gc = fold(c0 + 2 - m + lc, C);
    const int rs = r0 + 4 * G * g + 2 - m;  // input row of sample 0
    A s[4 * G + 2 * MT - 4];
    col_load<T, 4 * G - 3, 2 * MT>(xb, rs, gc, R, C, 2 * m, rows_in, s);
    A* o = st + 2 * G * g * rst + (lc & 1) * xh + (lc >> 1);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      A a[G], b[G];
#pragma unroll
      for (int v = 0; v < G; ++v) a[v] = b[v] = 0;
#pragma unroll
      for (int k = 0; k < MT; ++k) {
        const A ta = tp.t[p][0][k], tb = tp.t[p][1][k];
#pragma unroll
        for (int v = 0; v < G; ++v) {
          a[v] += ta * s[4 * v + 2 * k];
          b[v] += tb * s[4 * v + 1 + 2 * k];
        }
      }
      const int sw = tp.swap[p];
      A* op = o + p * img;
#pragma unroll
      for (int v = 0; v < G; ++v) {
        op[(2 * v + sw) * rst] = a[v];
        op[(2 * v + 1 - sw) * rst] = b[v];
      }
    }
  }
}

// The 4 outputs (2 quads x 2 columns, in column order) of the row filters
// of pairs pa and pb on one row of a column image (even half at e, odd half
// at e + xh, both at the item's first window sample): ya from pair pa, yb
// from pair pb (NF = 1: pair pa alone).
template <typename A, int MT, int NF>
__device__ __forceinline__ void row_filters(const A* e, int xh, int m,
                                            const L2Taps<A>& tp, int pa,
                                            int pb, A ya[4], A yb[4]) {
  constexpr int VN = l1_vn<A>();
  constexpr int NW = (MT + 2 + VN - 1) / VN * VN;
  A br[2][NF][2];  // [branch][filter][quad]
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    A w[NW];
    vec_window<A, NW>(e + b * xh, m + 2, w);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const A* t = tp.t[f ? pb : pa][b];
      A acc0 = 0, acc1 = 0;
#pragma unroll
      for (int k = 0; k < MT; ++k) {
        acc0 += t[k] * w[k];
        acc1 += t[k] * w[k + 2];
      }
      br[b][f][0] = acc0;
      br[b][f][1] = acc1;
    }
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const bool sw = tp.swap[f ? pb : pa];
    A* y = f ? yb : ya;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      y[2 * q] = sw ? br[1][f][q] : br[0][f][q];
      y[2 * q + 1] = sw ? br[0][f][q] : br[1][f][q];
    }
  }
}

template <typename T, bool PLANES, bool BP, int MT>
__global__ void __launch_bounds__(
    L2_THREADS, (l2_blocks<typename AccOf<T>::type, MT>()))
    fwd_level2_kernel(const T* __restrict__ x, T* __restrict__ lolo,
                      void* out_a, void* out_b, int R, int C, int qh, int m,
                      int vlo, int vpl,
                      const __grid_constant__ L2Taps<typename AccOf<T>::type>
                          tp) {
  using A = typename AccOf<T>::type;
  constexpr int NP = BP ? 3 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int xh = l2_xh(m), rst = 2 * xh, img = 2 * qh * rst;
  A* st = reinterpret_cast<A*>(smem_raw);  // [NP][2 qh][2][xh]
  // interleaved layout: each warp's subbands, [32 lanes][2 quads][12]
  A* zs = st + NP * img + (threadIdx.x >> 5) * 32 * 24;

  const int b = blockIdx.z;
  const int i0 = blockIdx.y * qh, j0 = blockIdx.x * L2_TQ;  // first quad
  const int h = R / 4, w = C / 4, Cl = C / 2;
  const T* xb = x + static_cast<int64_t>(b) * R * C;

  col_stage<T, MT, NP>(xb, st, R, C, 4 * i0, 4 * j0, qh, m, tp);
  __syncthreads();

  const int items = qh * 32;
  for (int it = threadIdx.x; it < items; it += L2_THREADS) {
    const int qi = it >> 5, g = it & 31;  // quad row, quad pair
    const int i = i0 + qi, j = j0 + 2 * g;
    if (i >= h) continue;  // uniform across the warp
    // the item's lowpass columns inside the row: 0, 2 or 4 (C / 2 is even)
    const int nc = Cl - 2 * j < 4 ? (Cl - 2 * j > 0 ? Cl - 2 * j : 0) : 4;
    A y05[2][4], y23[2][4], y14[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const A* row = st + (2 * qi + s) * rst + 4 * g;
      A ll[4];
      row_filters<A, MT, 2>(row, xh, m, tp, 0, 1, ll, y23[s]);
      if constexpr (BP) {
        row_filters<A, MT, 1>(row + img, xh, m, tp, 0, 0, y05[s], y05[s]);
        row_filters<A, MT, 1>(row + 2 * img, xh, m, tp, 2, 2, y14[s],
                              y14[s]);
      } else {
        row_filters<A, MT, 2>(row + img, xh, m, tp, 0, 1, y05[s], y14[s]);
      }
      T* o = lolo + (static_cast<int64_t>(b) * (R / 2) + 2 * i + s) * Cl +
             2 * j;
      if (vlo && nc == 4) {
        Vec<T, 4> pk;
#pragma unroll
        for (int v = 0; v < 4; ++v) store(&pk.v[v], ll[v]);
        *reinterpret_cast<Vec<T, 4>*>(o) = pk;
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (v < nc) store(o + v, ll[v]);
      }
    }

    // the two quads' six subbands, degree order
    A re[2][6], im[2][6];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int u = 2 * q;
      q2c(y05[0][u], y05[0][u + 1], y05[1][u], y05[1][u + 1], re[q][0],
          im[q][0], re[q][5], im[q][5]);
      q2c(y23[0][u], y23[0][u + 1], y23[1][u], y23[1][u + 1], re[q][2],
          im[q][2], re[q][3], im[q][3]);
      q2c(y14[0][u], y14[0][u + 1], y14[1][u], y14[1][u + 1], re[q][1],
          im[q][1], re[q][4], im[q][4]);
    }
    if constexpr (PLANES) {
      const int nq = nc / 2;
      T* pr = static_cast<T*>(out_a);
      T* pi = static_cast<T*>(out_b);
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        const int64_t off =
            ((static_cast<int64_t>(b) * 6 + plane_pos(d)) * h + i) * w + j;
        if (vpl && nq == 2) {
          Vec<T, 2> a, e;
          store(&a.v[0], re[0][d]);
          store(&a.v[1], re[1][d]);
          store(&e.v[0], im[0][d]);
          store(&e.v[1], im[1][d]);
          *reinterpret_cast<Vec<T, 2>*>(pr + off) = a;
          *reinterpret_cast<Vec<T, 2>*>(pi + off) = e;
        } else {
#pragma unroll
          for (int q = 0; q < 2; ++q)
            if (q < nq) {
              store(pr + off + q, re[q][d]);
              store(pi + off + q, im[q][d]);
            }
        }
      }
    } else {
      // the warp's 64 quads are contiguous in the output: stage its lanes'
      // 24 values each in shared memory, then store 16-byte pieces, lanes
      // on consecutive pieces
      constexpr int VN = l1_vn<A>();
#pragma unroll
      for (int e = 0; e < 24 / VN; ++e) {
        Vec<A, VN> pk;
#pragma unroll
        for (int u = 0; u < VN; ++u) {
          const int k = (e * VN + u) % 12, q = (e * VN + u) / 12;
          pk.v[u] = k % 2 ? im[q][k / 2] : re[q][k / 2];
        }
        *reinterpret_cast<Vec<A, VN>*>(zs + 24 * g + e * VN) = pk;
      }
      __syncwarp();
      const int quads = w - j0 < L2_TQ ? w - j0 : L2_TQ;  // warp's own
      A* z = static_cast<A*>(out_a) +
             ((static_cast<int64_t>(b) * h + i) * w + j0) * 12;
#pragma unroll
      for (int e = 0; e < 24 / VN; ++e) {
        const int piece = e * 32 + g;
        if (piece * VN < quads * 12)
          *reinterpret_cast<Vec<A, VN>*>(z + piece * VN) =
              *reinterpret_cast<const Vec<A, VN>*>(zs + piece * VN);
      }
      __syncwarp();
    }
  }
}

template <typename T, bool PLANES, bool BP, int MT>
cudaError_t run_level2(const void* x, void* lolo, void* out_a, void* out_b,
                       int B, int R, int C,
                       const L2Taps<typename AccOf<T>::type>& tp, int m,
                       int qh, int vlo, int vpl, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  const size_t smem =
      sizeof(A) * (static_cast<size_t>((BP ? 3 : 2) * 2 * qh) * 2 * l2_xh(m) +
                   (PLANES ? 0 : L2_THREADS * 24));
  const dim3 grid((C / 4 + L2_TQ - 1) / L2_TQ, (R / 4 + qh - 1) / qh, B);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  auto kernel = fwd_level2_kernel<T, PLANES, BP, MT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, L2_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(lolo), out_a, out_b, R, C, qh,
      m, vlo, vpl, tp);
  return cudaGetLastError();
}

template <typename T, bool PLANES, bool BP>
cudaError_t level2_mt(const void* x, void* lolo, void* out_a, void* out_b,
                      int B, int R, int C, const double* taps,
                      const int* offs, const double* taps2, const int* offs2,
                      int m, int qh, int mt, int vlo, int vpl,
                      cudaStream_t s) {
  using A = typename AccOf<T>::type;
  L2Taps<A> tp{};
  if (!set_l2pair(&tp, 0, taps, offs, m) ||
      !set_l2pair(&tp, 1, taps + 2 * m, offs + 2, m) ||
      (BP && !set_l2pair(&tp, 2, taps2, offs2, m)))
    return cudaErrorInvalidValue;
  // the host's tiling: its tap bound, 4, 8 or 16 quad rows a tile, vectors
  // only where rows and planes are long and aligned enough for them
  if (mt != l2_tap_bound<A, BP>(m) ||
      (qh != 4 && qh != 8 && qh != 16) ||
      (vlo && ((C / 2) % 4 || reinterpret_cast<uintptr_t>(lolo) %
                                  (4 * sizeof(T)))) ||
      (vpl && (!PLANES || (C / 4) % 2 ||
               reinterpret_cast<uintptr_t>(out_a) % (2 * sizeof(T)) ||
               reinterpret_cast<uintptr_t>(out_b) % (2 * sizeof(T)))) ||
      (!PLANES && reinterpret_cast<uintptr_t>(out_a) % 16))
    return cudaErrorInvalidValue;
  switch (mt) {
    case 10:
      if constexpr (sizeof(A) != 8 && !BP)
        return run_level2<T, PLANES, BP, 10>(x, lolo, out_a, out_b, B, R, C,
                                             tp, m, qh, vlo, vpl, s);
      break;
    case 14:
      if constexpr (sizeof(A) != 8)
        return run_level2<T, PLANES, BP, 14>(x, lolo, out_a, out_b, B, R, C,
                                             tp, m, qh, vlo, vpl, s);
      break;
    case 16:
      if constexpr (sizeof(A) != 8)
        return run_level2<T, PLANES, BP, 16>(x, lolo, out_a, out_b, B, R, C,
                                             tp, m, qh, vlo, vpl, s);
      break;
    case 24:
      if constexpr (sizeof(A) != 8 && !BP)
        return run_level2<T, PLANES, BP, 24>(x, lolo, out_a, out_b, B, R, C,
                                             tp, m, qh, vlo, vpl, s);
      break;
    case 32:
      return run_level2<T, PLANES, BP, 32>(x, lolo, out_a, out_b, B, R, C,
                                           tp, m, qh, vlo, vpl, s);
  }
  return cudaErrorInvalidValue;
}

template <bool BP>
cudaError_t level2_dtype(const void* x, void* lolo, void* out_a, void* out_b,
                         int B, int R, int C, const double* taps,
                         const int* offs, const double* taps2,
                         const int* offs2, int m, int dtype, int planes,
                         int qh, int mt, int vlo, int vpl, cudaStream_t s) {
  switch (dtype) {
    case DT_F32:
      return planes
                 ? level2_mt<float, true, BP>(x, lolo, out_a, out_b, B, R, C,
                                              taps, offs, taps2, offs2, m, qh,
                                              mt, vlo, vpl, s)
                 : level2_mt<float, false, BP>(x, lolo, out_a, out_b, B, R,
                                               C, taps, offs, taps2, offs2, m,
                                               qh, mt, vlo, vpl, s);
    case DT_BF16:
      if (!planes) return cudaErrorInvalidValue;
      return level2_mt<__nv_bfloat16, true, BP>(x, lolo, out_a, out_b, B, R,
                                                C, taps, offs, taps2, offs2,
                                                m, qh, mt, vlo, vpl, s);
    case DT_F64:
      return planes
                 ? level2_mt<double, true, BP>(x, lolo, out_a, out_b, B, R, C,
                                               taps, offs, taps2, offs2, m,
                                               qh, mt, vlo, vpl, s)
                 : level2_mt<double, false, BP>(x, lolo, out_a, out_b, B, R,
                                                C, taps, offs, taps2, offs2,
                                                m, qh, mt, vlo, vpl, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dtcwt

// taps: [pair (h0b/h0a, h1b/h1a)][stream][m]; offs: [pair][stream].
// taps2 / offs2: the bandpass families' third pair (h2b/h2a) as
// [stream][m] / [stream]; null for no third stream.  planes = 0: out_a is
// the interleaved complex [B, R/4, C/4, 6] as real pairs; planes = 1:
// out_a / out_b are the re / im planes [B, 6, R/4, C/4].  qh (quad rows a
// tile: 4, 8 or 16), mt (tap bound), vlo (4-wide lowpass stores) and vpl
// (2-wide plane stores): the host's tiling (ops/level2.py).
extern "C" int dtcwt_level2(const void* x, void* lolo, void* out_a,
                            void* out_b, int B, int R, int C,
                            const double* taps, const int* offs,
                            const double* taps2, const int* offs2, int m,
                            int dtype, int planes, int qh, int mt, int vlo,
                            int vpl, void* stream) {
  using namespace dtcwt;
  if (R % 4 || C % 4 || R < 4 || C < 4 || B < 1 || B > 65535 ||
      (taps2 == nullptr) != (offs2 == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return taps2 ? level2_dtype<true>(x, lolo, out_a, out_b, B, R, C, taps,
                                    offs, taps2, offs2, m, dtype, planes, qh,
                                    mt, vlo, vpl, s)
               : level2_dtype<false>(x, lolo, out_a, out_b, B, R, C, taps,
                                     offs, taps2, offs2, m, dtype, planes, qh,
                                     mt, vlo, vpl, s);
}
