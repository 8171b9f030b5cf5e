// Level-1 forward of the 2-D DTCWT in one kernel (CUDA C++, sm_90a).
//
// Replaces the Pallas kernel dtcwt_tpu/ops/pallas_level1.py:fwd_level1
// (built by _build_level1).  Computes, with odd biorthogonal filters h0o, h1o
// and symmetric extension:
//
//   lo = colfilter(x, h0)   hi = colfilter(x, h1)
//   lolo = rowfilter(lo, h0)                         -> [B, R, C]
//   q2c(rowfilter(hi, h0)) -> bands 0, 5
//   q2c(rowfilter(lo, h1)) -> bands 2, 3             -> [B, R/2, C/2, 6]
//   q2c(rowfilter(hi, h1)) -> bands 1, 4                complex, or planes
//
// The bandpass families (near_sym_b_bp) add a third odd filter h2o, the
// third stream (template flag BP): bands 1, 4 become
// q2c(rowfilter(colfilter(x, h2), h2)), from a third column image.
//
// Bound on the H100: device memory bytes.  Per input sample it reads 1
// value and writes 4 (the lowpass plus 6 complex subbands at quarter
// resolution) for (m0 + m1) * 3 multiply-adds, far under the card's ratio
// of operations to bytes.  What held a first, simpler design back was the
// work it issued per byte (a modulo and a division per staged sample, tap
// loops of run-time length reading the taps from memory) and its scalar
// stores 48 bytes apart.  This design keeps the issue per byte small and
// every store wide:
//
// * Taps travel by value in the kernel's parameters (L1Taps), each filter
//   centred on the common halo p (zero outside its own reach), so every
//   tap loop runs to MT (8, 16, 24 or 32 >= 2 p + 1, chosen by the host)
//   under one uniform guard k < 2 p + 1, with compile-time register
//   indices.
// * A block owns a tile of TH (32 or 64) x 128 output pixels.  Column
//   stage: an item is one staged column (128 + 2 p of them, lanes on
//   consecutive columns, coalesced) by 16 output rows; it loads the
//   16 + 2 p input samples it needs once into registers and writes the 16
//   column-filtered values of each stream (2, or 3 with BP) to shared
//   memory.  Only tiles whose rows reach past the image reflect their
//   rows; a column reflects once an item, with one fold (two compares)
//   and the modulo of reflect() left to axes shorter than the reach.
// * Row stage: an item is one output quad row by 4 columns (2 quads), a
//   warp one quad row; it reads each stream's window of 4 + 2 p samples
//   with 16-byte shared loads (lanes 16 bytes apart: no bank conflict)
//   and filters it in registers.  The lowpass leaves as 4-wide vectors,
//   the planes as 2-wide vectors per band plane; in the interleaved layout
//   a warp's 64 quads are 3 KB of contiguous output, so the warp stages
//   them in shared memory and stores them as 16-byte pieces, lanes on
//   consecutive pieces.  The host says where a row or plane is too short
//   or misaligned for the vectors.
// * A block reads its 128 + 2 p columns by TH + 2 p rows of input from L2
//   (its row groups overlap in L1); device memory sees about one read of
//   the input, since neighbouring tiles run close in time.  Three or four
//   blocks an SM overlap one block's loads with another's arithmetic; no
//   intermediate image reaches device memory.
//
// The host (ops/level1.py, _level1_geometry) chooses TH, MT and the store
// vectors and passes them in; the kernel refuses any other combination.
// The tiling's pieces shared with the level-1 inverse are in l1tile.cuh.
#include "l1tile.cuh"

namespace dtcwt {
namespace {

constexpr int L1_RV = 16;  // output rows a column-stage item

// Column stage: stream s's column image of tile rows 0 .. th - 1 and
// staged columns 0 .. 128 + 2p - 1 (input column c0 - p + lc) into
// st[s][row][lc].
template <typename T, int MT, int NS>
__device__ __forceinline__ void col_stage(
    const T* __restrict__ xb, typename AccOf<T>::type* st, int R, int C,
    int r0, int c0, int th, int p,
    const L1Taps<typename AccOf<T>::type>& tp) {
  using A = typename AccOf<T>::type;
  const int mm = 2 * p + 1;
  const int xw = L1_TW + 2 * p, xws = l1_xws(p);
  const int items = th / L1_RV * xw;
  const bool rows_in = r0 - p >= 0 && r0 + th + p <= R;
  for (int it = threadIdx.x; it < items; it += L1_THREADS) {
    const int g = it / xw, lc = it - g * xw;
    const int gc = fold(c0 - p + lc, C);
    const int rs = r0 + g * L1_RV - p;  // input row of sample 0
    A s[L1_RV + MT - 1];
    col_load<T, L1_RV, MT>(xb, rs, gc, R, C, mm, rows_in, s);
#pragma unroll
    for (int si = 0; si < NS; ++si) {
      A acc[L1_RV];
#pragma unroll
      for (int v = 0; v < L1_RV; ++v) acc[v] = 0;
      fir_acc<A, MT, L1_RV>(s, tp.t[si], mm, acc);
      A* o = st + (si * th + g * L1_RV) * xws + lc;
#pragma unroll
      for (int v = 0; v < L1_RV; ++v) o[v * xws] = acc[v];
    }
  }
}

// out[v] = sum_k t[k] w[v + k], k < mm.
template <typename A, int MT>
__device__ __forceinline__ void fir4(const A* w, const A* t, int mm,
                                     A out[L1_V]) {
#pragma unroll
  for (int v = 0; v < L1_V; ++v) out[v] = 0;
  fir_acc<A, MT, L1_V>(w, t, mm, out);
}

template <typename T, bool PLANES, bool BP, int MT>
__global__ void __launch_bounds__(L1_THREADS)
    fwd_level1_kernel(const T* __restrict__ x, T* __restrict__ lolo,
                      void* out_a, void* out_b, int R, int C, int th, int p,
                      int vlo, int vpl,
                      const __grid_constant__ L1Taps<typename AccOf<T>::type>
                          tp) {
  using A = typename AccOf<T>::type;
  constexpr int NS = BP ? 3 : 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* st = reinterpret_cast<A*>(smem_raw);  // [NS][th][xws] column images
  // interleaved layout: each warp's subbands, [32 lanes][2 quads][12]
  A* zs = st + NS * th * l1_xws(p) + (threadIdx.x >> 5) * 32 * 24;

  const int b = blockIdx.z;
  const int r0 = blockIdx.y * th, c0 = blockIdx.x * L1_TW;
  const int mm = 2 * p + 1, xws = l1_xws(p);
  const int h = R / 2, w = C / 2;
  const T* xb = x + static_cast<int64_t>(b) * R * C;

  col_stage<T, MT, NS>(xb, st, R, C, r0, c0, th, p, tp);
  __syncthreads();

  const int items = th / 2 * (L1_TW / L1_V);
  for (int it = threadIdx.x; it < items; it += L1_THREADS) {
    const int qi = it >> 5, g = it & 31;  // quad row, column group
    const int r = r0 + 2 * qi, c = c0 + L1_V * g;
    if (r >= R || c0 >= C) continue;  // uniform across the warp
    // y[image][row][column]: lolo, rows(hi, h0), rows(lo, h1), bands 1/4
    A y[4][2][L1_V];
#pragma unroll
    for (int dr = 0; dr < 2; ++dr) {
      const A* row = st + (2 * qi + dr) * xws + L1_V * g;
      A wv[l1_nw<A, MT>()];
      row_window<A, MT>(row, mm, wv);
      fir4<A, MT>(wv, tp.t[0], mm, y[0][dr]);
      fir4<A, MT>(wv, tp.t[1], mm, y[2][dr]);
      row_window<A, MT>(row + th * xws, mm, wv);
      fir4<A, MT>(wv, tp.t[0], mm, y[1][dr]);
      if constexpr (BP) {
        row_window<A, MT>(row + 2 * th * xws, mm, wv);
        fir4<A, MT>(wv, tp.t[2], mm, y[3][dr]);
      } else {
        fir4<A, MT>(wv, tp.t[1], mm, y[3][dr]);
      }
    }

    // outputs of this item inside the row: 0, 2 or 4 (C is even)
    const int nc = C - c < L1_V ? (C - c > 0 ? C - c : 0) : L1_V;
    T* lb = lolo + (static_cast<int64_t>(b) * R + r) * C + c;
#pragma unroll
    for (int dr = 0; dr < 2; ++dr) {
      T* o = lb + static_cast<int64_t>(dr) * C;
      if (vlo && nc == L1_V) {
        Vec<T, L1_V> pk;
#pragma unroll
        for (int v = 0; v < L1_V; ++v) store(&pk.v[v], y[0][dr][v]);
        *reinterpret_cast<Vec<T, L1_V>*>(o) = pk;
      } else {
#pragma unroll
        for (int v = 0; v < L1_V; ++v)
          if (v < nc) store(o + v, y[0][dr][v]);
      }
    }

    // the two quads' six subbands, degree order
    A re[2][6], im[2][6];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int u = 2 * q;
      q2c(y[1][0][u], y[1][0][u + 1], y[1][1][u], y[1][1][u + 1], re[q][0],
          im[q][0], re[q][5], im[q][5]);
      q2c(y[2][0][u], y[2][0][u + 1], y[2][1][u], y[2][1][u + 1], re[q][2],
          im[q][2], re[q][3], im[q][3]);
      q2c(y[3][0][u], y[3][0][u + 1], y[3][1][u], y[3][1][u + 1], re[q][1],
          im[q][1], re[q][4], im[q][4]);
    }
    const int i = r / 2;
    if constexpr (PLANES) {
      const int j = c / 2, nq = nc / 2;
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
      const int quads = w - c0 / 2 < 64 ? w - c0 / 2 : 64;  // warp's own
      A* z = static_cast<A*>(out_a) +
             ((static_cast<int64_t>(b) * h + i) * w + c0 / 2) * 12;
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
cudaError_t run_level1(const void* x, void* lolo, void* out_a, void* out_b,
                       int B, int R, int C, const L1Taps<typename AccOf<
                           T>::type>& tp, int p, int th, int vlo, int vpl,
                       cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  const size_t smem =
      sizeof(A) * (static_cast<size_t>((BP ? 3 : 2) * th) * l1_xws(p) +
                   (PLANES ? 0 : L1_THREADS * 24));
  const dim3 grid((C + L1_TW - 1) / L1_TW, (R + th - 1) / th, B);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  auto kernel = fwd_level1_kernel<T, PLANES, BP, MT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, L1_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(lolo), out_a, out_b, R, C,
      th, p, vlo, vpl, tp);
  return cudaGetLastError();
}

template <typename T, bool PLANES, bool BP>
cudaError_t level1_mt(const void* x, void* lolo, void* out_a, void* out_b,
                      int B, int R, int C, const double* const t[3],
                      const int m[3], int th, int mt, int vlo, int vpl,
                      cudaStream_t s) {
  using A = typename AccOf<T>::type;
  L1Taps<A> tp;
  int p;
  if (!make_l1taps(&tp, &p, t, m, BP ? 3 : 2)) return cudaErrorInvalidValue;
  // the host's tiling: the least tap bound that holds 2 p + 1, 32 or 64
  // rows a tile, vectors only where rows and planes are aligned for them
  if (mt != l1_tap_bound(2 * p + 1) || (th != 32 && th != 64) ||
      (vlo && (C % L1_V || reinterpret_cast<uintptr_t>(lolo) %
                               (L1_V * sizeof(T)))) ||
      (vpl && (!PLANES || (C / 2) % 2 ||
               reinterpret_cast<uintptr_t>(out_a) % (2 * sizeof(T)) ||
               reinterpret_cast<uintptr_t>(out_b) % (2 * sizeof(T)))) ||
      (!PLANES && reinterpret_cast<uintptr_t>(out_a) % 16))
    return cudaErrorInvalidValue;
  switch (mt) {
    case 8:
      return run_level1<T, PLANES, BP, 8>(x, lolo, out_a, out_b, B, R, C, tp,
                                          p, th, vlo, vpl, s);
    case 16:
      return run_level1<T, PLANES, BP, 16>(x, lolo, out_a, out_b, B, R, C,
                                           tp, p, th, vlo, vpl, s);
    case 24:
      return run_level1<T, PLANES, BP, 24>(x, lolo, out_a, out_b, B, R, C,
                                           tp, p, th, vlo, vpl, s);
    case 32:
      return run_level1<T, PLANES, BP, 32>(x, lolo, out_a, out_b, B, R, C,
                                           tp, p, th, vlo, vpl, s);
  }
  return cudaErrorInvalidValue;
}

template <bool BP>
cudaError_t level1_dtype(const void* x, void* lolo, void* out_a, void* out_b,
                         int B, int R, int C, const double* const t[3],
                         const int m[3], int dtype, int planes, int th,
                         int mt, int vlo, int vpl, cudaStream_t s) {
  switch (dtype) {
    case DT_F32:
      return planes ? level1_mt<float, true, BP>(x, lolo, out_a, out_b, B, R,
                                                 C, t, m, th, mt, vlo, vpl, s)
                    : level1_mt<float, false, BP>(x, lolo, out_a, out_b, B,
                                                  R, C, t, m, th, mt, vlo,
                                                  vpl, s);
    case DT_BF16:
      if (!planes) return cudaErrorInvalidValue;
      return level1_mt<__nv_bfloat16, true, BP>(x, lolo, out_a, out_b, B, R,
                                                C, t, m, th, mt, vlo, vpl, s);
    case DT_F64:
      return planes ? level1_mt<double, true, BP>(x, lolo, out_a, out_b, B,
                                                  R, C, t, m, th, mt, vlo,
                                                  vpl, s)
                    : level1_mt<double, false, BP>(x, lolo, out_a, out_b, B,
                                                   R, C, t, m, th, mt, vlo,
                                                   vpl, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dtcwt

// t0, t1, t2: reversed taps of h0o, h1o and the bandpass families' h2o
// (t2 null: no third stream).  planes = 0: out_a is the interleaved complex
// [B, R/2, C/2, 6] as real pairs; planes = 1: out_a / out_b are the re / im
// planes [B, 6, R/2, C/2].  th (rows a tile, 32 or 64), mt (tap bound, the
// least of 8, 16, 32 holding 2 p + 1), vlo (4-wide lowpass stores) and vpl
// (2-wide plane stores): the host's tiling (ops/level1.py).
extern "C" int dtcwt_level1(const void* x, void* lolo, void* out_a,
                            void* out_b, int B, int R, int C, const double* t0,
                            int m0, const double* t1, int m1, const double* t2,
                            int m2, int dtype, int planes, int th, int mt,
                            int vlo, int vpl, void* stream) {
  using namespace dtcwt;
  if (R % 2 || C % 2 || R < 2 || C < 2 || B < 1 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double* const t[3] = {t0, t1, t2};
  const int m[3] = {m0, m1, t2 ? m2 : 0};
  return t2 ? level1_dtype<true>(x, lolo, out_a, out_b, B, R, C, t, m, dtype,
                                 planes, th, mt, vlo, vpl, s)
            : level1_dtype<false>(x, lolo, out_a, out_b, B, R, C, t, m,
                                  dtype, planes, th, mt, vlo, vpl, s);
}
