// The single-stream non-decimating filter along any axis of a contiguous
// tensor (CUDA C++, sm_90a):
//
//   Y[i] = sum_{k < m} t[k] x[i + c + k],   i < g
//
// t the reversed taps, g = n + 1 - m % 2 outputs (n for odd m, n + 1 for
// even m).  Reflect mode: c = -(m / 2) and x is read at symmetric
// reflection of a length-n_in axis (reflect() in common.cuh, folded as
// often as needed, so a signal shorter than the filter works).
// From-extension mode: n_in is the length of a buffer the caller has
// already extended and c = side - m / 2 >= 0; the host checks that every
// read of a real tap stays inside it.
//
// Replaces the Pallas kernel of dtcwt_tpu/ops/pallas_fb.py, _build_filter
// (entries filter_axis and filter_fromext_axis).
//
// Bound on the H100: device memory bytes.  Each output costs m <= 32
// multiply-adds against 8 bytes moved (float32), far under the card's ~20
// float32 operations per byte, so the design moves many bytes per block,
// reads every input once and writes every output once, and keeps the
// per-output work off the memory pipe:
//
// * the taps travel by value in the kernel's parameters (FilterTaps), so
//   no block reads a table, and the tap loop runs to MT (8, 16 or 32,
//   chosen by the host) under a uniform guard k < m;
// * rows (inner = 1): a block stages a flat, contiguous range of the input
//   (several whole rows of a short axis, or one segment of a long row with
//   its halo) into shared memory with 16-byte cp.async copies, a scalar
//   head and tail taking any alignment; each thread then takes V
//   consecutive outputs (16 bytes of storage) from a register window of
//   V + m - 1 samples and stores them as one 16-byte vector where the
//   output row allows.  Only windows that cross a row's end reflect;
// * columns (inner > 1): no shared memory; each thread owns VC adjacent
//   columns (one 16- or 8-byte vector where inner and the pointers allow)
//   and RV consecutive output rows, loads the RV + MT - 1 input rows they
//   need once, coalesced across the warp, and adds each into the outputs
//   it reaches.  Rows reflect only where they leave the axis.
//
// The host (ops/single.py, _filter_geometry) chooses the path and tiling
// and passes them in; the kernel refuses any other combination.
#include <climits>

#include "common.cuh"

namespace dtcwt {
namespace {

constexpr int FILTER_THREADS = 256;
constexpr int FILTER_RV = 8;  // output rows per thread on the columns path

template <typename A> struct FilterTaps {
  A t[MAX_TAPS];  // reversed taps, zero past m
};

// One block's staged rows: the shared copy xs (xs[pad + e] is input
// element f0 + e, e < len, f0 the flat index of in-row sample a of the
// block's first row o0), and its outputs s0 .. end - 1 of each row in y.
template <typename T> struct RowTile {
  const T* xs;
  T* y;
  int64_t o0;
  int s0, end, n_in, g, c, refl, m, a, pad, len;
  bool vec_out;
};

// Outputs s0 + q V .. + V - 1 of staged row r from a register window of
// V + MT - 1 samples.  FAST: the window lies inside the row.
template <typename T, int MT, bool FAST>
__device__ __forceinline__ void rows_item(
    const RowTile<T>& b, const FilterTaps<typename AccOf<T>::type>& taps,
    int r, int q) {
  using A = typename AccOf<T>::type;
  constexpr int V = vec16<T>();
  constexpr int W = V + MT - 1;
  const int i0 = b.s0 + q * V;
  const int j0 = i0 + b.c;
  const int rbase = r * b.n_in - b.a + b.pad;  // shared index of in-row 0
  const int reach = V + b.m - 1;  // window samples a real tap reads
  A w[W];
  if constexpr (FAST) {
    const T* p = b.xs + rbase + j0;
#pragma unroll
    for (int t = 0; t < W; ++t) w[t] = t < reach ? load(p + t) : A(0);
  } else {  // the clamp moves only reads of outputs past end, not stored
#pragma unroll
    for (int t = 0; t < W; ++t) {
      const int jj = source(j0 + t, b.n_in, b.refl);
      int s = rbase + (jj < 0 ? 0 : jj);
      s = s < b.pad ? b.pad : (s >= b.pad + b.len ? b.pad + b.len - 1 : s);
      const A v = load(b.xs + s);
      w[t] = (t < reach && jj >= 0) ? v : A(0);
    }
  }
  A acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0;
#pragma unroll
  for (int k = 0; k < MT; ++k) {
    if (k < b.m) {
      const A tk = taps.t[k];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] += tk * w[v + k];
    }
  }
  T* out = b.y + (b.o0 + r) * static_cast<int64_t>(b.g) + i0;
  const int nv = b.end - i0 < V ? b.end - i0 : V;
  if (b.vec_out && nv == V) {
    store_pack<T, A, V>(out, acc);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < nv) store(out + v, acc[v]);
  }
}

// Rows path (inner = 1).  Block b: segment b % n_seg of rows
// (b / n_seg) * R .. + R - 1; segment s covers outputs [s L, s L + L).
template <typename T, int MT>
__global__ void __launch_bounds__(FILTER_THREADS)
    filter_rows(const T* __restrict__ x, T* __restrict__ y, int outer,
                int n_in, int g, int c, int refl, int m, int R, int L,
                int n_seg,
                const __grid_constant__ FilterTaps<typename AccOf<T>::type>
                    taps) {
  constexpr int V = vec16<T>();  // outputs per thread item: 16 bytes
  constexpr int VEC = vec16<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int s0 = static_cast<int>(blockIdx.x % n_seg) * L;
  const int64_t o0 = static_cast<int64_t>(blockIdx.x / n_seg) * R;
  const int rows = static_cast<int>(
      outer - o0 < static_cast<int64_t>(R) ? outer - o0 : R);
  const int lr = g - s0 < L ? g - s0 : L;  // outputs of the tile per row

  // stage the flat range [f0, f0 + len): rows o0 .. o0 + rows - 1 from
  // in-row sample a of the first to sample b of the last
  const int a = s0 + c > 0 ? s0 + c : 0;
  const int b = s0 + c + L + MT - 1 < n_in ? s0 + c + L + MT - 1 : n_in;
  const int64_t f0 = o0 * n_in + a;
  const int len = (rows - 1) * n_in + (b - a);
  const T* src = x + f0;
  const int pad = static_cast<int>(
      (reinterpret_cast<uintptr_t>(src) % 16) / sizeof(T));
  T* dst = xs + pad;  // dst[e] = src[e]; both 16-byte congruent
  const int head = (VEC - pad) % VEC < len ? (VEC - pad) % VEC : len;
  const int nvec = (len - head) / VEC;
  for (int e = tid; e < head; e += FILTER_THREADS) dst[e] = src[e];
  for (int q = tid; q < nvec; q += FILTER_THREADS)
    cp_async16(dst + head + q * VEC, src + head + q * VEC);
  for (int e = head + nvec * VEC + tid; e < len; e += FILTER_THREADS)
    dst[e] = src[e];
  cp_async_wait_all();
  __syncthreads();

  const bool vec_out =
      g % V == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  // chunks [q_lo, q_hi) of V outputs read inside their row; the others,
  // at the row's ends, reflect or read zero, in a loop of their own so
  // that no warp of the interior diverges
  const int chunks = (lr + V - 1) / V;
  const int reach = V + m - 1;  // window samples a real tap reads
  const int lo = -(s0 + c);     // j0 >= 0 <=> q V >= lo
  const int hi = n_in - reach - s0 - c;  // j0 + reach <= n_in <=> q V <= hi
  const int q_lo = lo > 0 ? min(chunks, (lo + V - 1) / V) : 0;
  const int q_hi = max(q_lo, min(chunks, hi < 0 ? 0 : hi / V + 1));
  const int ni = q_hi - q_lo, ne = chunks - ni;
  const RowTile<T> tile{xs, y, o0, s0, s0 + lr, n_in, g, c, refl, m, a,
                        pad, len, vec_out};
  for (int it = tid; it < rows * ni; it += FILTER_THREADS) {
    const int r = it / ni;
    rows_item<T, MT, true>(tile, taps, r, q_lo + it - r * ni);
  }
  for (int it = tid; it < rows * ne; it += FILTER_THREADS) {
    const int r = it / ne, k = it - r * ne;
    rows_item<T, MT, false>(tile, taps, r, k < q_lo ? k : q_hi + k - q_lo);
  }
}

// Columns path (inner > 1).  Block b: column tile b % n_ct, row tile
// (b / n_ct) % n_rt, outer index b / (n_ct n_rt); thread (tx, ty) =
// (tid % TX, tid / TX) owns columns ((ct TX + tx) VC ..) + VC - 1 and
// output rows ((rt TY + ty) RV ..) + RV - 1, TY = threads / TX.
template <typename T, int MT, int VC>
__global__ void __launch_bounds__(FILTER_THREADS)
    filter_cols(const T* __restrict__ x, T* __restrict__ y, int n_in,
                int inner, int g, int c, int refl, int m, int lgTX,
                int n_rt, int n_ct,
                const __grid_constant__ FilterTaps<typename AccOf<T>::type>
                    taps) {
  using A = typename AccOf<T>::type;
  constexpr int RV = FILTER_RV;
  const int tid = threadIdx.x;
  const int tx = tid & ((1 << lgTX) - 1), ty = tid >> lgTX;
  const int ct = static_cast<int>(blockIdx.x % n_ct);
  const int rt = static_cast<int>((blockIdx.x / n_ct) % n_rt);
  const int64_t o = blockIdx.x / (static_cast<int64_t>(n_ct) * n_rt);
  const int col = ((ct << lgTX) + tx) * VC;
  const int i0 = (rt * (FILTER_THREADS >> lgTX) + ty) * RV;
  if (col >= inner || i0 >= g) return;
  const T* xo = x + o * n_in * static_cast<int64_t>(inner) + col;

  A acc[RV][VC];
#pragma unroll
  for (int v = 0; v < RV; ++v)
#pragma unroll
    for (int u = 0; u < VC; ++u) acc[v][u] = 0;
#pragma unroll
  for (int r = 0; r < RV + MT - 1; ++r) {
    const int jj = source(i0 + c + r, n_in, refl);
    A xv[VC];
    load_pack<T, A, VC>(xo + static_cast<int64_t>(jj < 0 ? 0 : jj) * inner,
                        xv);
    if (jj < 0) {
#pragma unroll
      for (int u = 0; u < VC; ++u) xv[u] = 0;
    }
#pragma unroll
    for (int k = 0; k < MT; ++k) {
      const int v = r - k;  // the output row this sample reaches with tap k
      if (v >= 0 && v < RV && k < m) {
        const A tk = taps.t[k];
#pragma unroll
        for (int u = 0; u < VC; ++u) acc[v][u] += tk * xv[u];
      }
    }
  }
  T* out = y + (o * g + i0) * static_cast<int64_t>(inner) + col;
#pragma unroll
  for (int v = 0; v < RV; ++v)
    if (i0 + v < g) store_pack<T, A, VC>(out + static_cast<int64_t>(v) * inner,
                                         acc[v]);
}

template <typename Kernel, typename... Args>
cudaError_t launch_filter(Kernel kernel, int64_t blocks, size_t smem,
                          cudaStream_t stream, Args... args) {
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidValue;
  if (smem > 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), FILTER_THREADS, smem, stream>>>(
      args...);
  return cudaGetLastError();
}

template <typename T, int MT>
cudaError_t run_filter(const void* x, void* y, int outer, int n_in,
                       int inner, int g, int c, int refl, int m,
                       const double* taps, int path, int v, int vc,
                       int rows, int seg, int tx, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  FilterTaps<A> tp;
  for (int k = 0; k < MAX_TAPS; ++k)
    tp.t[k] = k < m ? static_cast<A>(taps[k]) : A(0);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (path == 0) {  // rows
    constexpr int V = vec16<T>();
    if (inner != 1 || v != V || vc != 1 || rows < 1 || seg < V ||
        seg % V || tx != 1)
      return cudaErrorInvalidValue;
    const int n_seg = (g + seg - 1) / seg;
    if (n_seg > 1 && rows != 1) return cudaErrorInvalidValue;
    const int64_t last = seg + MT - 1 < n_in ? seg + MT - 1 : n_in;
    const int64_t elems = vec16<T>() + static_cast<int64_t>(rows - 1) * n_in
                          + last;
    if (elems * static_cast<int64_t>(sizeof(T)) > INT_MAX)
      return cudaErrorInvalidValue;
    const int64_t blocks =
        (static_cast<int64_t>(outer) + rows - 1) / rows * n_seg;
    return launch_filter(filter_rows<T, MT>, blocks, elems * sizeof(T),
                         stream, xt, yt, outer, n_in, g, c, refl, m, rows,
                         seg, n_seg, tp);
  }
  if (path != 1 || inner < 2 || v != FILTER_RV || rows != 1 || tx < 1 ||
      tx > FILTER_THREADS || (tx & (tx - 1)) ||
      seg != (FILTER_THREADS / tx) * FILTER_RV)
    return cudaErrorInvalidValue;
  int lgTX = 0;
  while ((1 << lgTX) < tx) ++lgTX;
  const int n_rt = (g + seg - 1) / seg;
  const int64_t n_ct = (static_cast<int64_t>(inner) + tx * vc - 1) /
                       (static_cast<int64_t>(tx) * vc);
  const int64_t blocks = static_cast<int64_t>(outer) * n_rt * n_ct;
  if (vc == 1)
    return launch_filter(filter_cols<T, MT, 1>, blocks, 0, stream, xt, yt,
                         n_in, inner, g, c, refl, m, lgTX, n_rt,
                         static_cast<int>(n_ct), tp);
  constexpr int VC = col_vec<T>();
  const uintptr_t align = VC * sizeof(T);
  if (vc != VC || inner % VC || reinterpret_cast<uintptr_t>(x) % align ||
      reinterpret_cast<uintptr_t>(y) % align)
    return cudaErrorInvalidValue;
  return launch_filter(filter_cols<T, MT, VC>, blocks, 0, stream, xt, yt,
                       n_in, inner, g, c, refl, m, lgTX, n_rt,
                       static_cast<int>(n_ct), tp);
}

template <typename T>
cudaError_t dispatch_mt(const void* x, void* y, int outer, int n_in,
                        int inner, int g, int c, int refl, int m,
                        const double* taps, int mt, int path, int v, int vc,
                        int rows, int seg, int tx, cudaStream_t st) {
  if (m > mt) return cudaErrorInvalidValue;
  switch (mt) {
    case 8:
      return run_filter<T, 8>(x, y, outer, n_in, inner, g, c, refl, m, taps,
                              path, v, vc, rows, seg, tx, st);
    case 16:
      return run_filter<T, 16>(x, y, outer, n_in, inner, g, c, refl, m,
                               taps, path, v, vc, rows, seg, tx, st);
    case 32:
      return run_filter<T, 32>(x, y, outer, n_in, inner, g, c, refl, m,
                               taps, path, v, vc, rows, seg, tx, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dtcwt

// x: the contiguous input viewed as [outer, n_in, inner]; y: [outer, g,
// inner].  c: offset of the first tap's sample for output 0 (-(m / 2), or
// side - m / 2 in the from-extension mode, refl = 0).  taps: host float64,
// the m reversed taps.  mt (8, 16, 32 >= m), path (0 rows, 1 columns), v
// (outputs per thread along the axis), vc (columns per thread), rows
// (outer rows per block, rows path), seg (outputs per block along the
// axis), tx (threads across inner, columns path): the host's tiling.
extern "C" int dtcwt_filter(const void* x, void* y, int outer, int n_in,
                            int inner, int g, int c, int refl, int m,
                            const double* taps, int mt, int path, int v,
                            int vc, int rows, int seg, int tx, int dtype,
                            void* stream) {
  if (outer < 1 || n_in < 1 || inner < 1 || g < 1 || m < 1 ||
      m > dtcwt::MAX_TAPS)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dtcwt::DT_F32:
      return dtcwt::dispatch_mt<float>(x, y, outer, n_in, inner, g, c, refl,
                                       m, taps, mt, path, v, vc, rows, seg,
                                       tx, st);
    case dtcwt::DT_BF16:
      return dtcwt::dispatch_mt<__nv_bfloat16>(x, y, outer, n_in, inner, g,
                                               c, refl, m, taps, mt, path, v,
                                               vc, rows, seg, tx, st);
    case dtcwt::DT_F64:
      return dtcwt::dispatch_mt<double>(x, y, outer, n_in, inner, g, c, refl,
                                        m, taps, mt, path, v, vc, rows, seg,
                                        tx, st);
  }
  return cudaErrorInvalidValue;
}
