// The stream-plan filter kernel of the single-stream kernels dfilt and
// ifilt (single.cu), along any axis of a contiguous tensor (CUDA C++,
// sm_90a).  The single-stream non-decimating filter has a kernel of its
// own (filter.cu), and so have the dual-stream kernels of dual.cu (the
// analysis entries in streamana.cuh, the synthesis sums in streamsum.cuh).
//
// A branch is a set of P output streams (host plans, ops/dual.py):
//
//   Y[P g + s] = sum_{k < len[s]} t[s][k] x[D g + c[s] + S k]
//
//   dfilt  (P, D, S) = (2, 4, 2): level2.dfilt_streams
//   ifilt            = (4, 2, 2): ilevel2.ifilt_streams
//
// so the kernel holds no parity logic.  Each stream has its own tap count
// and offset, and x is read at symmetric reflection (reflect() in
// common.cuh, folded as often as needed, so a signal shorter than the
// filter works), or, in the from-extension mode, at side + index in a
// buffer the caller has already extended (the host adds side to every
// offset and checks that the reads stay inside).
//
// Layout: the filtered axis of a contiguous tensor is viewed as
// [outer, n, inner] with strides (n * inner, inner, 1); no transpose.  A
// block owns TG output groups by TI (a power of two <= 64) inner columns of
// one outer index.  It stages the input rows those groups need, halo
// included, in shared memory with neighbouring threads on neighbouring
// columns (inner >= 32: coalesced across inner) or, for inner = 1, on
// neighbouring rows (coalesced along n), then computes every output of the
// tile from shared memory and writes it once.
//
// Bound on the H100: device memory bytes.  Each output costs a few tens of
// multiply-adds against 4-8 bytes moved, far below the card's ~20 float32
// operations per byte, so the design reads every input once per tile (the
// halo re-read is (halo / (D * TG)) of it) and writes every output once.
#pragma once

#include <climits>

#include "common.cuh"

namespace dtcwt {

constexpr int STREAM_THREADS = 256;
constexpr int STREAM_OUTPUTS = 4096;   // outputs per block
constexpr int STREAM_MAX_TI = 64;
constexpr int TAP_STRIDE = MAX_TAPS + 1;  // shared tap rows: no bank clash

template <int P> struct StreamPlan {
  int len[P];  // taps per stream
  int off[P];  // first input row of stream s, relative to the tile
};

template <typename T, int P, int D, int S>
__global__ void __launch_bounds__(STREAM_THREADS)
    stream_kernel(const T* __restrict__ in0, T* __restrict__ out0, int n_in,
                  int inner, int ng, int refl, int TG, int lgTI, int XR,
                  int cmin, int n_gt, int n_ct,
                  const double* __restrict__ taps, StreamPlan<P> plan) {
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* xs = reinterpret_cast<A*>(smem_raw);  // [XR][TI]
  __shared__ A tap_s[P * TAP_STRIDE];
  __shared__ int len_s[P], off_s[P];

  const int TI = 1 << lgTI;
  const int tid = threadIdx.x;
  const int64_t blk = blockIdx.x;
  const int gt = static_cast<int>(blk % n_gt);
  const int ct = static_cast<int>((blk / n_gt) % n_ct);
  const int64_t o = blk / (static_cast<int64_t>(n_gt) * n_ct);
  const int gbase = gt * TG, cbase = ct * TI;

  for (int i = tid; i < P * MAX_TAPS; i += STREAM_THREADS)
    tap_s[(i / MAX_TAPS) * TAP_STRIDE + i % MAX_TAPS] =
        static_cast<A>(taps[i]);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < P; ++s) {
      len_s[s] = plan.len[s];
      off_s[s] = plan.off[s];
    }
  }

  // stage input rows D * gbase + cmin + r, r < XR
  const int rows_per = STREAM_THREADS >> lgTI;
  const int tc = tid & (TI - 1), tr = tid >> lgTI;
  const int col = cbase + tc;
  const bool col_ok = col < inner;
  const int rstart = D * gbase + cmin;
  {
    const T* src = in0 + o * static_cast<int64_t>(n_in) * inner + col;
    A* dst = xs + tc;
    for (int r = tr; r < XR; r += rows_per) {
      int g = rstart + r;
      if (refl) g = reflect(g, n_in);
      A v = 0;
      if (col_ok && g >= 0 && g < n_in)
        v = load(src + static_cast<int64_t>(g) * inner);
      dst[r * TI] = v;
    }
  }
  __syncthreads();

  const int64_t ob0 = o * static_cast<int64_t>(P) * ng * inner + col;
  for (int j = tr; j < P * TG; j += rows_per) {
    const int gl = j / P, s = j - gl * P;
    const int g = gbase + gl;
    if (!col_ok || g >= ng) continue;
    const A* xp = xs + static_cast<int64_t>(D * gl + off_s[s]) * TI + tc;
    const A* tp = tap_s + s * TAP_STRIDE;
    const int len = len_s[s];
    A a = 0;
    for (int k = 0; k < len; ++k) a += tp[k] * xp[k * S * TI];
    store(out0 + ob0 + static_cast<int64_t>(P * g + s) * inner, a);
  }
}

template <typename T, int P, int D, int S>
cudaError_t run_streams(const void* in0, void* out0, int outer, int n_in,
                        int inner, int ng, int refl, const double* taps,
                        const int* lens, const int* offs,
                        cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  StreamPlan<P> plan;
  int cmin = INT_MAX, cend = INT_MIN;
  for (int s = 0; s < P; ++s) {
    const int len = lens[s], c = offs[s];
    if (len < 1 || len > MAX_TAPS) return cudaErrorInvalidValue;
    cmin = c < cmin ? c : cmin;
    cend = c + S * (len - 1) > cend ? c + S * (len - 1) : cend;
  }
  for (int s = 0; s < P; ++s) {
    plan.len[s] = lens[s];
    plan.off[s] = offs[s] - cmin;
  }
  int lgTI = 0;
  while ((1 << lgTI) < inner && (1 << lgTI) < STREAM_MAX_TI) ++lgTI;
  const int TI = 1 << lgTI;
  int TG = STREAM_OUTPUTS / (P * TI);
  if (TG < 1) TG = 1;
  if (TG > ng) TG = ng;
  const int XR = D * (TG - 1) + (cend - cmin) + 1;
  const size_t smem = sizeof(A) * static_cast<size_t>(XR) * TI;
  const int n_gt = (ng + TG - 1) / TG;
  const int n_ct = (inner + TI - 1) / TI;
  const int64_t blocks = static_cast<int64_t>(outer) * n_gt * n_ct;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = stream_kernel<T, P, D, S>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), STREAM_THREADS, smem, stream>>>(
      static_cast<const T*>(in0), static_cast<T*>(out0), n_in, inner, ng,
      refl, TG, lgTI, XR, cmin, n_gt, n_ct, taps, plan);
  return cudaGetLastError();
}

template <int P, int D, int S>
int dispatch_streams(const void* in0, void* out0, int outer, int n_in,
                     int inner, int ng, int refl, const double* taps,
                     const int* lens, const int* offs, int dtype,
                     void* stream) {
  if (outer < 1 || n_in < 1 || inner < 1 || ng < 1)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return run_streams<float, P, D, S>(in0, out0, outer, n_in, inner, ng,
                                         refl, taps, lens, offs, st);
    case DT_BF16:
      return run_streams<__nv_bfloat16, P, D, S>(in0, out0, outer, n_in,
                                                 inner, ng, refl, taps,
                                                 lens, offs, st);
    case DT_F64:
      return run_streams<double, P, D, S>(in0, out0, outer, n_in, inner,
                                          ng, refl, taps, lens, offs, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace dtcwt

// Common C interface of the stream kernels.  taps: device float64 [P
// streams][MAX_TAPS]; lens, offs: host [P].  ng: output groups (P * ng
// rows).  refl = 1: read x at reflected indices of a length-n_in axis;
// refl = 0: n_in is the length of a pre-extended buffer and offs already
// include its side.
#define DTCWT_STREAM_EXPORT(name, P, D, S)                                   \
  extern "C" int name(const void* in0, void* out0, int outer, int n_in,     \
                      int inner, int ng, int refl, const double* taps,     \
                      const int* lens, const int* offs, int dtype,          \
                      void* stream) {                                       \
    return dtcwt::dispatch_streams<P, D, S>(in0, out0, outer, n_in, inner,  \
                                            ng, refl, taps, lens, offs,    \
                                            dtype, stream);                 \
  }
