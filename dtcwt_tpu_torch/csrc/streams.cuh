// The stream-plan filter kernel shared by the single-stream kernels dfilt
// and ifilt (single.cu) and the dual-stream analysis kernels filter2 and
// dfilt2 (dual.cu), along any axis of a contiguous tensor (CUDA C++,
// sm_90a).  The single-stream non-decimating filter has a kernel of its
// own (filter.cu), and so have the dual-stream synthesis sums filter2_sum
// and ifilt2_sum (streamsum.cuh, exported by dual.cu).
//
// A kernel instance runs NB branches (1 or 2) over one input into one
// output a branch.  Every branch is a set of P output streams (host plans,
// ops/dual.py):
//
//   Y[P g + s] = sum_{k < len[s]} t[s][k] x[D g + c[s] + S k]
//
//   filter2      (P, D, S) = (1, 1, 1): c = -(m/2), t = reversed taps
//   dfilt, dfilt2          = (2, 4, 2): level2.dfilt_streams
//   ifilt                  = (4, 2, 2): ilevel2.ifilt_streams
//
// so the kernels hold no parity logic.  Each branch has its own tap counts
// and offsets, so filters of unequal length (near_sym_b's 13/19 taps, or
// qshift pairs of two lengths) need no zero padding, and even-length filters
// (r + 1 outputs) are just another stream.  x is read at symmetric
// reflection (reflect() in common.cuh, folded as often as needed, so a
// signal shorter than the filter works), or, in the from-extension mode, at
// side + index in a buffer the caller has already extended (the host adds
// side to every offset and checks that the reads stay inside).  The branch
// count is a template parameter: a one-branch instance holds, loads and
// multiplies one branch's taps only.
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
constexpr int STREAM_OUTPUTS = 4096;   // outputs per branch per block
constexpr int STREAM_MAX_TI = 64;
constexpr int TAP_STRIDE = MAX_TAPS + 1;  // shared tap rows: no bank clash

template <int NB, int P> struct StreamPlan {
  int len[NB][P];  // taps per stream
  int off[NB][P];  // first input row of stream s, relative to the tile
};

template <typename T, int NB, int P, int D, int S>
__global__ void __launch_bounds__(STREAM_THREADS)
    stream_kernel(const T* __restrict__ in0, T* __restrict__ out0,
                  T* __restrict__ out1, int n_in, int inner, int g0n,
                  int g1n, int refl, int TG, int lgTI, int XR, int cmin,
                  int n_gt, int n_ct,
                  const double* __restrict__ taps, StreamPlan<NB, P> plan) {
  static_assert(NB == 1 || NB == 2, "one or two branches");
  using A = typename AccOf<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* xs = reinterpret_cast<A*>(smem_raw);  // [XR][TI]
  __shared__ A tap_s[NB * P * TAP_STRIDE];
  __shared__ int len_s[NB][P], off_s[NB][P];

  const int TI = 1 << lgTI;
  const int tid = threadIdx.x;
  const int64_t blk = blockIdx.x;
  const int gt = static_cast<int>(blk % n_gt);
  const int ct = static_cast<int>((blk / n_gt) % n_ct);
  const int64_t o = blk / (static_cast<int64_t>(n_gt) * n_ct);
  const int gbase = gt * TG, cbase = ct * TI;

  for (int i = tid; i < NB * P * MAX_TAPS; i += STREAM_THREADS)
    tap_s[(i / MAX_TAPS) * TAP_STRIDE + i % MAX_TAPS] =
        static_cast<A>(taps[i]);
  if (tid == 0) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int s = 0; s < P; ++s) {
        len_s[b][s] = plan.len[b][s];
        off_s[b][s] = plan.off[b][s];
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

  const int gmax = (NB == 2 && g1n > g0n) ? g1n : g0n;
  const int64_t ob0 = o * static_cast<int64_t>(P) * g0n * inner + col;
  const int64_t ob1 = o * static_cast<int64_t>(P) * g1n * inner + col;
  for (int j = tr; j < P * TG; j += rows_per) {
    const int gl = j / P, s = j - gl * P;
    const int g = gbase + gl;
    if (!col_ok || g >= gmax) continue;
    A acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const A* xp = xs + static_cast<int64_t>(D * gl + off_s[b][s]) * TI + tc;
      const A* tp = tap_s + (b * P + s) * TAP_STRIDE;
      const int len = len_s[b][s];
      A a = 0;
      for (int k = 0; k < len; ++k) a += tp[k] * xp[k * S * TI];
      acc[b] = a;
    }
    const int64_t row = static_cast<int64_t>(P * g + s) * inner;
    if constexpr (NB == 2) {
      if (g < g0n) store(out0 + ob0 + row, acc[0]);
      if (g < g1n) store(out1 + ob1 + row, acc[1]);
    } else {
      store(out0 + ob0 + row, acc[0]);
    }
  }
}

template <typename T, int NB, int P, int D, int S>
cudaError_t run_streams(const void* in0, void* out0, void* out1, int outer,
                        int n_in, int inner, int g0n, int g1n, int refl,
                        const double* taps, const int* lens,
                        const int* offs, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  StreamPlan<NB, P> plan;
  int cmin = INT_MAX, cend = INT_MIN;
  for (int b = 0; b < NB; ++b)
    for (int s = 0; s < P; ++s) {
      const int len = lens[b * P + s], c = offs[b * P + s];
      if (len < 1 || len > MAX_TAPS) return cudaErrorInvalidValue;
      cmin = c < cmin ? c : cmin;
      cend = c + S * (len - 1) > cend ? c + S * (len - 1) : cend;
    }
  for (int b = 0; b < NB; ++b)
    for (int s = 0; s < P; ++s) {
      plan.len[b][s] = lens[b * P + s];
      plan.off[b][s] = offs[b * P + s] - cmin;
    }
  const int gmax = (NB == 2 && g1n > g0n) ? g1n : g0n;
  int lgTI = 0;
  while ((1 << lgTI) < inner && (1 << lgTI) < STREAM_MAX_TI) ++lgTI;
  const int TI = 1 << lgTI;
  int TG = STREAM_OUTPUTS / (P * TI);
  if (TG < 1) TG = 1;
  if (TG > gmax) TG = gmax;
  const int XR = D * (TG - 1) + (cend - cmin) + 1;
  const size_t smem = sizeof(A) * static_cast<size_t>(XR) * TI;
  const int n_gt = (gmax + TG - 1) / TG;
  const int n_ct = (inner + TI - 1) / TI;
  const int64_t blocks = static_cast<int64_t>(outer) * n_gt * n_ct;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = stream_kernel<T, NB, P, D, S>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<static_cast<unsigned>(blocks), STREAM_THREADS, smem, stream>>>(
      static_cast<const T*>(in0), static_cast<T*>(out0),
      static_cast<T*>(out1), n_in, inner, g0n, g1n, refl, TG, lgTI, XR,
      cmin, n_gt, n_ct, taps, plan);
  return cudaGetLastError();
}

template <int NB, int P, int D, int S>
int dispatch_streams(const void* in0, void* out0, void* out1, int outer,
                     int n_in, int inner, int g0n, int g1n, int refl,
                     const double* taps, const int* lens, const int* offs,
                     int dtype, void* stream) {
  if (outer < 1 || n_in < 1 || inner < 1 || g0n < 1 || (NB == 2 && g1n < 1))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return run_streams<float, NB, P, D, S>(
          in0, out0, out1, outer, n_in, inner, g0n, g1n, refl, taps,
          lens, offs, st);
    case DT_BF16:
      return run_streams<__nv_bfloat16, NB, P, D, S>(
          in0, out0, out1, outer, n_in, inner, g0n, g1n, refl, taps,
          lens, offs, st);
    case DT_F64:
      return run_streams<double, NB, P, D, S>(
          in0, out0, out1, outer, n_in, inner, g0n, g1n, refl, taps,
          lens, offs, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace dtcwt

// Common C interface of the stream kernels.  out1 is unused (null) and g1n
// ignored where the kernel has one branch.  taps: device float64 [NB
// branches][P streams][MAX_TAPS]; lens, offs: host [NB][P].  g0n / g1n:
// output groups of branch 0 / 1 (each writes P * g rows).  refl = 1: read
// x at reflected indices of a length-n_in axis; refl = 0: n_in is the
// length of a pre-extended buffer and offs already include its side.
#define DTCWT_STREAM_EXPORT(name, NB, P, D, S)                               \
  extern "C" int name(const void* in0, void* out0, void* out1, int outer,   \
                      int n_in, int inner, int g0n, int g1n, int refl,      \
                      const double* taps, const int* lens, const int* offs, \
                      int dtype, void* stream) {                            \
    return dtcwt::dispatch_streams<NB, P, D, S>(                            \
        in0, out0, out1, outer, n_in, inner, g0n, g1n, refl, taps, lens,    \
        offs, dtype, stream);                                               \
  }
