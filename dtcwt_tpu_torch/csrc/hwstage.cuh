// The (H, W) stage pair of the 3-D analysis kernel fwd_pack_kernel of
// pack3d.cu (CUDA C++, sm_90a), and the constants and helpers the other
// 3-D kernels take from it: PACK_THREADS, PACK_SMEM_MAX, cp_async_value and
// the host plans' layout (pack3d.cu's synthesis in ipack.cuh; hw.cu's
// kernels in hwana.cuh and hwsum.cuh, on hwtile.cuh).
//
// Both branch filters of one axis stage are P output streams each (host
// plans: dual._filter_plan, level2.dfilt_streams, ilevel2.ifilt_streams),
//
//   Y[P g + s] = sum_{k < len[b][s]} t[b][s][k] x[D g + c[b][s] + S k]
//
//   level-1 filter (P, D, S) = (1, 1, 1), c = -(m/2), t = reversed taps
//   level-2 dfilt            = (2, 4, 2)
//   level-2 ifilt            = (4, 2, 2)
//
// applied along W and along H, so the kernel holds no parity logic.  A
// block of fwd_pack_kernel owns one OH x OW output tile of a depth slice:
// it stages the input tile plus its reflected halo (XR x XC) in dynamic
// shared memory, runs the W stage into shared memory (XR x OW per image,
// fir() over the plan staged by stage_plan) and the H stage in registers.
// Its tile comes from the host (ops/pack3d.py _fwd_pack_geometry, pack3d.cu
// FwdTile): the largest that fits.
#pragma once

#include <climits>

#include "common.cuh"

namespace dtcwt {

constexpr int PACK_THREADS = 256;
constexpr int PACK_TILE = 32;                   // largest output tile side
constexpr size_t PACK_SMEM_MAX = 220 * 1024;    // dynamic shared memory cap

// One value from device memory into shared memory, asynchronously
// (cp.async; the caller waits for it).
template <typename A>
__device__ __forceinline__ void cp_async_value(A* smem, const A* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(sizeof(A))
               : "memory");
}

// The two branch filters of one axis stage as P streams each.
template <typename A, int P> struct PackPlan {
  int len[2][P];
  int off[2][P];  // first input sample of stream s, relative to cmin
  A t[2][P][MAX_TAPS];
};

template <typename A, int P>
__device__ __forceinline__ void stage_plan(const PackPlan<A, P>& plan,
                                           PackPlan<A, P>* sp) {
  const int tid = threadIdx.x;
  const int n_t = 2 * P * MAX_TAPS;
  for (int i = tid; i < n_t; i += PACK_THREADS)
    (&sp->t[0][0][0])[i] = (&plan.t[0][0][0])[i];
  if (tid < 2 * P) {
    (&sp->len[0][0])[tid] = (&plan.len[0][0])[tid];
    (&sp->off[0][0])[tid] = (&plan.off[0][0])[tid];
  }
}

// Stream sum at output o (local) of filter b over a shared image whose rows
// (or columns) are `step` apart: sum_k t[b][s][k] img[(D g + off + S k) step].
template <typename A, int P, int D, int S>
__device__ __forceinline__ A fir(const PackPlan<A, P>& p, int b, int o,
                                    const A* img, int step) {
  const int g = o / P, s = o - g * P;
  const A* x = img + static_cast<int64_t>(D * g + p.off[b][s]) * step;
  const A* t = p.t[b][s];
  const int len = p.len[b][s];
  A acc = 0;
  for (int k = 0; k < len; ++k) acc += t[k] * x[S * k * step];
  return acc;
}

// taps: host [2][P][MAX_TAPS]; lens, offs: host [2][P].  Fills *plan and
// the offsets' span; false if a stream is empty or too long.
template <typename A, int P, int S>
bool make_pack_plan(PackPlan<A, P>* plan, const double* taps,
                    const int* lens, const int* offs, int* cmin, int* span) {
  int lo = INT_MAX, hi = INT_MIN;
  for (int b = 0; b < 2; ++b)
    for (int s = 0; s < P; ++s) {
      const int len = lens[b * P + s], c = offs[b * P + s];
      if (len < 1 || len > MAX_TAPS) return false;
      lo = c < lo ? c : lo;
      hi = c + S * (len - 1) > hi ? c + S * (len - 1) : hi;
    }
  for (int b = 0; b < 2; ++b)
    for (int s = 0; s < P; ++s) {
      plan->len[b][s] = lens[b * P + s];
      plan->off[b][s] = offs[b * P + s] - lo;
      for (int k = 0; k < MAX_TAPS; ++k)
        plan->t[b][s][k] = static_cast<A>(taps[(b * P + s) * MAX_TAPS + k]);
    }
  *cmin = lo;
  *span = hi - lo + 1;
  return true;
}

}  // namespace dtcwt
