// The (H, W) stage pair of a 3-D level, shared by the analysis kernels of
// pack3d.cu (fwd_pack_kernel) and of hw.cu (hw22_kernel) (CUDA C++,
// sm_90a).  The synthesis kernels have designs of their own: pack3d.cu's in
// ipack.cuh, hw.cu's in hwsum.cuh; they take PACK_THREADS, PACK_SMEM_MAX,
// cp_async_value and the host plans' layout from here.
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
// applied along W and along H, so the kernels hold no parity logic.  A block
// owns one OH x OW output tile of a depth slice: it stages the input tile
// plus its reflected halo (XR x XC) in dynamic shared memory, runs the W
// stage into shared memory (XR x OW per image) and the H stage in
// registers.  The tile is the largest that fits: pick_tile for hw.cu's
// analysis kernel; the analysis kernels of pack3d.cu take theirs from the
// host, which applies the same rule to their own shared-memory layout
// (pack3d.cu FwdTile).
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

// The largest output tile (OH x OW, each a power of two <= PACK_TILE and a
// multiple of `mult`) whose shared memory fits: n_x staged images of
// XR x XC and n_v W-stage images of XR x OW.
template <typename A, int P, int D>
bool pick_tile(int span, int n_x, int n_v, int mult, int* OH, int* OW,
               int* XR, int* XC, size_t* smem) {
  int oh = PACK_TILE, ow = PACK_TILE;
  for (;;) {
    const int xr = D * (oh / P - 1) + span, xc = D * (ow / P - 1) + span;
    const size_t bytes = sizeof(A) * (static_cast<size_t>(n_x) * xr * xc +
                                      static_cast<size_t>(n_v) * xr * ow);
    if (bytes <= PACK_SMEM_MAX) {
      *OH = oh;
      *OW = ow;
      *XR = xr;
      *XC = xc;
      *smem = bytes;
      return true;
    }
    if (oh >= ow && oh > mult) {
      oh /= 2;
    } else if (ow > mult) {
      ow /= 2;
    } else {
      return false;
    }
  }
}

}  // namespace dtcwt
