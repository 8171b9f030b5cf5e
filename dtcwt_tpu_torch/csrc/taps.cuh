// Taps by value under a compile-time bound, for the kernels whose branch
// filters run as host stream plans (CUDA C++, sm_90a): the hw kernels of
// hw.cu (hwtile.cuh) and the 1-D stream kernels of dual.cu and single.cu
// (streamtile.cuh: the analysis entries of streamana.cuh, the sums of
// streamsum.cuh, each with two branches or, single.cu's dfilt and ifilt,
// one).
//
// A branch's filter is P output streams (host plans: dual._filter_plan,
// level2.dfilt_streams, ilevel2.ifilt_streams),
//
//   Y[P g + s] = sum_{k < len[s]} t[s][k] x[D g + off[s] + S k],
//
// and here its taps are placed on a window of MT samples (filter) or MT
// sample pairs from an even sample (the qshift streams, S = 2) centred on
// the common halo ph = (MT - 1) / 2, zero outside a stream's own reach: a
// group's window starts at sample D g - S ph (filter g - ph, dfilt 4 g - 2
// ph, ifilt 2 g - 2 ph), and every tap loop runs to MT with register
// indices and no guard.
#pragma once

#include "common.cuh"

namespace dtcwt {

constexpr int HS_K = 33;     // the largest tap bound

// The NB branch filters' taps by value (two, or one for single.cu's
// entries): t[b][s][m] multiplies the window sample m of stream s of
// branch b (ifilt: of the parity (s & 1) ^ sw[b]; dfilt: of the parity s,
// the host having swapped the streams where sw[b]).
template <typename A, int P, int NB = 2> struct HsTaps {
  A t[NB][P][HS_K];
  int sw[NB];
};

// The tap bounds of an instance set, 5 of each: P = 1 (filter, both
// directions) 5, 7, 9, 19, 31; P = 2 (dfilt) 10, 14, 16, 18, 32; P = 4
// (ifilt) 5, 7, 9, 17, 33.
constexpr int HS_BOUNDS = 5;
template <int P> constexpr int hs_bound(int e) {
  constexpr int b1[HS_BOUNDS] = {5, 7, 9, 19, 31};
  constexpr int b2[HS_BOUNDS] = {10, 14, 16, 18, 32};
  constexpr int b4[HS_BOUNDS] = {5, 7, 9, 17, HS_K};
  return P == 1 ? b1[e] : P == 2 ? b2[e] : b4[e];
}

// The tap bounds of the 1-D stream kernels (streamana.cuh,
// streamsum.cuh): dfilt's and ifilt's are hs_bound<2> and hs_bound<4>;
// filter's are hs_bound<1> with the largest raised to HS_K, whose halo of
// 16 holds a filter of 32 taps of either parity (an even filter of m taps
// starts m / 2 samples before its output).
template <int P> constexpr int st_bound(int e) {
  return P == 1 && e == HS_BOUNDS - 1 ? HS_K : hs_bound<P>(e);
}

// Fill *tp from the host plan (taps [NB][P][MAX_TAPS], lens and offs
// [NB][P]: stream s of branch b reads x[D g + offs + S k], k < lens)
// centred on the halo of bound mt; false where a stream does not fit in it.
template <typename A, int P, int NB>
bool make_hs_taps(HsTaps<A, P, NB>* tp, const double* taps, const int* lens,
                  const int* offs, int mt) {
  if (mt > HS_K) return false;
  const int ph = (mt - 1) / 2;
  for (int b = 0; b < NB; ++b) {
    // qshift: the parity of stream 0's first sample sets the swap
    const int sw = P == 1 ? 0 : (offs[b * P] + 2 * ph) & 1;
    tp->sw[b] = sw;
    for (int s = 0; s < P; ++s) {
      const int len = lens[b * P + s];
      // the stream's first tap's window index: filter ph + off; qshift the
      // half-index shift d / 2 of d = off + 2 ph
      const int d = P == 1 ? ph + offs[b * P + s] : offs[b * P + s] + 2 * ph;
      const int sh = P == 1 ? d : d >> 1;
      if (len < 1 || len > MAX_TAPS || d < 0 || sh + len > mt ||
          (P > 1 && (d & 1) != ((s & 1) ^ sw)))
        return false;
      for (int k = 0; k < HS_K; ++k) {
        const int kk = k - sh;
        tp->t[b][s][k] =
            kk >= 0 && kk < len
                ? static_cast<A>(taps[(b * P + s) * MAX_TAPS + kk])
                : A(0);
      }
    }
  }
  return true;
}

// dfilt's taps by parity: stream s reads the parity s ^ sw, so a branch
// whose first stream reads the odd samples has its two streams swapped.
template <typename A, int P, int NB>
void hs_taps_by_parity(HsTaps<A, P, NB>* tp) {
  if constexpr (P == 2) {
    for (int b = 0; b < NB; ++b)
      if (tp->sw[b])
        for (int k = 0; k < HS_K; ++k) {
          const A t = tp->t[b][0][k];
          tp->t[b][0][k] = tp->t[b][1][k];
          tp->t[b][1][k] = t;
        }
  }
}

}  // namespace dtcwt
