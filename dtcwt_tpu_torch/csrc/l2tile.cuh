// Shared pieces of the 2-D qshift (level >= 2) kernels, the forward
// (level2.cu) and the inverse (ilevel2.cu), CUDA C++, sm_90a.
//
// A qshift level works on the dual-tree decimator's two branches: branch a
// reads x[4i + 2 - m + 2k], branch b x[4i + 3 - m + 2k] (m even taps), and
// the filter pair's sign says which branch gives output 2i and which 2i +
// 1.  On an image staged from column c0 + 2 - m, branch a of output column
// j reads the staged columns 4 j + 2k (even), branch b 4 j + 1 + 2k (odd),
// so a column image is kept in shared memory split by column parity: each
// row holds its even columns, then its odd ones, each half l2_xh(m) wide.
// A window of one parity is then contiguous, lanes 16 bytes apart read it
// as 16-byte vectors (vec_window, l1tile.cuh), and the column stage's
// lanes, on consecutive staged columns, write the two halves in disjoint
// banks (l2_half; the inverse splits its column images the same way, for
// its row stage's windows).  The taps travel by
// value in the kernel's parameters, zero past m, and every tap loop runs
// to a compile-time bound MT >= m with no guard: the samples past a
// window's m taps are finite (written cells, or zeros past the loads).
#pragma once

#include "l1tile.cuh"

namespace dtcwt {

constexpr int L2_THREADS = 256;
constexpr int L2_TQ = 64;           // quads a tile row: 32 lanes x 2
constexpr int L2_TW = 4 * L2_TQ;    // input columns a tile row

// The decimating pairs' taps by branch, zero past m: t[pair][0] branch a,
// t[pair][1] branch b; swap[pair] = 1 where branch b gives output 2i.
template <typename A> struct L2Taps {
  A t[3][2][MAX_TAPS];
  int swap[3];
};

// Pair pi's taps [stream][m] and offsets [stream] (stream s gives output
// 2i + s and reads x[4i + offs[s] + 2k]) into branch form.  False where m
// is odd, out of range, or the offsets are not one of each branch.
template <typename A>
inline bool set_l2pair(L2Taps<A>* tp, int pi, const double* taps,
                       const int* offs, int m) {
  if (m < 2 || m > MAX_TAPS || m % 2) return false;
  const int sw = offs[0] != 2 - m;
  if (offs[sw] != 2 - m || offs[1 - sw] != 3 - m) return false;
  tp->swap[pi] = sw;
  for (int br = 0; br < 2; ++br)
    for (int k = 0; k < MAX_TAPS; ++k)
      tp->t[pi][br][k] =
          k < m ? static_cast<A>(taps[(br ^ sw) * m + k]) : A(0);
  return true;
}

// The tap bound the host chooses for m taps: 10 (qshift_a, the main
// path's family), 14 (qshift_b and the bandpass qshift_b_bp), 16, 24 or
// 32; with the third stream 14, 16 or 32; float64 (for tests) 32 only.
template <typename A, bool BP> constexpr int l2_tap_bound(int m) {
  return sizeof(A) == 8     ? 32
         : m <= 10 && !BP   ? 10
         : m <= 14          ? 14
         : m <= 16          ? 16
         : BP || m > 24     ? 32
                            : 24;
}

// Width of a column image's parity half that holds n values: at least n,
// and 16 (mod 32) so that the two halves of a row sit in disjoint banks
// for lanes on consecutive staged columns.
__host__ __device__ constexpr int l2_half(int n) {
  return (n + 15) / 32 * 32 + 16;
}

// The forward's half of a staged row of L2_TW + 2m columns: it holds the
// half's 128 + m values, which take in the last lane's 16-byte window (124
// + round4(m + 2) values).
__host__ __device__ constexpr int l2_xh(int m) { return l2_half(128 + m); }

}  // namespace dtcwt
