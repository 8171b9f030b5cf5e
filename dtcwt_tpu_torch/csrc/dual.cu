// The four dual-stream filter kernels of one separable tree stage, along any
// axis of a contiguous tensor (CUDA C++, sm_90a):
//
//   filter2      one input  -> both non-decimating branch outputs
//   dfilt2       one input  -> both decimate-by-2 branch outputs
//   filter2_sum  two inputs -> filter(a, h0) + filter(b, h1)
//   ifilt2_sum   two inputs -> ifilt(a, p0) + ifilt(b, p1)
//
// Replace the Pallas kernels of dtcwt_tpu/ops/pallas_dual.py (builders
// _build_filter2, _build_dfilt2, _build_filter2_sum, _build_ifilt2_sum,
// entries filter2_axis, dfilt2_axis, filter2_sum_axis, ifilt2_sum_axis and
// their *_fromext_axis forms).  Each takes the reflect and the
// from-extension modes; its bound is device memory bytes.
//
// The analysis kernels are the two-branch instances of the stream-plan
// kernel in streams.cuh (stream plans, [outer, n, inner] tiling; the input
// read once for both branches).  The synthesis sums are streamsum.cuh's
// (filter.cu's design, on the pieces of streamtile.cuh: taps by value
// under a compile-time bound, columns or staged rows, the sum of the two
// branches in registers), their tiling chosen by ops/dual.py _sum_geometry.
#include "streams.cuh"
#include "streamsum.cuh"

//                  name           NB P  D  S
DTCWT_STREAM_EXPORT(dtcwt_filter2, 2, 1, 1, 1)
DTCWT_STREAM_EXPORT(dtcwt_dfilt2,  2, 2, 4, 2)

//               name               P
DTCWT_SUM_EXPORT(dtcwt_filter2_sum, 1)
DTCWT_SUM_EXPORT(dtcwt_ifilt2_sum,  4)
