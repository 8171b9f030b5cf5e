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
// their *_fromext_axis forms).
//
// Each is the two-branch instance of the stream-plan kernel in streams.cuh,
// which holds the design (stream plans, [outer, n, inner] tiling, reflect
// and from-extension modes) and its bound: device memory bytes.  The input
// is read once for both branches, and a sum of branches is kept in
// registers.
#include "streams.cuh"

//                  name               NB NI NO P  D  S
DTCWT_STREAM_EXPORT(dtcwt_filter2,     2, 1, 2, 1, 1, 1)
DTCWT_STREAM_EXPORT(dtcwt_dfilt2,      2, 1, 2, 2, 4, 2)
DTCWT_STREAM_EXPORT(dtcwt_filter2_sum, 2, 2, 1, 1, 1, 1)
DTCWT_STREAM_EXPORT(dtcwt_ifilt2_sum,  2, 2, 1, 4, 2, 2)
