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
// One design run both ways (filter.cu's, on the pieces of streamtile.cuh:
// taps by value under a compile-time bound, columns or staged rows, every
// output written once), its tiling chosen by ops/dual.py _stream_geometry.
// The analysis entries are streamana.cuh's (the input read once for both
// branches, both branches' outputs from one window), the synthesis sums
// streamsum.cuh's (the sum of the two branches in registers).
#include "streamana.cuh"
#include "streamsum.cuh"

//               name           P
DTCWT_ANA_EXPORT(dtcwt_filter2, 1)
DTCWT_ANA_EXPORT(dtcwt_dfilt2,  2)

//               name               P
DTCWT_SUM_EXPORT(dtcwt_filter2_sum, 1)
DTCWT_SUM_EXPORT(dtcwt_ifilt2_sum,  4)
