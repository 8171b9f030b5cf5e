// Two of the three single-stream filter kernels, along any axis of a
// contiguous tensor (CUDA C++, sm_90a):
//
//   dfilt    dual-tree decimate-by-2, the ha / hb polyphase branches
//            interleaved by the sign of sum(ha * hb): r -> r / 2, r % 4 == 0
//   ifilt    dual-tree interpolate-by-2, four output streams: r -> 2 r
//
// Replace the Pallas kernels of dtcwt_tpu/ops/pallas_fb.py (builders
// _build_dfilt, _build_ifilt; entries dfilt_axis, ifilt_axis and their
// *_fromext_axis forms).  The TPU kernels' banded MXU operators, sublane
// transposes and 128-lane envelope are not carried over: on the H100 these
// are direct FIRs on the host's stream plans.  The third, the
// non-decimating filter (_build_filter), has a kernel of its own in
// filter.cu.
//
// Each is the one-branch instance of a dual kernel's design: dfilt that of
// dual.cu's dfilt2 (streamana.cuh, NB = 1), ifilt that of its ifilt2_sum
// (streamsum.cuh, NIN = 1), on the pieces of streamtile.cuh and taps.cuh:
// taps by value under a compile-time bound, columns or staged rows, every
// output written once, the tiling chosen by ops/dual.py _stream_geometry.
// Their bound is device memory bytes, each input read once and each output
// written once.  dual.cu includes the same headers, and both objects link
// into one library: what the headers define is a template or inline.
#include "streamana.cuh"
#include "streamsum.cuh"

//                name         P
DTCWT_ANA1_EXPORT(dtcwt_dfilt, 2)
DTCWT_SUM1_EXPORT(dtcwt_ifilt, 4)
