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
// are direct FIRs on the stream plans.  The third, the non-decimating
// filter (_build_filter), has a kernel of its own in filter.cu.
//
// Each is an instance of the stream-plan kernel in streams.cuh, which
// holds the design (stream plans, [outer, n, inner] tiling, reflect and
// from-extension modes) and its bound: device memory bytes, each input
// read once and each output written once.
#include "streams.cuh"

//                  name         P  D  S
DTCWT_STREAM_EXPORT(dtcwt_dfilt, 2, 4, 2)
DTCWT_STREAM_EXPORT(dtcwt_ifilt, 4, 2, 2)
