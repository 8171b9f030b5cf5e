"""Level-1 inverse of the 2-D DTCWT: one CUDA kernel and its plain version.

Replaces the Pallas kernel ``dtcwt_tpu/ops/pallas_ilevel1.py:inv_level1``.
What bounds it on the H100, and what the design does about it, is in the
kernel's source, ``csrc/ilevel1.cu``: a memory-bound stencil that builds
the quad images on chip and writes its output once.

:func:`inv_level1` takes its route from the input's device: a CPU tensor
runs :func:`inv_level1_reference`, a CUDA tensor launches the kernel or
raises.  The subbands come as in :func:`ilevel2.inv_level2`.  The bandpass
families' third filter *g2o* is the kernel's third stream: the ``hh`` quad
image gets ``g2o`` on both axes instead of sharing the second column stage;
like ``g0o`` and ``g1o`` it must have an odd length of at most 32 taps, and
the largest of the three half-lengths sets the tile's halo.
"""

from __future__ import annotations

import torch

from dtcwt_tpu_torch.ops import _build, fb
from dtcwt_tpu_torch.ops.ilevel2 import _band_args, _quads
from dtcwt_tpu_torch.utils import compute_view

__all__ = ["inv_level1", "inv_level1_reference"]


def inv_level1_reference(z: torch.Tensor, yh=None, g0o=None, g1o=None,
                         bands=None, g2o=None):
    """Plain PyTorch level-1 inverse: lowpass ``[..., H, W]`` plus the
    level-1 subbands -> the image ``[..., H, W]`` in the lowpass's dtype.
    *g2o* is the bandpass families' third synthesis filter."""
    lh, hl, hh = _quads(yh, bands)
    y1 = fb.filter2_sum_axis(compute_view(z), lh, g0o, g1o, -2)
    if g2o is not None:
        y2 = fb.filter_axis(hl, g0o, -2)
        y2bp = fb.filter_axis(hh, g2o, -2)
        out = (fb.filter2_sum_axis(y1, y2, g0o, g1o, -1)
               + fb.filter_axis(y2bp, g2o, -1))
    else:
        y2 = fb.filter2_sum_axis(hl, hh, g0o, g1o, -2)
        out = fb.filter2_sum_axis(y1, y2, g0o, g1o, -1)
    return out.to(z.dtype)


def inv_level1(z: torch.Tensor, yh=None, g0o=None, g1o=None, bands=None,
               g2o=None):
    """Level-1 inverse; see :func:`inv_level1_reference`."""
    if z.device.type == "cpu":
        return inv_level1_reference(z, yh, g0o, g1o, bands, g2o)
    if z.device.type != "cuda":
        raise ValueError("inv_level1 runs on CPU or CUDA tensors, not %s"
                         % z.device)
    filt = _build.odd_filters("inv_level1", g0o, g1o, g2o)
    if z.ndim < 2 or z.shape[-2] % 2 or z.shape[-1] % 2:
        raise ValueError("inv_level1 needs [..., H, W] with H, W even, got "
                         "%s" % (tuple(z.shape),))
    if not z.is_contiguous():
        raise ValueError("inv_level1 needs a contiguous lowpass")
    code = _build.dtype_code(z.dtype)
    band_a, band_b, planes = _band_args(z, yh, bands, "inv_level1")
    n = [f.size for f in filt if f is not None]
    _build.check_smem("inv_level1", z.dtype, (2 * _build.QY, 2 * _build.QX),
                      max(n) // 2, 4, len(n), 2 * _build.QY)
    z3, lead = _build.flatten_batch(z)
    B, H, W = z3.shape
    out = torch.empty_like(z3)
    taps, _tables = _build.fir_args(filt)
    lib = _build.library()
    err = lib.dtcwt_ilevel1(
        z3.data_ptr(), band_a.data_ptr(),
        None if band_b is None else band_b.data_ptr(), out.data_ptr(),
        B, H, W, *taps, code, planes, _build.stream_ptr(z.device))
    _build.check("inv_level1", err)
    _build.count("ilevel1")
    return out.reshape(lead + out.shape[1:])
