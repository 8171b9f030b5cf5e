"""One qshift (level >= 2) forward level of the 2-D DTCWT: one CUDA kernel
and its plain version.

Replaces the Pallas kernel ``dtcwt_tpu/ops/pallas_level2.py:fwd_level2``.
What bounds it on the H100, and what the design does about it, is in the
kernel's source, ``csrc/level2.cu``: a memory-bound stencil that reads its
input once per tile and keeps every intermediate image on chip.

:func:`fwd_level2` takes its route from the input's device: a CPU tensor
runs :func:`fwd_level2_reference`, a CUDA tensor launches the kernel or
raises.  Filter arguments follow the transform's call order: the level
applies ``dfilt(x, h0b, h0a)`` and ``dfilt(x, h1b, h1a)``, so branch *a* of
the decimator runs the *b* filter.  The bandpass families' third pair
*h2a*/*h2b* is the kernel's third stream (bands 1 and 4 from
``dfilt(., h2b, h2a)`` on both axes), planned on the host as the main pairs
are; all six filters must share one even length of at most 32 taps, which
sets the tile's halo.
"""

from __future__ import annotations

import numpy as np
import torch

from dtcwt_tpu_torch.ops import _build, fb
from dtcwt_tpu_torch.ops.level1 import _pack
from dtcwt_tpu_torch.utils import compute_view

__all__ = ["fwd_level2", "fwd_level2_reference", "dfilt_streams"]


def dfilt_streams(ha, hb):
    """The decimator ``dfilt(x, ha, hb)`` as two output streams
    ``Y[2i + s] = sum_k taps[s][k] x[4i + offs[s] + 2k]`` (``x`` indexed
    with symmetric reflection), from the closed form in :mod:`fb`: branch a
    reads ``ext[4i + 2 + 2k]``, branch b ``ext[4i + 3 + 2k]`` with reversed
    taps, and the sign of ``sum(ha*hb)`` says which comes first."""
    ha = np.asarray(ha, np.float64).reshape(-1)
    hb = np.asarray(hb, np.float64).reshape(-1)
    m = ha.size
    a, b = (ha[::-1], 2 - m), (hb[::-1], 3 - m)
    first, second = (a, b) if float(np.sum(ha * hb)) > 0 else (b, a)
    return (np.stack([first[0], second[0]]), (first[1], second[1]))


def fwd_level2_reference(x: torch.Tensor, h0a, h0b, h1a, h1b,
                         planes: bool = False, h2a=None, h2b=None):
    """Plain PyTorch qshift forward level of ``[..., R, C]`` (R, C multiples
    of 4): ``(lolo [..., R/2, C/2], subbands)``, the subbands complex
    ``[..., R/4, C/4, 6]`` or ``(re, im)`` planes ``[..., 6, R/4, C/4]``.
    *h2a*/*h2b* are the bandpass families' third filter pair."""
    X = compute_view(x)
    lo = fb.dfilt_axis(X, h0b, h0a, -2)
    hi = fb.dfilt_axis(X, h1b, h1a, -2)
    lolo = fb.dfilt_axis(lo, h0b, h0a, -1)
    im23 = fb.dfilt_axis(lo, h1b, h1a, -1)
    im05 = fb.dfilt_axis(hi, h0b, h0a, -1)
    if h2b is not None:
        im14 = fb.dfilt_axis(fb.dfilt_axis(X, h2b, h2a, -2), h2b, h2a, -1)
    else:
        im14 = fb.dfilt_axis(hi, h1b, h1a, -1)
    return lolo.to(x.dtype), _pack(im05, im23, im14, planes, x.dtype)


def fwd_level2(x: torch.Tensor, h0a, h0b, h1a, h1b, planes: bool = False,
               h2a=None, h2b=None):
    """Qshift forward level; see :func:`fwd_level2_reference`."""
    if x.device.type == "cpu":
        return fwd_level2_reference(x, h0a, h0b, h1a, h1b, planes, h2a, h2b)
    if x.device.type != "cuda":
        raise ValueError("fwd_level2 runs on CPU or CUDA tensors, not %s"
                         % x.device)
    _build.check_no_grad("fwd_level2", x)
    if (h2a is None) != (h2b is None):
        raise ValueError("fwd_level2 takes the third pair h2a, h2b together")
    if x.ndim < 2 or x.shape[-2] % 4 or x.shape[-1] % 4:
        raise ValueError("fwd_level2 needs [..., R, C] with R, C multiples "
                         "of 4, got %s" % (tuple(x.shape),))
    f = _build.pair_filters("fwd_level2", h0b, h0a, h1b, h1a, h2b, h2a)
    t0, o0 = dfilt_streams(f[0], f[1])
    t1, o1 = dfilt_streams(f[2], f[3])
    t2, o2 = (None, None) if h2a is None else dfilt_streams(f[4], f[5])
    if not x.is_contiguous():
        raise ValueError("fwd_level2 needs a contiguous input")
    code = _build.dtype_code(x.dtype)
    if code == 1 and not planes:
        raise TypeError("bfloat16 subbands exist only in the plane layout")
    m = t0.shape[1]
    _build.check_smem("fwd_level2", x.dtype, (4 * _build.QY, 4 * _build.QX),
                      m, 1, 2 if t2 is None else 3, 2 * _build.QY)
    x3, lead = _build.flatten_batch(x)
    B, R, C = x3.shape
    lolo = torch.empty((B, R // 2, C // 2), dtype=x.dtype, device=x.device)
    h, w = R // 4, C // 4
    if planes:
        re = torch.empty((B, 6, h, w), dtype=x.dtype, device=x.device)
        im = torch.empty_like(re)
        out_a, out_b = re, im
    else:
        ctype = torch.complex64 if x.dtype == torch.float32 else \
            torch.complex128
        z = torch.empty((B, h, w, 6), dtype=ctype, device=x.device)
        out_a, out_b = torch.view_as_real(z), None
    taps = _build.taps_arg(t0, t1)
    offs = _build.ints_arg(o0 + o1)
    taps2 = None if t2 is None else _build.taps_arg(t2)
    offs2 = None if t2 is None else _build.ints_arg(o2)
    lib = _build.library()
    err = lib.dtcwt_level2(
        x3.data_ptr(), lolo.data_ptr(), out_a.data_ptr(),
        None if out_b is None else out_b.data_ptr(), B, R, C,
        taps.ctypes.data, offs.ctypes.data, _build.ptr(taps2),
        _build.ptr(offs2), m, code, int(planes), _build.stream_ptr(x.device))
    _build.check("fwd_level2", err)
    _build.count("level2")
    lolo = lolo.reshape(lead + lolo.shape[1:])
    if planes:
        return lolo, (re.reshape(lead + re.shape[1:]),
                      im.reshape(lead + im.shape[1:]))
    return lolo, z.reshape(lead + z.shape[1:])
