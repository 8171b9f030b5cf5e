"""One qshift (level >= 2) inverse level of the 2-D DTCWT: one CUDA kernel
and its plain version.

Replaces the Pallas kernel ``dtcwt_tpu/ops/pallas_ilevel2.py:inv_level2``.
What bounds it on the H100, and what the design does about it, is in the
kernel's source, ``csrc/ilevel2.cu``: a memory-bound stencil that builds
the quad images on chip and writes its output once.

:func:`inv_level2` takes its route from the input's device: a CPU tensor
runs :func:`inv_level2_reference`, a CUDA tensor launches the kernel or
raises.  The subbands come either as the interleaved complex
``[..., H/2, W/2, 6]`` tensor or as the plane pair ``(re, im)`` of
``[..., 6, H/2, W/2]`` tensors in PLANE_BAND_ORDER.  Filter arguments follow
the transform's call order ``ifilt(x, g0b, g0a)`` / ``ifilt(x, g1b, g1a)``.
The bandpass families' third pair *g2a*/*g2b* is the kernel's third stream:
the ``hh`` quad image gets ``ifilt(., g2b, g2a)`` on both axes instead of
sharing the second column stage, planned on the host as the main pairs
are; all six filters must share one even length of at most 32 taps, which
sets the tile's halo.  The output is uncropped: the transform crops.
"""

from __future__ import annotations

import numpy as np
import torch

from dtcwt_tpu_torch.ops import _build, fb
from dtcwt_tpu_torch.ops.packing import c2q, c2q_planes
from dtcwt_tpu_torch.transforms.pyramid import _PLANE_POS
from dtcwt_tpu_torch.utils import compute_view

__all__ = ["inv_level2", "inv_level2_reference", "ifilt_streams"]


def ifilt_streams(ha, hb):
    """The interpolator ``ifilt(x, ha, hb)`` as four output streams
    ``Y[4i + s] = sum_k taps[s][k] x[2i + offs[s] + 2k]`` (``x`` indexed
    with symmetric reflection), from the four parity cases of
    :func:`fb.ifilt_from_ext`: a stream reads the ``ev`` (extended index
    ``m2 % 2 + 2n``) or ``od`` phase at offset 0 or 1, with the reversed
    even- or odd-index taps of *ha* or *hb*."""
    ha = np.asarray(ha, np.float64).reshape(-1)
    hb = np.asarray(hb, np.float64).reshape(-1)
    m2 = ha.size // 2
    ev, od = m2 % 2, (m2 + 1) % 2
    e = lambda h: h[0::2][::-1]
    o = lambda h: h[1::2][::-1]
    pos = float(np.sum(ha * hb)) > 0
    if m2 % 2 == 0:
        if pos:
            plan = ((ev, o(ha), 0), (od, o(hb), 0), (ev, e(ha), 1),
                    (od, e(hb), 1))
        else:
            plan = ((od, o(ha), 0), (ev, o(hb), 0), (od, e(ha), 1),
                    (ev, e(hb), 1))
    elif pos:
        plan = ((ev, e(ha), 0), (od, e(hb), 1), (ev, o(ha), 0),
                (od, o(hb), 1))
    else:
        plan = ((od, e(ha), 1), (ev, e(hb), 0), (od, o(ha), 1),
                (ev, o(hb), 0))
    taps = np.stack([t for _, t, _ in plan])
    offs = tuple(int(ph + 2 * off - m2) for ph, _, off in plan)
    return taps, offs


def _quads(yh=None, bands=None):
    """The three c2q quad images (lh, hl, hh) of one level, at the compute
    precision: band pairs (0, 5), (2, 3), (1, 4)."""
    if bands is not None:
        re, im = (compute_view(a) for a in bands)
        bp = lambda d: (re[..., _PLANE_POS[d], :, :],
                        im[..., _PLANE_POS[d], :, :])
        return (c2q_planes(bp(0), bp(5)), c2q_planes(bp(2), bp(3)),
                c2q_planes(bp(1), bp(4)))
    return (c2q(yh[..., 0], yh[..., 5]), c2q(yh[..., 2], yh[..., 3]),
            c2q(yh[..., 1], yh[..., 4]))


def inv_level2_reference(z: torch.Tensor, yh=None, g0a=None, g0b=None,
                         g1a=None, g1b=None, bands=None, g2a=None, g2b=None):
    """Plain PyTorch qshift inverse level: lowpass ``[..., H, W]`` plus the
    level's subbands -> ``[..., 2H, 2W]`` in the lowpass's dtype.
    *g2a*/*g2b* are the bandpass families' third synthesis pair."""
    lh, hl, hh = _quads(yh, bands)
    p0, p1 = (g0b, g0a), (g1b, g1a)
    y1 = fb.ifilt2_sum_axis(compute_view(z), lh, p0, p1, -2)
    if g2b is not None:
        y2 = fb.ifilt_axis(hl, g0b, g0a, -2)
        y2bp = fb.ifilt_axis(hh, g2b, g2a, -2)
        out = (fb.ifilt2_sum_axis(y1, y2, p0, p1, -1)
               + fb.ifilt_axis(y2bp, g2b, g2a, -1))
    else:
        y2 = fb.ifilt2_sum_axis(hl, hh, p0, p1, -2)
        out = fb.ifilt2_sum_axis(y1, y2, p0, p1, -1)
    return out.to(z.dtype)


def _band_args(z: torch.Tensor, yh, bands, name: str):
    """Check the subbands against the lowpass; return the kernel's two band
    pointers' tensors and the planes flag."""
    H, W = z.shape[-2:]
    if bands is not None:
        re, im = bands
        want = tuple(z.shape[:-2]) + (6, H // 2, W // 2)
        for a in (re, im):
            if tuple(a.shape) != want or a.dtype != z.dtype:
                raise ValueError("%s: band planes must be %s %s, got %s %s" % (
                    name, want, z.dtype, tuple(a.shape), a.dtype))
            if not a.is_contiguous() or a.device != z.device:
                raise ValueError("%s: band planes must be contiguous on %s"
                                 % (name, z.device))
        return re, im, 1
    want = tuple(z.shape[:-2]) + (H // 2, W // 2, 6)
    ctype = {torch.float32: torch.complex64,
             torch.float64: torch.complex128}.get(z.dtype)
    if tuple(yh.shape) != want or yh.dtype != ctype:
        raise ValueError("%s: subbands must be %s %s, got %s %s" % (
            name, want, ctype, tuple(yh.shape), yh.dtype))
    if not yh.is_contiguous() or yh.device != z.device:
        raise ValueError("%s: subbands must be contiguous on %s"
                         % (name, z.device))
    return torch.view_as_real(yh), None, 0


def inv_level2(z: torch.Tensor, yh=None, g0a=None, g0b=None, g1a=None,
               g1b=None, bands=None, g2a=None, g2b=None):
    """Qshift inverse level; see :func:`inv_level2_reference`."""
    if z.device.type == "cpu":
        return inv_level2_reference(z, yh, g0a, g0b, g1a, g1b, bands, g2a,
                                    g2b)
    if z.device.type != "cuda":
        raise ValueError("inv_level2 runs on CPU or CUDA tensors, not %s"
                         % z.device)
    _build.check_no_grad("inv_level2", z, yh, bands)
    if (g2a is None) != (g2b is None):
        raise ValueError("inv_level2 takes the third pair g2a, g2b together")
    if z.ndim < 2 or z.shape[-2] % 2 or z.shape[-1] % 2:
        raise ValueError("inv_level2 needs [..., H, W] with H, W even, got "
                         "%s" % (tuple(z.shape),))
    if not z.is_contiguous():
        raise ValueError("inv_level2 needs a contiguous lowpass")
    f = _build.pair_filters("inv_level2", g0b, g0a, g1b, g1a, g2b, g2a)
    t0, o0 = ifilt_streams(f[0], f[1])
    t1, o1 = ifilt_streams(f[2], f[3])
    t2, o2 = (None, None) if g2a is None else ifilt_streams(f[4], f[5])
    m2 = t0.shape[1]
    _build.check_smem("inv_level2", z.dtype, (2 * _build.QY, 2 * _build.QX),
                      m2, 4, 2 if t2 is None else 3, 4 * _build.QY)
    code = _build.dtype_code(z.dtype)
    band_a, band_b, planes = _band_args(z, yh, bands, "inv_level2")
    z3, lead = _build.flatten_batch(z)
    B, H, W = z3.shape
    out = torch.empty((B, 2 * H, 2 * W), dtype=z.dtype, device=z.device)
    taps = _build.taps_arg(t0, t1)
    offs = _build.ints_arg(o0 + o1)
    taps2 = None if t2 is None else _build.taps_arg(t2)
    offs2 = None if t2 is None else _build.ints_arg(o2)
    lib = _build.library()
    err = lib.dtcwt_ilevel2(
        z3.data_ptr(), band_a.data_ptr(),
        None if band_b is None else band_b.data_ptr(), out.data_ptr(),
        B, H, W, taps.ctypes.data, offs.ctypes.data, _build.ptr(taps2),
        _build.ptr(offs2), m2, code, planes, _build.stream_ptr(z.device))
    _build.check("inv_level2", err)
    _build.count("ilevel2")
    return out.reshape(lead + out.shape[1:])
