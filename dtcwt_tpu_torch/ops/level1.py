"""Level-1 forward of the 2-D DTCWT: one CUDA kernel and its plain version.

Replaces the Pallas kernel ``dtcwt_tpu/ops/pallas_level1.py:fwd_level1``.
What bounds it on the H100, and what the design does about it, is in the
kernel's source, ``csrc/level1.cu``: it is a memory-bound stencil, so the
kernel reads its input once per tile and keeps every intermediate image on
chip.

:func:`fwd_level1` takes its route from the input's device: a CPU tensor
runs :func:`fwd_level1_reference`, a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from dtcwt_tpu_torch.ops import _build, fb
from dtcwt_tpu_torch.ops.packing import q2c, q2c_planes
from dtcwt_tpu_torch.transforms.pyramid import PLANE_BAND_ORDER
from dtcwt_tpu_torch.utils import compute_view

__all__ = ["fwd_level1", "fwd_level1_reference"]

_BP_TODO = ("the bandpass third filter stream (h2o) of the level-1 CUDA "
            "kernel is not ported yet (ROADMAP.md, Queue 2, item 1)")


def _pack(im05, im23, im14, planes: bool, dtype):
    """q2c of the three highpass images into the six subbands: complex
    ``[..., h, w, 6]`` in degree order, or ``(re, im)`` planes
    ``[..., 6, h, w]`` in PLANE_BAND_ORDER stored as *dtype*."""
    if planes:
        b05, b23, b14 = q2c_planes(im05), q2c_planes(im23), q2c_planes(im14)
        deg = (b05[0], b14[0], b23[0], b23[1], b14[1], b05[1])
        re = torch.stack([deg[d][0] for d in PLANE_BAND_ORDER], dim=-3)
        im = torch.stack([deg[d][1] for d in PLANE_BAND_ORDER], dim=-3)
        return re.to(dtype), im.to(dtype)
    b05, b23, b14 = q2c(im05), q2c(im23), q2c(im14)
    return torch.stack([b05[0], b14[0], b23[0], b23[1], b14[1], b05[1]],
                       dim=-1)


def fwd_level1_reference(x: torch.Tensor, h0o, h1o, planes: bool = False,
                         h2o=None):
    """Plain PyTorch level-1 forward: ``(lolo [..., R, C], subbands)``, the
    subbands complex ``[..., R/2, C/2, 6]`` or ``(re, im)`` planes
    ``[..., 6, R/2, C/2]``.  *h2o* is the bandpass families' third filter."""
    X = compute_view(x)
    lo = fb.filter_axis(X, h0o, -2)
    hi = fb.filter_axis(X, h1o, -2)
    lolo = fb.filter_axis(lo, h0o, -1)
    im23 = fb.filter_axis(lo, h1o, -1)
    im05 = fb.filter_axis(hi, h0o, -1)
    if h2o is not None:
        im14 = fb.filter_axis(fb.filter_axis(X, h2o, -2), h2o, -1)
    else:
        im14 = fb.filter_axis(hi, h1o, -1)
    return lolo.to(x.dtype), _pack(im05, im23, im14, planes, x.dtype)


def fwd_level1(x: torch.Tensor, h0o, h1o, planes: bool = False, h2o=None):
    """Level-1 forward of ``[..., R, C]`` (R, C even); see
    :func:`fwd_level1_reference` for the outputs."""
    if x.device.type == "cpu":
        return fwd_level1_reference(x, h0o, h1o, planes, h2o)
    if x.device.type != "cuda":
        raise ValueError("fwd_level1 runs on CPU or CUDA tensors, not %s"
                         % x.device)
    if h2o is not None:
        raise NotImplementedError(_BP_TODO)
    h0 = np.asarray(h0o, np.float64).reshape(-1)
    h1 = np.asarray(h1o, np.float64).reshape(-1)
    if x.ndim < 2 or x.shape[-2] % 2 or x.shape[-1] % 2:
        raise ValueError("fwd_level1 needs [..., R, C] with R, C even, got %s"
                         % (tuple(x.shape),))
    if h0.size % 2 == 0 or h1.size % 2 == 0:
        raise ValueError("the level-1 kernel takes odd-length filters")
    if not x.is_contiguous():
        raise ValueError("fwd_level1 needs a contiguous input")
    code = _build.dtype_code(x.dtype)
    if code == 1 and not planes:
        raise TypeError("bfloat16 subbands exist only in the plane layout")
    x3, lead = _build.flatten_batch(x)
    B, R, C = x3.shape
    lolo = torch.empty_like(x3)
    h, w = R // 2, C // 2
    if planes:
        re = torch.empty((B, 6, h, w), dtype=x.dtype, device=x.device)
        im = torch.empty_like(re)
        out_a, out_b = re, im
    else:
        ctype = torch.complex64 if x.dtype == torch.float32 else \
            torch.complex128
        z = torch.empty((B, h, w, 6), dtype=ctype, device=x.device)
        out_a, out_b = torch.view_as_real(z), None
    t0, t1 = _build.taps_arg(h0[::-1]), _build.taps_arg(h1[::-1])
    lib = _build.library()
    err = lib.dtcwt_level1(
        x3.data_ptr(), lolo.data_ptr(), out_a.data_ptr(),
        None if out_b is None else out_b.data_ptr(), B, R, C,
        t0.ctypes.data, h0.size, t1.ctypes.data, h1.size, code, int(planes),
        _build.stream_ptr(x.device))
    _build.check("fwd_level1", err)
    _build.count("level1")
    lolo = lolo.reshape(lead + (R, C))
    if planes:
        return lolo, (re.reshape(lead + re.shape[1:]),
                      im.reshape(lead + im.shape[1:]))
    return lolo, z.reshape(lead + z.shape[1:])
