"""Quad <-> complex subband packing of the 2-D DTCWT, for batched
``[..., H, W]`` tensors, and the even/odd <-> complex packing of the 1-D
DTCWT along one axis (the 1-D and 2-D parts of ``dtcwt_tpu.ops.packing``).

The four corners of each 2x2 quad ``(a b / c d)`` combine as
``p = (a + jb)/sqrt(2)``, ``q = (d - jc)/sqrt(2)``; the two oriented
subbands are ``p - q`` and ``p + q``.  The ``*_planes`` forms carry
``(re, im)`` real pairs instead of complex tensors, which is the only route
for bfloat16 (there is no bfloat16 complex dtype).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["q2c", "c2q", "q2c_planes", "c2q_planes", "interleave_axis",
           "q2c1d", "c2q1d", "q2c1d_planes", "c2q1d_planes"]

_SQRT_HALF = float(np.sqrt(0.5))


def interleave_axis(parts, axis: int) -> torch.Tensor:
    """Interleave same-shape tensors along *axis*: out[k*i+q] = parts[q][i]."""
    axis = axis if axis >= 0 else axis + parts[0].ndim
    shape = list(parts[0].shape)
    shape[axis] *= len(parts)
    return torch.stack(parts, dim=axis + 1).reshape(shape)


def _corners(y: torch.Tensor):
    ev = y[..., 0::2, :]
    od = y[..., 1::2, :]
    return ev[..., 0::2], ev[..., 1::2], od[..., 0::2], od[..., 1::2]


def q2c_planes(y: torch.Tensor):
    """Real quad image ``[..., H, W]`` -> the two subbands as
    ``((re0, im0), (re1, im1))``, each ``[..., H/2, W/2]``."""
    a, b, c, d = _corners(y)
    sc = _SQRT_HALF
    return (((a - d) * sc, (b + c) * sc), ((a + d) * sc, (b - c) * sc))


def q2c(y: torch.Tensor):
    """Real quad image ``[..., H, W]`` -> the two complex subbands
    ``[..., H/2, W/2]`` of the dual tree."""
    (r0, i0), (r1, i1) = q2c_planes(y)
    return torch.complex(r0, i0), torch.complex(r1, i1)


def c2q_planes(w0, w1, g0=1.0, g1=1.0) -> torch.Tensor:
    """:func:`c2q` on ``(re, im)`` pairs instead of complex subbands."""
    r0, i0 = w0
    r1, i1 = w1
    s0 = float(g0) * _SQRT_HALF
    s1 = float(g1) * _SQRT_HALF
    pr, pi = r0 * s0 + r1 * s1, i0 * s0 + i1 * s1
    qr, qi = r0 * s0 - r1 * s1, i0 * s0 - i1 * s1
    top = interleave_axis((pr, pi), axis=-1)
    bot = interleave_axis((qi, -qr), axis=-1)
    return interleave_axis((top, bot), axis=-2)


def c2q(w0: torch.Tensor, w1: torch.Tensor, g0=1.0, g1=1.0) -> torch.Tensor:
    """Inverse of :func:`q2c`: scale the two complex subbands by (g0, g1)
    and reassemble the real quad image of twice the height and width."""
    return c2q_planes((w0.real, w0.imag), (w1.real, w1.imag), g0, g1)


def q2c1d_planes(y: torch.Tensor, axis: int = 0):
    """The 1-D pack without the complex dtype: the ``(re, im)`` pair is the
    even/odd deinterleave of *y* along *axis* (any real dtype, bfloat16
    included), each contiguous."""
    axis = axis if axis >= 0 else axis + y.ndim
    idx = [slice(None)] * y.ndim
    idx[axis] = slice(0, None, 2)
    re = y[tuple(idx)]
    idx[axis] = slice(1, None, 2)
    return re.contiguous(), y[tuple(idx)].contiguous()


def q2c1d(y: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Pack alternating samples along *axis* into complex values:
    ``z[i] = y[2i] + j*y[2i+1]``."""
    return torch.complex(*q2c1d_planes(y, axis))


def c2q1d_planes(re: torch.Tensor, im: torch.Tensor,
                 axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`q2c1d_planes`: interleave the plane pair."""
    return interleave_axis((re, im), axis)


def c2q1d(z: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inverse of :func:`q2c1d`: interleave the real and imaginary parts
    along *axis*."""
    return interleave_axis((z.real, z.imag), axis)
