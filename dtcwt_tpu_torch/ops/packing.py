"""Quad <-> complex subband packing of the 2-D DTCWT, for batched
``[..., H, W]`` tensors, the even/odd <-> complex packing of the 1-D DTCWT
along one axis, and the octet <-> complex packing of the 3-D DTCWT
(``dtcwt_tpu.ops.packing``).

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
           "q2c1d", "c2q1d", "q2c1d_planes", "c2q1d_planes", "cube2c",
           "c2cube", "cube2c_planes", "c2cube_planes"]

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


def _split2(y: torch.Tensor, axis: int):
    """Even/odd split along one axis (single-axis strided views)."""
    lead = (slice(None),) * (axis % y.ndim)
    return y[lead + (slice(0, None, 2),)], y[lead + (slice(1, None, 2),)]


def _cube_corner_combos(y: torch.Tensor):
    """The eight corners of each 2x2x2 octet of ``[..., 2P, 2Q, 2R]`` and
    their p/q/r/s re/im combinations (eqs. (6)-(9) of Chen & Kingsbury,
    "Efficient Registration of Nonrigid 3-D Bodies", IEEE TIP 21(1), 2012).
    Corner letters are (dim -3, dim -2, dim -1) parities: A=000 B=010
    C=100 D=110 E=001 F=011 G=101 H=111.  Returns ``(re4, im4)`` lists in
    p, q, r, s order."""
    e0, o0 = _split2(y, -3)
    e0e1, e0o1 = _split2(e0, -2)
    o0e1, o0o1 = _split2(o0, -2)
    A, E = _split2(e0e1, -1)
    B, F = _split2(e0o1, -1)
    C, G = _split2(o0e1, -1)
    D, H = _split2(o0o1, -1)
    re4 = [(A - G - D - F) * 0.5, (A - G + D + F) * 0.5,
           (A + G + D - F) * 0.5, (A + G - D + F) * 0.5]
    im4 = [(B - H + C + E) * 0.5, (-B + H + C + E) * 0.5,
           (B + H - C + E) * 0.5, (-B - H - C + E) * 0.5]
    return re4, im4


def cube2c(y: torch.Tensor) -> torch.Tensor:
    """Real octet-sampled 3-D highpass volume ``[..., 2P, 2Q, 2R]`` -> its
    four complex directional subbands ``[..., P, Q, R, 4]`` (band-minor)."""
    re4, im4 = _cube_corner_combos(y)
    return torch.stack([torch.complex(r, i) for r, i in zip(re4, im4)],
                       dim=-1)


def cube2c_planes(y: torch.Tensor):
    """:func:`cube2c` without the complex dtype: ``(re, im)`` real tensors
    with the four subbands on a band-major axis, ``[..., 4, P, Q, R]``."""
    re4, im4 = _cube_corner_combos(y)
    return torch.stack(re4, dim=-4), torch.stack(im4, dim=-4)


def _c2cube_parts(pr, pi, qr, qi, rr, ri, sr, si) -> torch.Tensor:
    # corners indexed (dim -3, dim -2, dim -1) parity
    c000 = (pr + qr + rr + sr) * 0.5
    c101 = (-pr - qr + rr + sr) * 0.5
    c110 = (-pr + qr + rr - sr) * 0.5
    c011 = (-pr + qr - rr + sr) * 0.5
    c010 = (pi - qi + ri - si) * 0.5
    c111 = (-pi + qi + ri - si) * 0.5
    c100 = (pi + qi - ri - si) * 0.5
    c001 = (pi + qi + ri + si) * 0.5
    # interleave along dim -1, then -2, then -3 (single-axis interleaves)
    c00 = interleave_axis((c000, c001), axis=-1)
    c01 = interleave_axis((c010, c011), axis=-1)
    c10 = interleave_axis((c100, c101), axis=-1)
    c11 = interleave_axis((c110, c111), axis=-1)
    c0 = interleave_axis((c00, c01), axis=-2)
    c1 = interleave_axis((c10, c11), axis=-2)
    return interleave_axis((c0, c1), axis=-3)


def c2cube(z: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`cube2c`: four complex subbands ``[..., P, Q, R, 4]``
    back to the real octet volume ``[..., 2P, 2Q, 2R]``."""
    p, q, r, s = (z[..., i] for i in range(4))
    return _c2cube_parts(p.real, p.imag, q.real, q.imag, r.real, r.imag,
                         s.real, s.imag)


def c2cube_planes(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`cube2c_planes`: band-major ``[..., 4, P, Q, R]``
    re/im planes back to the real octet volume."""
    pr, qr, rr, sr = (re[..., i, :, :, :] for i in range(4))
    pi, qi, ri, si = (im[..., i, :, :, :] for i in range(4))
    return _c2cube_parts(pr, pi, qr, qi, rr, ri, sr, si)
