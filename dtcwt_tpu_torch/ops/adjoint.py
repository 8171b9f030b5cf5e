"""Explicit adjoints (vector-Jacobian products) of the transforms' level
stages (``dtcwt_tpu.ops.adjoint``).

The backward of a transform on the card (:mod:`linearize`) runs these in
place of the plain path's autograd where the filters allow, built from the
kernels the primal already runs:

1. **A qshift level's adjoint is the opposite level stage.**  The
   synthesis filter bank of a qshift family is the transpose of its
   analysis bank, symmetric extension included, so the analysis level's
   adjoint is the synthesis level (``ilevel2.inv_level2``,
   ``pack3d.inv_level2_pack``) and the synthesis level's the analysis
   level (``level2.fwd_level2``, ``pack3d.fwd_level2_pack``).  The
   transforms hold a family to this with :func:`qshift_adjoint_error`,
   computed from the filters alone.

2. **The level-1 biort stage's adjoint is a zero-extension correlation
   plus a border fold.**  With ``A = V E`` (symmetric extension, then a
   valid correlation), ``A^T = E^T V^T``: the core of ``E^T V^T y`` is the
   same-size correlation of ``y`` with the reversed filter under zero
   extension, which the from-extension entries of :mod:`dual` and
   :mod:`single` compute on a buffer padded with ``p = len(h) // 2`` zeros
   a side, and the extension's transpose folds the reflected samples back
   onto a ``p``-sample border, two small triangular matrices applied to
   the edge strips.  The fold assumes one reflection: the signal must
   have at least ``p`` samples.  The q2c pack is orthogonal (its real
   4 x 4 blocks satisfy ``M M^T = I``), so its adjoint is ``c2q``.

3. **On a shard of a longer axis** (the sharded transforms' passes,
   ``parallel/_grid.py``) the zero extension takes the neighbours'
   samples at an interior side and zeros only beyond the whole axis's
   ends, and the fold goes to those ends alone
   (:func:`filter2_sum_adj_fromext`, :func:`filter2_adj_fromext`).  The
   (H, W) stage pairs of a 3-D shard compose the per-axis adjoints
   (:func:`filter_hw22_adj`, :func:`filter_sum_hw22_adj`).

Complex convention: a PyTorch gradient of a complex tensor is ``dL/dRe +
i dL/dIm``, the conjugate of JAX's cotangent, so these functions take the
band gradients as they come and return them as PyTorch wants them; the
JAX package's conjugations of both go away.  Plane layouts are real.

Every function here is plain PyTorch glue around the entries of
:mod:`dual` and :mod:`single`: on a CUDA tensor they launch the kernels,
on a CPU tensor they run the plain versions.  Filters must have odd
lengths.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from dtcwt_tpu_torch.ops import dual, fb, single
from dtcwt_tpu_torch.ops.ilevel2 import _quads
from dtcwt_tpu_torch.ops.level1 import _pack

__all__ = ["filter_adj_axis", "filter2_sum_adj_axis", "filter2_adj_axis",
           "fold_width", "filter2_sum_adj_fromext", "filter2_adj_fromext",
           "filter_hw22_adj", "filter_sum_hw22_adj", "level1_fwd_adj_quads",
           "level1_fwd_adj", "level1_inv_adj",
           "qshift_adjoint_error", "explicit_route", "QSHIFT_ADJOINT_TOL"]

#: The largest :func:`qshift_adjoint_error` of a family whose levels take
#: the explicit adjoint; every published family is at most 2.3e-16
QSHIFT_ADJOINT_TOL = 1e-13


@functools.lru_cache(maxsize=64)
def _border_mats(taps: bytes, dtype: torch.dtype, device: torch.device):
    """(Mf, Mb): the boundary-fold matrices of the reflect-repeat
    extension transpose of the filter with float64 *taps*, built on the
    host and cached on *device* as *dtype* (a copy from the host at each
    fold would wait for the device's queue).  front: xbar[t] += sum_i
    Mf[t, i] y[i]; back (mirrored indices s = n-1-t, u = n-1-i):
    Mb[s, u]."""
    h = np.frombuffer(taps, np.float64)
    p = h.size // 2
    revh = h[::-1]
    Mf = np.zeros((p, p))
    Mb = np.zeros((p, p))
    for t in range(p):
        for i in range(p - t):
            Mf[t, i] = revh[p - 1 - t - i]
    for s in range(p):
        for u in range(p - s):
            Mb[s, u] = revh[p + s + u + 1]
    return tuple(torch.as_tensor(M, dtype=dtype, device=device)
                 for M in (Mf, Mb))


def _odd(*hs):
    hs = [fb._as_taps(h) for h in hs]
    if any(h.size % 2 == 0 for h in hs):
        raise ValueError("the level-1 adjoints take odd-length filters, got "
                         "lengths %s" % [h.size for h in hs])
    return hs


def _zpad(y: torch.Tensor, p: int, axis: int) -> torch.Tensor:
    """*y* with *p* zeros each side of *axis* (a contiguous copy)."""
    return F.pad(y, [0, 0] * (y.ndim - 1 - axis) + [p, p])


def _strip_apply(M: torch.Tensor, strip: torch.Tensor, axis: int):
    """Contract a (p, p) matrix with *strip* along *axis* (extent p)."""
    out = torch.tensordot(strip.movedim(axis, -1), M, dims=([-1], [1]))
    return out.movedim(-1, axis)


def _fold_borders(core: torch.Tensor, y: torch.Tensor, h: np.ndarray,
                  axis: int, front: bool = True,
                  back: bool = True) -> torch.Tensor:
    """Add the extension transpose's border fold of (y, h) onto *core*
    (in place; *core* is a fresh output): at the front of *axis*, at its
    back, or, where *y* is a shard of a longer axis, at the one end that
    is the whole axis's."""
    p = h.size // 2
    if p == 0:
        return core
    n = y.shape[axis]
    if n < p:
        raise ValueError("the border fold of a %d-tap filter needs at least "
                         "%d samples, got %d" % (h.size, p, n))
    Mf, Mb = _border_mats(h.tobytes(), y.dtype, y.device)
    if front:
        core.narrow(axis, 0, p).add_(
            _strip_apply(Mf, y.narrow(axis, 0, p), axis))
    if back:
        core.narrow(axis, n - p, p).add_(_strip_apply(
            Mb, y.narrow(axis, n - p, p).flip(axis), axis).flip(axis))
    return core


def filter_adj_axis(y: torch.Tensor, h, axis: int) -> torch.Tensor:
    """Adjoint of ``single.filter_axis(., h, axis)`` (odd-length *h*): the
    same-size correlation of *y* with ``rev(h)`` under zero extension
    (``single.filter_fromext_axis``), then the border fold."""
    (h,) = _odd(h)
    axis = fb._norm_axis(axis, y.ndim)
    p = h.size // 2
    core = single.filter_fromext_axis(_zpad(y, p, axis), p, h[::-1], axis)
    return _fold_borders(core, y, h, axis)


def fold_width(h0, h1) -> int:
    """The zero extension a side of the two-filter level-1 adjoints:
    half the longer filter, which is also the least extent a side's
    border fold needs."""
    return max(fb._as_taps(h0).size, fb._as_taps(h1).size) // 2


def filter2_sum_adj_fromext(ea: torch.Tensor, eb: torch.Tensor, ya, yb,
                            side: int, h0, h1, axis: int, front: bool = True,
                            back: bool = True) -> torch.Tensor:
    """:func:`filter2_sum_adj_axis` of one shard of a longer axis: *ea*,
    *eb* are its cotangents *ya*, *yb* extended by *side* (at least
    :func:`fold_width`) a side, with zeros beyond the whole axis's ends
    and the neighbours' samples elsewhere (``halo_exchange(...,
    zero_ends=True)``); the border fold goes only to the *front* and
    *back* that are the whole axis's ends."""
    h0, h1 = _odd(h0, h1)
    axis = fb._norm_axis(axis, ya.ndim)
    core = dual.filter2_sum_fromext_axis(ea, eb, side, h0[::-1], h1[::-1],
                                         axis)
    core = _fold_borders(core, ya, h0, axis, front, back)
    return _fold_borders(core, yb, h1, axis, front, back)


def filter2_adj_fromext(e: torch.Tensor, y, side: int, h0, h1, axis: int,
                        front: bool = True, back: bool = True):
    """:func:`filter2_adj_axis` of one shard of a longer axis, *e* its
    cotangent *y* extended as for :func:`filter2_sum_adj_fromext`."""
    h0, h1 = _odd(h0, h1)
    axis = fb._norm_axis(axis, y.ndim)
    a, b = dual.filter2_fromext_axis(e, side, h0[::-1], h1[::-1], axis)
    return (_fold_borders(a, y, h0, axis, front, back),
            _fold_borders(b, y, h1, axis, front, back))


def filter2_sum_adj_axis(ya: torch.Tensor, yb: torch.Tensor, h0, h1,
                         axis: int) -> torch.Tensor:
    """``filter_adj(ya, h0) + filter_adj(yb, h1)``, the adjoint of
    ``dual.filter2_axis``: both cores in one ``filter2_sum`` pass."""
    p = fold_width(h0, h1)
    axis = fb._norm_axis(axis, ya.ndim)
    return filter2_sum_adj_fromext(_zpad(ya, p, axis), _zpad(yb, p, axis),
                                   ya, yb, p, h0, h1, axis)


def filter2_adj_axis(y: torch.Tensor, h0, h1, axis: int):
    """``(filter_adj(y, h0), filter_adj(y, h1))``, the adjoint of
    ``dual.filter2_sum_axis``: both cores from one ``filter2`` read."""
    p = fold_width(h0, h1)
    axis = fb._norm_axis(axis, y.ndim)
    return filter2_adj_fromext(_zpad(y, p, axis), y, p, h0, h1, axis)


def filter_hw22_adj(c00, c01, c10, c11, h0, h1) -> torch.Tensor:
    """Adjoint of ``hw.filter_hw22(x, h0, h1)`` from the gradients of its
    four outputs ``u[j][k]``: the H stage's adjoint for each W branch k,
    then the W stage's."""
    a0 = filter2_sum_adj_axis(c00, c10, h0, h1, -2)
    a1 = filter2_sum_adj_axis(c01, c11, h0, h1, -2)
    return filter2_sum_adj_axis(a0, a1, h0, h1, -1)


def filter_sum_hw22_adj(ybar: torch.Tensor, g0, g1):
    """Adjoint of ``hw.filter_sum_hw22(v00, v01, v10, v11, g0, g1)``: the
    gradients ``(v00, v01, v10, v11)``, the H stage's adjoint, then the W
    stage's for each H branch."""
    b0, b1 = filter2_adj_axis(ybar, g0, g1, -2)
    return filter2_adj_axis(b0, g0, g1, -1) + filter2_adj_axis(b1, g0, g1,
                                                               -1)


def level1_fwd_adj_quads(glow, lh, hl, hh, h0o, h1o) -> torch.Tensor:
    """Adjoint of the 2-D level-1 analysis (``level1.fwd_level1``) from the
    lowpass gradient *glow* and the band gradients' three quad images
    (``c2q`` of bands (0, 5), (2, 3), (1, 4)), all ``[..., H, W]``."""
    lo_bar = filter2_sum_adj_axis(glow, hl, h0o, h1o, -1)
    hi_bar = filter2_sum_adj_axis(lh, hh, h0o, h1o, -1)
    return filter2_sum_adj_axis(lo_bar, hi_bar, h0o, h1o, -2)


def level1_fwd_adj(glow, ybar, h0o, h1o) -> torch.Tensor:
    """Adjoint of the 2-D level-1 analysis: the gradients of ``(lowpass,
    level-1 subbands)`` back to the image's.  *glow* is ``[..., H, W]``,
    *ybar* the complex ``[..., H/2, W/2, 6]`` band gradient or its ``(re,
    im)`` planes ``[..., 6, H/2, W/2]``."""
    quads = _quads(**({"bands": ybar} if isinstance(ybar, tuple)
                      else {"yh": ybar}))
    return level1_fwd_adj_quads(glow, *quads, h0o, h1o)


def level1_inv_adj(xbar, g0o, g1o, planes: bool = False):
    """Adjoint of the 2-D level-1 synthesis (``ilevel1.inv_level1``): the
    image gradient *xbar* back to ``(lowpass gradient, level-1 band
    gradient)``, the band gradient complex ``[..., H/2, W/2, 6]`` or, with
    *planes*, ``(re, im)`` planes ``[..., 6, H/2, W/2]``."""
    y1_bar, y2_bar = filter2_adj_axis(xbar, g0o, g1o, -1)
    z_bar, lh_bar = filter2_adj_axis(y1_bar, g0o, g1o, -2)
    hl_bar, hh_bar = filter2_adj_axis(y2_bar, g0o, g1o, -2)
    return z_bar, _pack(lh_bar, hl_bar, hh_bar, planes, xbar.dtype)


@functools.lru_cache(maxsize=64)
def _transpose_error(taps: bytes):
    h0a, h0b, g0a, g0b, h1a, h1b, g1a, g1b = np.frombuffer(
        taps, np.float64).reshape(8, -1)
    m = h0a.size
    err = 0.0
    for n in range(4, 4 * -(-3 * m // 4) + 1, 4):
        eye = torch.eye(n, dtype=torch.float64)
        A = torch.cat([fb.dfilt_axis(eye, h0b, h0a, 0),
                       fb.dfilt_axis(eye, h1b, h1a, 0)])
        S = (fb.ifilt_axis(eye[:n // 2], g0b, g0a, 0)
             + fb.ifilt_axis(eye[n // 2:], g1b, g1a, 0))
        err = max(err, float((S - A.T).abs().max()))
    return err


def qshift_adjoint_error(qshift) -> float:
    """``||S - A^T||``, the max norm, of one 1-D qshift level of the
    8-tuple *qshift*: ``A`` the analysis (both branches' ``dfilt`` with its
    symmetric extension), ``S`` the synthesis (the ``ifilt`` sum), at every
    length that is a multiple of 4 from 4 to about three times the filter
    length, from the filters alone (float64 on the host, cached per filter
    tuple).  Within it the opposite stage is the analysis' transpose, which
    is what the explicit adjoint needs.  Filters of unequal lengths give
    ``inf``."""
    q = [fb._as_taps(v) for v in qshift]
    if len(q) != 8 or len({v.size for v in q}) != 1 or q[0].size % 2:
        return float("inf")
    return _transpose_error(np.concatenate(q).tobytes())


def explicit_route(biort, qshift, dtype) -> bool:
    """Whether the transforms' explicit adjoints hold for these filters
    and this dtype: four odd-length biort filters (no bandpass third
    filter), an 8-tuple qshift family whose :func:`qshift_adjoint_error`
    is within :data:`QSHIFT_ADJOINT_TOL`, float32 or float64.  The
    transforms add their shape rules."""
    return (dtype in (torch.float32, torch.float64) and len(biort) == 4
            and all(np.asarray(h).size % 2 for h in biort)
            and len(qshift) == 8
            and qshift_adjoint_error(qshift) <= QSHIFT_ADJOINT_TOL)
