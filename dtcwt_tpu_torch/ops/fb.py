"""Filter-bank primitives in plain PyTorch: non-decimating, decimate-by-2
and interpolate-by-2 filtering along one axis, with symmetric-reflect
("repeat end samples") boundary handling.

These are the closed forms of ``dtcwt_tpu.ops.fb`` (see its module
docstring), written as unrolled valid correlations over strided slices.
Filters are float64 numpy vectors, so every parity decision (the sign of
``sum(ha*hb)``, the ``m/2`` parity of the interpolator) is a Python
constant.  No convolution operator is used: cuDNN convolutions run in TF32
by default on the card, and these functions are the yardstick that the CUDA
kernels are held against there.

Let ``ext`` be the input extended by ``n`` samples each side, ``r`` the
input length, ``m = len(ha)``, ``m2 = m//2``::

    filter   (n = m//2):  Y[i] = sum_k rev(h)[k] ext[i + k]
    dfilt    (n = m):     Ya[i] = sum_k rev(ha)[k] ext[4i + 2 + 2k]
                          Yb[i] = sum_k rev(hb)[k] ext[4i + 3 + 2k]
                          Y = interleave(Ya, Yb), or (Yb, Ya) when
                          sum(ha*hb) <= 0
    ifilt    (n = m2):    four output streams Y[4i + s], see ifilt_from_ext
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from dtcwt_tpu_torch.utils import reflect

__all__ = [
    "symmetric_extend", "filter_from_ext", "dfilt_from_ext", "ifilt_from_ext",
    "filter_axis", "dfilt_axis", "ifilt_axis",
    "filter2_axis", "dfilt2_axis", "filter2_sum_axis", "ifilt2_sum_axis",
    "colfilter", "rowfilter", "coldfilt", "rowdfilt", "colifilt", "rowifilt",
]


def _as_taps(h) -> np.ndarray:
    """A filter as a flat float64 numpy vector."""
    h = np.asarray(h, dtype=np.float64).reshape(-1)
    if h.size == 0:
        raise ValueError("Empty filter")
    return h


def _norm_axis(axis: int, ndim: int) -> int:
    axis = axis if axis >= 0 else axis + ndim
    if not 0 <= axis < ndim:
        raise ValueError("axis out of range")
    return axis


def _asfloat(x: torch.Tensor) -> torch.Tensor:
    return x if x.is_floating_point() else x.to(torch.get_default_dtype())


def _slice(x: torch.Tensor, axis: int, start: int, stop, step: int = 1):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, stop, step)
    return x[tuple(idx)]


def symmetric_extend(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """Extend *x* by *n* samples each side of *axis* by symmetric reflection
    with repeated end samples ([c b a | a b c ... x y z | z y x])."""
    axis = _norm_axis(axis, x.ndim)
    if n == 0:
        return x
    r = x.shape[axis]
    if n <= r:
        front = _slice(x, axis, 0, n).flip(axis)
        back = _slice(x, axis, r - n, r).flip(axis)
        return torch.cat([front, x, back], dim=axis)
    # Filter support longer than the signal: fold as often as needed.
    idx = reflect(np.arange(-n, r + n, dtype=np.float64), -0.5, r - 0.5)
    return x.index_select(axis, torch.as_tensor(idx.astype(np.int64),
                                                device=x.device))


def _corr(buf: torch.Tensor, taps: Sequence[float], n_out: int, axis: int,
          offset: int = 0, stride: int = 1, step: int = 1) -> torch.Tensor:
    """Valid correlation ``Y[i] = sum_k taps[k] * buf[stride*i + offset +
    step*k]`` along *axis*, unrolled over the taps."""
    acc = None
    for k, t in enumerate(taps):
        lo = offset + step * k
        term = _slice(buf, axis, lo, lo + stride * (n_out - 1) + 1,
                      stride) * float(t)
        acc = term if acc is None else acc + term
    return acc


def _interleave(parts, axis: int) -> torch.Tensor:
    """Interleave k same-shape tensors along *axis*: out[k*i + q] =
    parts[q][i]."""
    axis = _norm_axis(axis, parts[0].ndim)
    shape = list(parts[0].shape)
    shape[axis] *= len(parts)
    return torch.stack(parts, dim=axis + 1).reshape(shape)


# ---------------------------------------------------------------------------
# primitives on an extended buffer
# ---------------------------------------------------------------------------

def filter_from_ext(ext: torch.Tensor, h, axis: int) -> torch.Tensor:
    """:func:`filter_axis` on a buffer extended by ``len(h)//2`` each side."""
    h = _as_taps(h)
    axis = _norm_axis(axis, ext.ndim)
    return _corr(ext, h[::-1], ext.shape[axis] - h.size + 1, axis)


def dfilt_from_ext(ext: torch.Tensor, ha, hb, axis: int) -> torch.Tensor:
    """:func:`dfilt_axis` on a buffer extended by ``len(ha)`` each side."""
    ha, hb = _as_taps(ha), _as_taps(hb)
    axis = _norm_axis(axis, ext.ndim)
    m = ha.size
    n4 = (ext.shape[axis] - 2 * m) // 4
    ya = _corr(ext, ha[::-1], n4, axis, offset=2, stride=4, step=2)
    yb = _corr(ext, hb[::-1], n4, axis, offset=3, stride=4, step=2)
    if float(np.sum(ha * hb)) > 0:
        return _interleave((ya, yb), axis)
    return _interleave((yb, ya), axis)


def ifilt_from_ext(ext: torch.Tensor, ha, hb, axis: int) -> torch.Tensor:
    """:func:`ifilt_axis` on a buffer extended by ``len(ha)//2`` each side."""
    ha, hb = _as_taps(ha), _as_taps(hb)
    axis = _norm_axis(axis, ext.ndim)
    m2 = ha.size // 2
    n2 = (ext.shape[axis] - 2 * m2) // 2
    # phases holding even / odd *extended* indices e = p - m2
    ev = _slice(ext, axis, m2 % 2, None, 2)
    od = _slice(ext, axis, (m2 + 1) % 2, None, 2)
    ha_e, ha_o = ha[0::2][::-1], ha[1::2][::-1]
    hb_e, hb_o = hb[0::2][::-1], hb[1::2][::-1]
    pos = float(np.sum(ha * hb)) > 0
    c = lambda buf, taps, off: _corr(buf, taps, n2, axis, off)
    if m2 % 2 == 0:
        if pos:
            rows = (c(ev, ha_o, 0), c(od, hb_o, 0), c(ev, ha_e, 1),
                    c(od, hb_e, 1))
        else:
            rows = (c(od, ha_o, 0), c(ev, hb_o, 0), c(od, ha_e, 1),
                    c(ev, hb_e, 1))
    elif pos:
        rows = (c(ev, ha_e, 0), c(od, hb_e, 1), c(ev, ha_o, 0),
                c(od, hb_o, 1))
    else:
        rows = (c(od, ha_e, 1), c(ev, hb_e, 0), c(od, ha_o, 1),
                c(ev, hb_o, 0))
    return _interleave(rows, axis)


# ---------------------------------------------------------------------------
# primitives along an axis
# ---------------------------------------------------------------------------

def filter_axis(x: torch.Tensor, h, axis: int) -> torch.Tensor:
    """Non-decimating filter along *axis* with symmetric extension.  The
    output length is the input length for odd-length *h* and one more for
    even-length *h*."""
    h = _as_taps(h)
    x = _asfloat(x)
    return filter_from_ext(symmetric_extend(x, h.size // 2, axis), h, axis)


def _check_pair(ha: np.ndarray, hb: np.ndarray):
    if ha.shape != hb.shape:
        raise ValueError("Shapes of ha and hb must be the same")
    if ha.size % 2 != 0:
        raise ValueError("Lengths of ha and hb must be even")


def dfilt_axis(x: torch.Tensor, ha, hb, axis: int) -> torch.Tensor:
    """Dual-tree decimate-by-2 filter along *axis*: *ha* runs on one
    polyphase branch, *hb* on the other, and the outputs interleave in the
    order given by the sign of ``sum(ha*hb)``.  The axis length must be a
    multiple of 4."""
    ha, hb = _as_taps(ha), _as_taps(hb)
    if x.shape[axis] % 4 != 0:
        raise ValueError("Length of axis %d must be a multiple of 4" % axis)
    _check_pair(ha, hb)
    x = _asfloat(x)
    return dfilt_from_ext(symmetric_extend(x, ha.size, axis), ha, hb, axis)


def ifilt_axis(x: torch.Tensor, ha, hb, axis: int) -> torch.Tensor:
    """Dual-tree interpolate-by-2 filter along *axis* (the output is twice
    the input length).  The axis length must be even."""
    ha, hb = _as_taps(ha), _as_taps(hb)
    if x.shape[axis] % 2 != 0:
        raise ValueError("Length of axis %d must be a multiple of 2" % axis)
    _check_pair(ha, hb)
    x = _asfloat(x)
    return ifilt_from_ext(symmetric_extend(x, ha.size // 2, axis), ha, hb,
                          axis)


# ---------------------------------------------------------------------------
# dual-stream forms: both branch filters of one tree stage
#
#   filter2_axis(x, h0, h1)        == (filter_axis(x, h0), filter_axis(x, h1))
#   dfilt2_axis(x, p0, p1)         == (dfilt_axis(x, *p0), dfilt_axis(x, *p1))
#   filter2_sum_axis(a, b, g0, g1) == filter_axis(a, g0) + filter_axis(b, g1)
#   ifilt2_sum_axis(a, b, p0, p1)  == ifilt_axis(a, *p0) + ifilt_axis(b, *p1)
# ---------------------------------------------------------------------------

def filter2_axis(x, h0, h1, axis: int):
    return filter_axis(x, h0, axis), filter_axis(x, h1, axis)


def dfilt2_axis(x, pair0, pair1, axis: int):
    return dfilt_axis(x, *pair0, axis), dfilt_axis(x, *pair1, axis)


def filter2_sum_axis(a, b, h0, h1, axis: int):
    if _as_taps(h0).size % 2 != _as_taps(h1).size % 2:
        # odd filters emit r samples, even ones r+1: the sum is undefined
        raise ValueError("Filter length parities must match")
    return filter_axis(a, h0, axis) + filter_axis(b, h1, axis)


def ifilt2_sum_axis(a, b, pair0, pair1, axis: int):
    return ifilt_axis(a, *pair0, axis) + ifilt_axis(b, *pair1, axis)


# ---------------------------------------------------------------------------
# column/row aliases (column = second-to-last axis, row = last axis)
# ---------------------------------------------------------------------------

def _col_axis(x) -> int:
    """1-D signals are columns, so for 1-D/2-D inputs the filter axis is 0;
    batched [..., H, W] inputs filter axis -2."""
    return 0 if x.ndim <= 2 else -2


def colfilter(X, h):
    """Filter image columns with *h*, no decimation."""
    return filter_axis(X, h, _col_axis(X))


def rowfilter(X, h):
    """Filter image rows with *h*, no decimation."""
    return filter_axis(X, h, -1)


def coldfilt(X, ha, hb):
    """Decimate-by-2 dual filter on image columns."""
    return dfilt_axis(X, ha, hb, _col_axis(X))


def rowdfilt(X, ha, hb):
    """Decimate-by-2 dual filter on image rows."""
    return dfilt_axis(X, ha, hb, -1)


def colifilt(X, ha, hb):
    """Interpolate-by-2 dual filter on image columns."""
    return ifilt_axis(X, ha, hb, _col_axis(X))


def rowifilt(X, ha, hb):
    """Interpolate-by-2 dual filter on image rows."""
    return ifilt_axis(X, ha, hb, -1)
