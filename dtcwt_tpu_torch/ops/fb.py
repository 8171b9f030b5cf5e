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
    "trim_ext", "filter_from_wide_ext", "dfilt_from_wide_ext",
    "ifilt_from_wide_ext", "filter2_from_wide_ext", "dfilt2_from_wide_ext",
    "filter2_sum_from_wide_ext", "ifilt2_sum_from_wide_ext",
    "filter_streams", "dfilt_streams", "ifilt_streams",
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
# the primitives and their dual forms on a wide extension: a buffer the
# caller has already extended by *side* samples each side of *axis* (side >=
# what each filter needs), trimmed to each filter's own width
# ---------------------------------------------------------------------------

def trim_ext(ext: torch.Tensor, side: int, need: int, axis: int):
    """Trim a wide extension (width *side* per side) to width *need*."""
    if side == need:
        return ext
    axis = _norm_axis(axis, ext.ndim)
    return ext.narrow(axis, side - need, ext.shape[axis] - 2 * (side - need))


def filter_from_wide_ext(ext, side: int, h, axis: int):
    """:func:`filter_from_ext` on an extension of width *side* >=
    ``len(h)//2`` per side."""
    h = _as_taps(h)
    return filter_from_ext(trim_ext(ext, side, h.size // 2, axis), h, axis)


def dfilt_from_wide_ext(ext, side: int, ha, hb, axis: int):
    """:func:`dfilt_from_ext` on an extension of width *side* >= ``len(ha)``
    per side."""
    ha, hb = _as_taps(ha), _as_taps(hb)
    return dfilt_from_ext(trim_ext(ext, side, ha.size, axis), ha, hb, axis)


def ifilt_from_wide_ext(ext, side: int, ha, hb, axis: int):
    """:func:`ifilt_from_ext` on an extension of width *side* >=
    ``len(ha)//2`` per side."""
    ha, hb = _as_taps(ha), _as_taps(hb)
    return ifilt_from_ext(trim_ext(ext, side, ha.size // 2, axis), ha, hb,
                          axis)


def filter2_from_wide_ext(ext, side: int, h0, h1, axis: int):
    """``(filter(ext|h0), filter(ext|h1))`` on one wide extension."""
    h0, h1 = _as_taps(h0), _as_taps(h1)
    return (filter_from_ext(trim_ext(ext, side, h0.size // 2, axis), h0,
                            axis),
            filter_from_ext(trim_ext(ext, side, h1.size // 2, axis), h1,
                            axis))


def dfilt2_from_wide_ext(ext, side: int, pair0, pair1, axis: int):
    """Both decimating branch pairs on one wide extension."""
    ha0, hb0 = (_as_taps(h) for h in pair0)
    ha1, hb1 = (_as_taps(h) for h in pair1)
    return (dfilt_from_ext(trim_ext(ext, side, ha0.size, axis), ha0, hb0,
                           axis),
            dfilt_from_ext(trim_ext(ext, side, ha1.size, axis), ha1, hb1,
                           axis))


def filter2_sum_from_wide_ext(a, b, side: int, h0, h1, axis: int):
    """``filter(a|h0) + filter(b|h1)`` on two wide extensions."""
    h0, h1 = _as_taps(h0), _as_taps(h1)
    return (filter_from_ext(trim_ext(a, side, h0.size // 2, axis), h0, axis)
            + filter_from_ext(trim_ext(b, side, h1.size // 2, axis), h1,
                              axis))


def ifilt2_sum_from_wide_ext(a, b, side: int, pair0, pair1, axis: int):
    """``ifilt(a|pair0) + ifilt(b|pair1)`` on two wide extensions."""
    ha0, hb0 = (_as_taps(h) for h in pair0)
    ha1, hb1 = (_as_taps(h) for h in pair1)
    return (ifilt_from_ext(trim_ext(a, side, ha0.size // 2, axis), ha0, hb0,
                           axis)
            + ifilt_from_ext(trim_ext(b, side, ha1.size // 2, axis), ha1,
                             hb1, axis))


# ---------------------------------------------------------------------------
# the primitives as output streams, the plans the CUDA kernels take:
# ``Y[P i + s] = sum_k taps[s][k] x[D i + offs[s] + S k]`` with x indexed by
# symmetric reflection; filter P = D = S = 1, dfilt P = 2, D = 4, S = 2,
# ifilt P = 4, D = 2, S = 2
# ---------------------------------------------------------------------------

def filter_streams(h):
    """The non-decimating filter as one stream: ``Y[i] = sum_k rev(h)[k]
    x[i - m//2 + k]``; the output has r + 1 - m % 2 samples."""
    h = _as_taps(h)
    return h[::-1][None, :], (-(h.size // 2),)


def dfilt_streams(ha, hb):
    """The decimator ``dfilt(x, ha, hb)`` as two output streams
    ``Y[2i + s] = sum_k taps[s][k] x[4i + offs[s] + 2k]``, from the closed
    form of :func:`dfilt_from_ext`: branch a reads ``ext[4i + 2 + 2k]``,
    branch b ``ext[4i + 3 + 2k]`` with reversed taps, and the sign of
    ``sum(ha*hb)`` says which comes first."""
    ha = np.asarray(ha, np.float64).reshape(-1)
    hb = np.asarray(hb, np.float64).reshape(-1)
    m = ha.size
    a, b = (ha[::-1], 2 - m), (hb[::-1], 3 - m)
    first, second = (a, b) if float(np.sum(ha * hb)) > 0 else (b, a)
    return (np.stack([first[0], second[0]]), (first[1], second[1]))


def ifilt_streams(ha, hb):
    """The interpolator ``ifilt(x, ha, hb)`` as four output streams
    ``Y[4i + s] = sum_k taps[s][k] x[2i + offs[s] + 2k]``, from the four
    parity cases of :func:`ifilt_from_ext`: a stream reads the ``ev``
    (extended index ``m2 % 2 + 2n``) or ``od`` phase at offset 0 or 1, with
    the reversed even- or odd-index taps of *ha* or *hb*."""
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
