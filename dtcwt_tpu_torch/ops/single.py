"""The three single-stream filter kernels: CUDA kernels and their plain
versions.

The counterpart of ``dtcwt_tpu/ops/pallas_fb.py`` (the name ``fb`` is taken
by the plain primitives, the counterpart of ``dtcwt_tpu/ops/fb.py``):

=================  =================================  ==================
entry              computes                           Pallas builder
=================  =================================  ==================
``filter_axis``    ``filter(x, h)``, no decimation    ``_build_filter``
``dfilt_axis``     ``dfilt(x, ha, hb)``, r -> r / 2   ``_build_dfilt``
``ifilt_axis``     ``ifilt(x, ha, hb)``, r -> 2 r     ``_build_ifilt``
=================  =================================  ==================

Each entry has an ``*_axis`` form, which extends the signal by symmetric
reflection itself, and a ``*_fromext_axis`` form, which reads a buffer the
caller has already extended by *side* samples each side of *axis*
(:func:`fb.filter_from_wide_ext`, ...), in the argument order of
:mod:`dual`.  Each entry ``f`` has ``f_reference``, its plain version:
:mod:`fb`'s form, computed at float32 for bfloat16 storage as the kernels
compute.  ``colfilter`` ... ``rowifilt`` are the column and row aliases of
the JAX package's low-level API, on these entries.

An entry takes its route from the input's device: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel or raises.  ``filter``'s
kernel is ``csrc/filter.cu``, tiled by :func:`_filter_geometry` here;
``dfilt`` and ``ifilt`` are the one-branch instances in ``csrc/single.cu``
of the stream kernel whose two-branch instances are :mod:`dual`'s analysis
entries (``filter2``, ``dfilt2``; the sums ``filter2_sum`` and
``ifilt2_sum`` have a kernel of their own, ``csrc/streamsum.cuh``).  The
nine names of the low-level API (``filter_axis``, ``dfilt_axis``,
``ifilt_axis`` and the column / row aliases) also take a non-tensor input,
a numpy array or a list, as the JAX package's do, and a keyword *device*:
a tensor stays on its device unless *device* is given, a non-tensor input
goes to *device*, the card (``"cuda"``) by default.  The
kernels take any axis of a contiguous tensor, float32, bfloat16 or
float64, filters of up to 32 taps per stream of any length and parity, and
signals shorter than the filter; the host plans
(:func:`level2.dfilt_streams`, :func:`ilevel2.ifilt_streams`) and
:func:`_filter` hold every parity rule.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from dtcwt_tpu_torch.ops import _build, fb
from dtcwt_tpu_torch.ops.dual import (
    _INT_MAX, _MAX_TAPS, _axis_view, _ext_len, _launch, _on_cpu, _plain)
from dtcwt_tpu_torch.ops.ilevel2 import ifilt_streams
from dtcwt_tpu_torch.ops.level2 import dfilt_streams

__all__ = [
    "filter_axis", "dfilt_axis", "ifilt_axis",
    "filter_fromext_axis", "dfilt_fromext_axis", "ifilt_fromext_axis",
    "filter_axis_reference", "dfilt_axis_reference", "ifilt_axis_reference",
    "filter_fromext_axis_reference", "dfilt_fromext_axis_reference",
    "ifilt_fromext_axis_reference",
    "colfilter", "rowfilter", "coldfilt", "rowdfilt", "colifilt", "rowifilt",
]

filter_axis_reference = _plain(fb.filter_axis)
dfilt_axis_reference = _plain(fb.dfilt_axis)
ifilt_axis_reference = _plain(fb.ifilt_axis)
filter_fromext_axis_reference = _plain(fb.filter_from_wide_ext)
dfilt_fromext_axis_reference = _plain(fb.dfilt_from_wide_ext)
ifilt_fromext_axis_reference = _plain(fb.ifilt_from_wide_ext)


def _pair(ha, hb):
    ha, hb = fb._as_taps(ha), fb._as_taps(hb)
    fb._check_pair(ha, hb)
    return ha, hb


def _input(x, device) -> torch.Tensor:
    """The input of a low-level name as a floating tensor: a tensor moves
    only when *device* is given; anything else goes to *device*, the card
    by default, and raises where there is none."""
    if isinstance(x, torch.Tensor):
        return fb._asfloat(x if device is None else x.to(device))
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for a %s input: pass device='cpu' "
                           "for the plain version" % type(x).__name__)
    return fb._asfloat(torch.as_tensor(np.asarray(x), device=device))


_THREADS = 256            # csrc/filter.cu FILTER_THREADS
_COL_ROWS = 8             # csrc/filter.cu FILTER_RV
_STAGE_BYTES = 16384      # input a block stages on the rows path


class FilterGeometry(NamedTuple):
    """The tiling of one ``filter`` launch (``csrc/filter.cu``).

    *path* ``"rows"`` (``inner = 1``): block ``b`` takes segment ``b %
    grid[1]`` (outputs ``[s * seg, s * seg + seg)``) of the *rows* outer
    rows from ``(b // grid[1]) * rows``; its threads take items of *v*
    consecutive outputs of one row in turn.  *path* ``"cols"``: block
    ``b`` is (outer, row tile, column tile) ``b`` in ``grid`` (the last
    fastest); thread ``(tid % tx, tid // tx)`` owns *vc* columns from
    ``(ct * tx + tid % tx) * vc`` and *v* output rows from ``rt * seg +
    (tid // tx) * v``.  *mt*: the tap loop's compile-time length; *smem*:
    dynamic shared memory bytes a block."""
    path: str
    mt: int
    v: int
    vc: int
    rows: int
    seg: int
    tx: int
    grid: Tuple[int, ...]
    smem: int

    @property
    def blocks(self) -> int:
        return int(np.prod(self.grid, dtype=np.int64))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _filter_geometry(outer: int, n_in: int, inner: int, g: int, m: int,
                     itemsize: int, x_ptr: int, y_ptr: int
                     ) -> FilterGeometry:
    """The tiling of ``filter`` on ``[outer, n_in, inner]`` into ``[outer,
    g, inner]`` with *m* taps, for elements of *itemsize* bytes at device
    addresses *x_ptr* and *y_ptr*."""
    mt = next(t for t in (8, 16, 32) if m <= t)
    vec = 16 // itemsize
    if inner == 1:
        # several whole rows of a short axis, or segments of a long one
        tgt = _STAGE_BYTES // itemsize
        if n_in <= tgt:
            seg, rows = _cdiv(g, vec) * vec, max(1, min(outer, tgt // n_in))
        else:
            seg, rows = tgt, 1
        smem = itemsize * (vec + (rows - 1) * n_in + min(n_in, seg + mt - 1))
        return FilterGeometry("rows", mt, vec, 1, rows, seg, 1,
                              (_cdiv(outer, rows), _cdiv(g, seg)), smem)
    vc = 2 if itemsize == 8 else 4
    if inner % vc or x_ptr % (vc * itemsize) or y_ptr % (vc * itemsize):
        vc = 1
    tx = min(_THREADS, 1 << (_cdiv(inner, vc) - 1).bit_length())
    seg = _THREADS // tx * _COL_ROWS
    return FilterGeometry("cols", mt, _COL_ROWS, vc, 1, seg, tx,
                          (outer, _cdiv(g, seg), _cdiv(inner, tx * vc)), 0)


def _filter(x, h, axis, n, side=None):
    """Launch ``csrc/filter.cu``: Y[i] = sum_k rev(h)[k] x[i + c + k] for
    the r + 1 - m % 2 outputs, c = -(m//2) reflected, or side - m//2 into
    a buffer extended by *side*."""
    _build.check_no_grad("filter", x)
    h = fb._as_taps(h)
    m = h.size
    if m > _MAX_TAPS:
        raise ValueError("filter takes at most %d taps, got %d"
                         % (_MAX_TAPS, m))
    ax, outer, n_in, inner, code = _axis_view("filter", [x], axis)
    shape = tuple(x.shape)
    g = n + 1 - m % 2
    c = (side or 0) - m // 2
    if side is not None and (c < 0 or c + g + m - 2 >= n_in):
        raise ValueError("filter: an extension of %d per side does not "
                         "cover the filters' reach" % side)
    if max(outer, n_in, inner, g) > _INT_MAX:
        raise ValueError("filter: the axis view [%d, %d, %d] exceeds the "
                         "kernel's 32-bit sizes" % (outer, n_in, inner))
    out = torch.empty(shape[:ax] + (g,) + shape[ax + 1:], dtype=x.dtype,
                      device=x.device)
    if outer * inner == 0:
        return out
    geo = _filter_geometry(outer, n_in, inner, g, m, x.element_size(),
                           x.data_ptr(), out.data_ptr())
    taps = np.ascontiguousarray(h[::-1])
    err = _build.library().dtcwt_filter(
        x.data_ptr(), out.data_ptr(), outer, n_in, inner, g, c,
        int(side is None), m, taps.ctypes.data, geo.mt,
        int(geo.path == "cols"), geo.v, geo.vc, geo.rows, geo.seg, geo.tx,
        code, _build.stream_ptr(x.device))
    _build.check("filter", err)
    _build.count("filter")
    return out


def filter_axis(x, h, axis: int, device=None) -> torch.Tensor:
    """Non-decimating filter along *axis* with symmetric extension: as many
    samples as the input for odd-length *h*, one more for even-length."""
    x = _input(x, device)
    if _on_cpu(x, "filter_axis"):
        return filter_axis_reference(x, h, axis)
    return _filter(x, h, axis, x.shape[axis])


def filter_fromext_axis(ext: torch.Tensor, side: int, h,
                        axis: int) -> torch.Tensor:
    """:func:`filter_axis` on a buffer extended by *side* >= ``len(h)//2``
    per side."""
    ext = fb._asfloat(ext)
    if _on_cpu(ext, "filter_fromext_axis"):
        return filter_fromext_axis_reference(ext, side, h, axis)
    return _filter(ext, h, axis, _ext_len(ext, side, axis), side)


def _dfilt(x, ha, hb, axis, n, side=None):
    return _launch("dfilt", [x], [dfilt_streams(ha, hb)], [n // 4], axis,
                   side)[0]


def dfilt_axis(x, ha, hb, axis: int, device=None) -> torch.Tensor:
    """Dual-tree decimate-by-2 filter along *axis*: *ha* on one polyphase
    branch, *hb* on the other, interleaved in the order given by the sign
    of ``sum(ha*hb)``.  The axis length must be a multiple of 4."""
    x = _input(x, device)
    if x.shape[axis] % 4:
        raise ValueError("Length of axis %d must be a multiple of 4" % axis)
    ha, hb = _pair(ha, hb)
    if _on_cpu(x, "dfilt_axis"):
        return dfilt_axis_reference(x, ha, hb, axis)
    return _dfilt(x, ha, hb, axis, x.shape[axis])


def dfilt_fromext_axis(ext: torch.Tensor, side: int, ha, hb,
                       axis: int) -> torch.Tensor:
    """:func:`dfilt_axis` on a buffer extended by *side* >= ``len(ha)`` per
    side."""
    ext = fb._asfloat(ext)
    ha, hb = _pair(ha, hb)
    if _on_cpu(ext, "dfilt_fromext_axis"):
        return dfilt_fromext_axis_reference(ext, side, ha, hb, axis)
    return _dfilt(ext, ha, hb, axis, _ext_len(ext, side, axis), side)


def _ifilt(x, ha, hb, axis, n, side=None):
    return _launch("ifilt", [x], [ifilt_streams(ha, hb)], [n // 2], axis,
                   side)[0]


def ifilt_axis(x, ha, hb, axis: int, device=None) -> torch.Tensor:
    """Dual-tree interpolate-by-2 filter along *axis* (twice the input
    length).  The axis length must be even."""
    x = _input(x, device)
    if x.shape[axis] % 2:
        raise ValueError("Length of axis %d must be a multiple of 2" % axis)
    ha, hb = _pair(ha, hb)
    if _on_cpu(x, "ifilt_axis"):
        return ifilt_axis_reference(x, ha, hb, axis)
    return _ifilt(x, ha, hb, axis, x.shape[axis])


def ifilt_fromext_axis(ext: torch.Tensor, side: int, ha, hb,
                       axis: int) -> torch.Tensor:
    """:func:`ifilt_axis` on a buffer extended by *side* >= ``len(ha)//2``
    per side."""
    ext = fb._asfloat(ext)
    ha, hb = _pair(ha, hb)
    if _on_cpu(ext, "ifilt_fromext_axis"):
        return ifilt_fromext_axis_reference(ext, side, ha, hb, axis)
    return _ifilt(ext, ha, hb, axis, _ext_len(ext, side, axis), side)


# ---------------------------------------------------------------------------
# column/row aliases (column = second-to-last axis, row = last axis; 1-D
# and 2-D inputs filter axis 0, as fb._col_axis says)
# ---------------------------------------------------------------------------

def colfilter(X, h, device=None):
    """Filter image columns with *h*, no decimation."""
    X = _input(X, device)
    return filter_axis(X, h, fb._col_axis(X))


def rowfilter(X, h, device=None):
    """Filter image rows with *h*, no decimation."""
    return filter_axis(X, h, -1, device)


def coldfilt(X, ha, hb, device=None):
    """Decimate-by-2 dual filter on image columns."""
    X = _input(X, device)
    return dfilt_axis(X, ha, hb, fb._col_axis(X))


def rowdfilt(X, ha, hb, device=None):
    """Decimate-by-2 dual filter on image rows."""
    return dfilt_axis(X, ha, hb, -1, device)


def colifilt(X, ha, hb, device=None):
    """Interpolate-by-2 dual filter on image columns."""
    X = _input(X, device)
    return ifilt_axis(X, ha, hb, fb._col_axis(X))


def rowifilt(X, ha, hb, device=None):
    """Interpolate-by-2 dual filter on image rows."""
    return ifilt_axis(X, ha, hb, -1, device)
