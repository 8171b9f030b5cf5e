"""The four dual-stream filter kernels of one separable tree stage: CUDA
kernels and their plain versions.

Replaces the Pallas kernels of ``dtcwt_tpu/ops/pallas_dual.py``:

==================  ==================================  ===================
entry               computes                            Pallas builder
==================  ==================================  ===================
``filter2_axis``    ``(filter(x, h0), filter(x, h1))``  ``_build_filter2``
``dfilt2_axis``     ``(dfilt(x, *p0), dfilt(x, *p1))``  ``_build_dfilt2``
``filter2_sum_*``   ``filter(a, h0) + filter(b, h1)``   ``_build_filter2_sum``
``ifilt2_sum_*``    ``ifilt(a, *p0) + ifilt(b, *p1)``   ``_build_ifilt2_sum``
==================  ==================================  ===================

Each entry has an ``*_axis`` form, which extends the signal by symmetric
reflection itself, and a ``*_fromext_axis`` form, which reads a buffer the
caller has already extended by *side* samples each side of *axis*.  The
signatures are those of :mod:`fb`'s dual forms (``fb.filter2_axis``,
``fb.filter2_from_wide_ext``, ...).  Each entry ``f`` has ``f_reference``,
its plain version: :mod:`fb`'s form, computed at float32 for bfloat16
storage as the kernels compute.

An entry takes its route from the input's device: a CPU tensor runs the
plain version, a CUDA tensor launches the kernel (``csrc/dual.cu``) or
raises.  The kernels take any axis of a contiguous tensor, float32,
bfloat16 or float64, filters of up to 32 taps per stream of any length and
parity, and signals shorter than the filter.  The host turns every filter
pair into output streams (:func:`level2.dfilt_streams`,
:func:`ilevel2.ifilt_streams`), so the kernels hold no parity logic.

The same stream plans with one branch are the single-stream kernels
``dfilt`` and ``ifilt`` of :mod:`single` (``csrc/single.cu``), which launch
through :func:`_launch` here; both sources instantiate the one kernel of
``csrc/streams.cuh``.  :mod:`single`'s ``filter`` has a kernel of its own
(``csrc/filter.cu``).
"""

from __future__ import annotations

import numpy as np
import torch

from dtcwt_tpu_torch.ops import _build, fb
from dtcwt_tpu_torch.ops.ilevel2 import ifilt_streams
from dtcwt_tpu_torch.ops.level2 import dfilt_streams
from dtcwt_tpu_torch.utils import compute_view

__all__ = [
    "filter2_axis", "dfilt2_axis", "filter2_sum_axis", "ifilt2_sum_axis",
    "filter2_fromext_axis", "dfilt2_fromext_axis",
    "filter2_sum_fromext_axis", "ifilt2_sum_fromext_axis",
    "filter2_axis_reference", "dfilt2_axis_reference",
    "filter2_sum_axis_reference", "ifilt2_sum_axis_reference",
    "filter2_fromext_axis_reference", "dfilt2_fromext_axis_reference",
    "filter2_sum_fromext_axis_reference",
    "ifilt2_sum_fromext_axis_reference",
]

_MAX_TAPS = 32      # csrc/common.cuh MAX_TAPS, per output stream
_INT_MAX = 2 ** 31 - 1
# kernel -> (inputs, outputs, streams P, input step per group D, tap step S):
# branch b writes Y[P g + s] = sum_k t[s][k] x[D g + c[s] + S k]; the
# branches are the plans given to _launch (two here, one in ops/single)
_GEOM = {"filter2": (1, 2, 1, 1, 1), "dfilt2": (1, 2, 2, 4, 2),
         "filter2_sum": (2, 1, 1, 1, 1), "ifilt2_sum": (2, 1, 4, 2, 2),
         "dfilt": (1, 1, 2, 4, 2), "ifilt": (1, 1, 4, 2, 2)}

_device_taps = {}   # (taps bytes, device) -> float64 tap table on the card


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _plain(fn):
    """fb's form on the compute view of every tensor argument, each output
    cast back to the first tensor's dtype."""
    def ref(*args, **kwargs):
        dtype = next(a.dtype for a in args if isinstance(a, torch.Tensor))
        out = fn(*(compute_view(a) if isinstance(a, torch.Tensor) else a
                   for a in args), **kwargs)
        if isinstance(out, tuple):
            return tuple(y.to(dtype) for y in out)
        return out.to(dtype)
    ref.__name__ = fn.__name__ + "_reference"
    ref.__doc__ = "Plain version: ``fb.%s``." % fn.__name__
    return ref


filter2_axis_reference = _plain(fb.filter2_axis)
dfilt2_axis_reference = _plain(fb.dfilt2_axis)
filter2_sum_axis_reference = _plain(fb.filter2_sum_axis)
ifilt2_sum_axis_reference = _plain(fb.ifilt2_sum_axis)
filter2_fromext_axis_reference = _plain(fb.filter2_from_wide_ext)
dfilt2_fromext_axis_reference = _plain(fb.dfilt2_from_wide_ext)
filter2_sum_fromext_axis_reference = _plain(fb.filter2_sum_from_wide_ext)
ifilt2_sum_fromext_axis_reference = _plain(fb.ifilt2_sum_from_wide_ext)


# ---------------------------------------------------------------------------
# host plans and the launch
# ---------------------------------------------------------------------------

def _on_cpu(x: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (plain route), False for a CUDA tensor (kernel
    route); any other device raises."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError("%s runs on CPU or CUDA tensors, not %s"
                         % (name, x.device))
    return False


def _filter_plan(h):
    """The non-decimating filter as one stream: Y[i] = sum_k rev(h)[k]
    x[i - m//2 + k]; the output has r + 1 - m % 2 samples."""
    h = fb._as_taps(h)
    return h[::-1][None, :], (-(h.size // 2),)


def _pairs(pair0, pair1):
    pairs = [tuple(fb._as_taps(h) for h in p) for p in (pair0, pair1)]
    for ha, hb in pairs:
        fb._check_pair(ha, hb)
    return pairs


def _same_inputs(a: torch.Tensor, b: torch.Tensor, name: str) -> None:
    if a.shape != b.shape:
        raise ValueError("%s: branch inputs must have the same shape, got %s"
                         " and %s" % (name, tuple(a.shape), tuple(b.shape)))


def _ext_len(ext: torch.Tensor, side: int, axis: int) -> int:
    n = ext.shape[axis] - 2 * side
    if side < 0 or n < 1:
        raise ValueError("an extension of %d per side leaves no signal in "
                         "an axis of %d" % (side, ext.shape[axis]))
    return n


def _tap_table(plans, device) -> torch.Tensor:
    """The streams' taps as the kernel's [branches][P][MAX_TAPS] float64
    table on *device*, built once per filter set and device."""
    P = plans[0][0].shape[0]
    buf = np.zeros((len(plans), P, _MAX_TAPS))
    for b, (taps, _) in enumerate(plans):
        if taps.shape[1] > _MAX_TAPS:
            raise ValueError("the stream kernels take at most %d taps "
                             "per stream, got %d" % (_MAX_TAPS,
                                                     taps.shape[1]))
        buf[b, :, :taps.shape[1]] = taps
    key = (buf.tobytes(), str(device))
    table = _device_taps.get(key)
    if table is None:
        table = _device_taps[key] = torch.from_numpy(buf).to(device)
    return table


def _axis_view(name: str, ins, axis: int):
    """(axis, outer, n_in, inner, dtype code): the kernels' [outer, n_in,
    inner] view of the inputs *ins* along *axis*, which must be contiguous
    and share one dtype and device."""
    x = ins[0]
    ax = fb._norm_axis(axis, x.ndim)
    code = _build.dtype_code(x.dtype)
    for t in ins:
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError("%s: inputs must share one dtype and device"
                             % name)
        if not t.is_contiguous():
            raise ValueError("%s needs contiguous inputs" % name)
    shape = tuple(x.shape)
    return (ax, int(np.prod(shape[:ax], dtype=np.int64)), shape[ax],
            int(np.prod(shape[ax + 1:], dtype=np.int64)), code)


def _launch(name: str, ins, plans, groups, axis: int, side=None):
    """Run kernel *name* on the contiguous CUDA tensors *ins* along *axis*:
    branch b's streams ``plans[b] = (taps [P, m_b], offsets)`` write
    ``P * groups[b]`` samples (one or two branches, as the kernel has).
    *side*: the inputs are extended by that many samples per side
    (from-extension mode) instead of reflected."""
    _build.check_no_grad(name, ins)
    n_in_t, n_out, P, D, S = _GEOM[name]
    x = ins[0]
    ax, outer, n_in, inner, code = _axis_view(name, ins, axis)
    shape = tuple(x.shape)
    offs = []
    for b, (taps, o_b) in enumerate(plans):
        for s in range(P):
            first = o_b[s] + (side or 0)
            offs.append(first)
            last = first + D * (groups[b] - 1) + S * (taps.shape[1] - 1)
            if side is not None and groups[b] > 0 and (
                    first < 0 or last >= n_in):
                raise ValueError(
                    "%s: an extension of %d per side does not cover the "
                    "filters' reach" % (name, side))
    if max(outer, n_in, inner, P * max(groups)) > _INT_MAX:
        raise ValueError("%s: the axis view [%d, %d, %d] exceeds the "
                         "kernel's 32-bit sizes" % (name, outer, n_in, inner))
    outs = []
    for b in range(n_out):
        oshape = list(shape)
        oshape[ax] = P * groups[b]
        outs.append(torch.empty(oshape, dtype=x.dtype, device=x.device))
    if min(groups) < 1 or outer * inner == 0:
        return outs
    table = _tap_table(plans, x.device)
    lens = _build.ints_arg([taps.shape[1] for taps, _ in plans
                            for _ in range(P)])
    offs = _build.ints_arg(offs)
    fn = getattr(_build.library(), "dtcwt_" + name)
    err = fn(ins[0].data_ptr(), ins[1].data_ptr() if n_in_t == 2 else None,
             outs[0].data_ptr(), outs[1].data_ptr() if n_out == 2 else None,
             outer, n_in, inner, groups[0], groups[-1], int(side is None),
             table.data_ptr(), lens.ctypes.data, offs.ctypes.data, code,
             _build.stream_ptr(x.device))
    _build.check(name, err)
    _build.count(name)
    return outs


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------

def _filter2(x, h0, h1, axis, n, side=None):
    plans = [_filter_plan(h0), _filter_plan(h1)]
    groups = [n + 1 - taps.shape[1] % 2 for taps, _ in plans]
    return tuple(_launch("filter2", [x], plans, groups, axis, side))


def filter2_axis(x: torch.Tensor, h0, h1, axis: int):
    """Both non-decimating branch filters with the input read once:
    ``(filter(x, h0), filter(x, h1))``."""
    if _on_cpu(x, "filter2_axis"):
        return filter2_axis_reference(x, h0, h1, axis)
    return _filter2(x, h0, h1, axis, x.shape[axis])


def filter2_fromext_axis(ext: torch.Tensor, side: int, h0, h1, axis: int):
    """:func:`filter2_axis` on a buffer extended by *side* per side."""
    if _on_cpu(ext, "filter2_fromext_axis"):
        return filter2_fromext_axis_reference(ext, side, h0, h1, axis)
    return _filter2(ext, h0, h1, axis, _ext_len(ext, side, axis), side)


def _dfilt2(x, pair0, pair1, axis, n, side=None):
    plans = [dfilt_streams(ha, hb) for ha, hb in _pairs(pair0, pair1)]
    return tuple(_launch("dfilt2", [x], plans, [n // 4] * 2, axis, side))


def dfilt2_axis(x: torch.Tensor, pair0, pair1, axis: int):
    """Both decimate-by-2 branch pairs with the input read once:
    ``(dfilt(x, *pair0), dfilt(x, *pair1))``.  The axis length must be a
    multiple of 4."""
    if x.shape[axis] % 4:
        raise ValueError("Length of axis %d must be a multiple of 4" % axis)
    if _on_cpu(x, "dfilt2_axis"):
        return dfilt2_axis_reference(x, pair0, pair1, axis)
    return _dfilt2(x, pair0, pair1, axis, x.shape[axis])


def dfilt2_fromext_axis(ext: torch.Tensor, side: int, pair0, pair1,
                        axis: int):
    """:func:`dfilt2_axis` on a buffer extended by *side* per side."""
    if _on_cpu(ext, "dfilt2_fromext_axis"):
        return dfilt2_fromext_axis_reference(ext, side, pair0, pair1, axis)
    return _dfilt2(ext, pair0, pair1, axis, _ext_len(ext, side, axis), side)


def _filter2_sum(a, b, h0, h1, axis, n, side=None):
    plans = [_filter_plan(h0), _filter_plan(h1)]
    g = n + 1 - plans[0][0].shape[1] % 2
    return _launch("filter2_sum", [a, b], plans, [g, g], axis, side)[0]


def _check_parity(h0, h1) -> None:
    if fb._as_taps(h0).size % 2 != fb._as_taps(h1).size % 2:
        raise ValueError("Filter length parities must match")


def filter2_sum_axis(a: torch.Tensor, b: torch.Tensor, h0, h1, axis: int):
    """One synthesis-stage branch merge: ``filter(a, h0) + filter(b, h1)``
    with the sum kept on chip.  Both filters odd or both even."""
    _check_parity(h0, h1)
    _same_inputs(a, b, "filter2_sum_axis")
    if _on_cpu(a, "filter2_sum_axis"):
        return filter2_sum_axis_reference(a, b, h0, h1, axis)
    return _filter2_sum(a, b, h0, h1, axis, a.shape[axis])


def filter2_sum_fromext_axis(a: torch.Tensor, b: torch.Tensor, side: int,
                             h0, h1, axis: int):
    """:func:`filter2_sum_axis` on buffers extended by *side* per side."""
    _check_parity(h0, h1)
    _same_inputs(a, b, "filter2_sum_fromext_axis")
    if _on_cpu(a, "filter2_sum_fromext_axis"):
        return filter2_sum_fromext_axis_reference(a, b, side, h0, h1, axis)
    return _filter2_sum(a, b, h0, h1, axis, _ext_len(a, side, axis), side)


def _ifilt2_sum(a, b, pair0, pair1, axis, n, side=None):
    plans = [ifilt_streams(ha, hb) for ha, hb in _pairs(pair0, pair1)]
    return _launch("ifilt2_sum", [a, b], plans, [n // 2] * 2, axis,
                   side)[0]


def ifilt2_sum_axis(a: torch.Tensor, b: torch.Tensor, pair0, pair1,
                    axis: int):
    """One synthesis-stage branch merge: ``ifilt(a, *pair0) + ifilt(b,
    *pair1)`` with the sum kept on chip.  The axis length must be even."""
    if a.shape[axis] % 2:
        raise ValueError("Length of axis %d must be a multiple of 2" % axis)
    _same_inputs(a, b, "ifilt2_sum_axis")
    if _on_cpu(a, "ifilt2_sum_axis"):
        return ifilt2_sum_axis_reference(a, b, pair0, pair1, axis)
    return _ifilt2_sum(a, b, pair0, pair1, axis, a.shape[axis])


def ifilt2_sum_fromext_axis(a: torch.Tensor, b: torch.Tensor, side: int,
                            pair0, pair1, axis: int):
    """:func:`ifilt2_sum_axis` on buffers extended by *side* per side."""
    _same_inputs(a, b, "ifilt2_sum_fromext_axis")
    if _on_cpu(a, "ifilt2_sum_fromext_axis"):
        return ifilt2_sum_fromext_axis_reference(a, b, side, pair0, pair1,
                                                 axis)
    return _ifilt2_sum(a, b, pair0, pair1, axis, _ext_len(a, side, axis),
                       side)
