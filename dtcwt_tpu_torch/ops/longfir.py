"""Filters of any length on the card: the long-filter kernel
(``csrc/longfir.cu``) and its entries.

Every kernel wrapper of this package holds its own kernel's filters under a
tap bound (:data:`_build.TAP_BOUNDS`).  Past it, chosen by
:func:`_build.within_bound` before any launch, the wrapper runs this
module's kernel instead:

=========================  ================================================
wrapper past its bound     launches of ``csrc/longfir.cu``
=========================  ================================================
``single.filter*``         one one-branch analysis launch
``single.dfilt*``,         one one-branch analysis launch
``single.ifilt*``
``dual.filter2*``,         one two-branch analysis launch
``dual.dfilt2*``
``dual.filter2_sum*``,     one two-input sum launch
``dual.ifilt2_sum*``
the 2-D and 3-D level      their ``*_reference`` chain with this module as
wrappers, the hw wrappers  its primitives (*ops*), then their packing
=========================  ================================================

The kernel is one stream FIR (:func:`stream`): the plans of
:func:`fb.filter_streams`, :func:`fb.dfilt_streams` and
:func:`fb.ifilt_streams` on one or two branches, in the analysis form (one
input, an output a branch) or the sum form (a branch an input, one
output), reflecting symmetrically or reading a buffer extended by *side*.
Launches count as ``longfir_filter``, ``longfir_dfilt`` and
``longfir_ifilt`` by the plans' streams.

The seven primitives below carry :mod:`fb`'s names and signatures, so a
level's chain takes this module in place of :mod:`fb`.  Each takes its
route from the input's device: a CPU tensor runs its plain version, the
:mod:`fb` function of the same name (``fb.filter_axis``, ...; the
wrappers' ``*_reference`` versions compute them at float32 for bfloat16
storage), and a CUDA tensor launches the kernel or raises.  The kernel
takes float32, bfloat16 (float32 sums) and float64, any axis, any filter
length and signals shorter than the filter; the host refuses only views
whose indices would overflow the kernel's ints.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dtcwt_tpu_torch.ops import _build, fb

__all__ = ["stream", "filter_axis", "filter2_axis", "dfilt_axis",
           "dfilt2_axis", "ifilt_axis", "filter2_sum_axis",
           "ifilt2_sum_axis"]

#: Output streams P of each stream entry's plans (a wrapper's name)
STREAMS = {"filter": 1, "filter2": 1, "filter2_sum": 1, "dfilt": 2,
           "dfilt2": 2, "ifilt": 4, "ifilt2_sum": 4}
# streams P -> (the operation, samples a group steps D, samples a tap
# steps S)
_OPS = {1: ("filter", 1, 1), 2: ("dfilt", 4, 2), 4: ("ifilt", 2, 2)}
_STREAMS_MAX = 8        # csrc/longfir.cu LF_STREAMS
_THREADS = 256          # LF_THREADS


class _Plan(NamedTuple):
    """A filter set's streams: the plans (a branch each), each branch's
    filter parity (P = 1), every stream's taps in one float64 vector and
    the ints len, off, tap0 of the kernel's 8 streams."""
    plans: list
    odd: tuple
    taps: np.ndarray
    ints: list


_PLANS = {}
_DEVICE_TAPS = {}


def _plan(name: str, filters) -> _Plan:
    """The streams of entry *name*'s filter set (*filters*: a filter a
    branch for P = 1, else a pair a branch, flat), planned once per filter
    set and cached."""
    f = [fb._as_taps(v) for v in filters]
    key = (name,) + tuple(v.tobytes() for v in f)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    P = STREAMS[name]
    if P == 1:
        plans = [fb.filter_streams(h) for h in f]
    else:
        streams = fb.dfilt_streams if P == 2 else fb.ifilt_streams
        plans = []
        for ha, hb in zip(f[::2], f[1::2]):
            fb._check_pair(ha, hb)
            plans.append(streams(ha, hb))
    lens, offs, tap0, vecs = [], [], [], []
    for taps, o in plans:
        for s in range(P):
            tap0.append(sum(v.size for v in vecs))
            vecs.append(np.ascontiguousarray(taps[s]))
            lens.append(taps.shape[1])
            offs.append(int(o[s]))
    pad = [0] * (_STREAMS_MAX - len(lens))
    plan = _Plan(plans, tuple(h.size % 2 for h in f) if P == 1 else (),
                 np.concatenate(vecs), lens + pad + offs + pad + tap0 + pad)
    if len(_PLANS) >= 64:
        _PLANS.clear()
        _DEVICE_TAPS.clear()
    _PLANS[key] = plan
    return plan


def _device_taps(plan: _Plan, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """The plan's taps on *device* in the kernel's accumulator type (float64
    for float64, else float32), copied there once per filter set."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    key = (id(plan), acc, device)
    t = _DEVICE_TAPS.get(key)
    if t is None:
        t = torch.as_tensor(plan.taps, dtype=acc, device=device)
        _DEVICE_TAPS[key] = t
    return t


def _tiling(inner: int):
    """(vc, tx): columns a thread, tx apart, and threads across the
    columns; one output a thread along a contiguous axis."""
    if inner == 1:
        return 1, 1
    vc = 4 if inner >= 4 * 64 else 1
    return vc, min(64, 1 << (-(-inner // vc) - 1).bit_length())


def stream(name: str, ins, filters, n: int, axis: int, side=None):
    """Run stream entry *name* (a key of :data:`STREAMS`) on the long-filter
    kernel: on the contiguous CUDA tensors *ins* (two for a sum) along
    *axis* whose signal has *n* samples, with *filters* as
    ``dual._launch_stream`` takes them; *side*: the inputs are extended by
    that many samples a side instead of reflected.  Returns the list of
    outputs: each branch's (analysis), or the sum."""
    P = STREAMS[name]
    op, D, S = _OPS[P]
    _build.check_no_grad("longfir_" + op, ins)
    plan = _plan(name, filters)
    nb = len(plan.plans)
    x = ins[0]
    if len(ins) == 2 and ins[1].shape != x.shape:
        raise ValueError("%s: branch inputs must have the same shape, got %s"
                         " and %s" % (name, tuple(x.shape),
                                      tuple(ins[1].shape)))
    ax, outer, n_in, inner, code = _build.axis_view(name, ins, axis)
    groups = [n + 1 - odd for odd in plan.odd] if P == 1 else [n // D] * nb
    _build.check_reach(name, plan.plans, groups, D, S, n_in, side)
    reach = (max(abs(o) for _, offs in plan.plans for o in offs)
             + S * max(t.shape[1] for t, _ in plan.plans) + (side or 0))
    if (2 * n_in + D + reach > _build.INT_MAX
            or P * max(groups) > _build.INT_MAX - _THREADS):
        raise ValueError("%s: an axis of %d samples exceeds the long-filter "
                         "kernel's 32-bit indices" % (name, n_in))
    outs = []
    for g in (groups if len(ins) == 1 else groups[:1]):
        shape = list(x.shape)
        shape[ax] = P * g
        outs.append(torch.empty(shape, dtype=x.dtype, device=x.device))
    if min(groups) < 1 or outer * inner == 0:
        return outs
    vc, tx = _tiling(inner)
    rows = -(-P * max(groups) // (_THREADS // tx))
    if outer * rows * -(-inner // (tx * vc)) > _build.INT_MAX:
        raise ValueError("%s: the axis view [%d, %d, %d] needs more blocks "
                         "than a grid holds" % (name, outer, n_in, inner))
    taps = _device_taps(plan, x.dtype, x.device)
    meta = _build.ints_arg([P, D, S, nb, groups[0], groups[-1]] + plan.ints)
    y = [t.data_ptr() for t in outs] + [None]
    err = _build.library().dtcwt_longfir(
        ins[0].data_ptr(), ins[1].data_ptr() if len(ins) == 2 else None,
        y[0], y[1], outer, n_in, inner, int(len(ins) == 2), side or 0,
        int(side is None), taps.data_ptr(), meta.ctypes.data, code, vc, tx,
        _build.stream_ptr(x.device))
    _build.check("longfir_" + op, err)
    _build.count("longfir_" + op)
    return outs


# ---------------------------------------------------------------------------
# fb's primitives on the kernel: the *ops* of the level wrappers' long route
# ---------------------------------------------------------------------------

def _run(name, ins, filters, axis):
    ins = [t.contiguous() for t in ins]
    return stream(name, ins, filters, ins[0].shape[axis], axis)


def _multiple(x, axis: int, k: int) -> None:
    if x.shape[axis] % k:
        raise ValueError("Length of axis %d must be a multiple of %d"
                         % (axis, k))


def filter_axis(x: torch.Tensor, h, axis: int) -> torch.Tensor:
    """``fb.filter_axis`` on the kernel."""
    if _build.on_cpu(x, "filter_axis"):
        return fb.filter_axis(x, h, axis)
    return _run("filter", [x], (h,), axis)[0]


def filter2_axis(x: torch.Tensor, h0, h1, axis: int):
    """``fb.filter2_axis`` on the kernel, one two-branch launch."""
    if _build.on_cpu(x, "filter2_axis"):
        return fb.filter2_axis(x, h0, h1, axis)
    return tuple(_run("filter2", [x], (h0, h1), axis))


def dfilt_axis(x: torch.Tensor, ha, hb, axis: int) -> torch.Tensor:
    """``fb.dfilt_axis`` on the kernel."""
    if _build.on_cpu(x, "dfilt_axis"):
        return fb.dfilt_axis(x, ha, hb, axis)
    _multiple(x, axis, 4)
    return _run("dfilt", [x], (ha, hb), axis)[0]


def dfilt2_axis(x: torch.Tensor, pair0, pair1, axis: int):
    """``fb.dfilt2_axis`` on the kernel, one two-branch launch."""
    if _build.on_cpu(x, "dfilt2_axis"):
        return fb.dfilt2_axis(x, pair0, pair1, axis)
    _multiple(x, axis, 4)
    return tuple(_run("dfilt2", [x], (*pair0, *pair1), axis))


def ifilt_axis(x: torch.Tensor, ha, hb, axis: int) -> torch.Tensor:
    """``fb.ifilt_axis`` on the kernel."""
    if _build.on_cpu(x, "ifilt_axis"):
        return fb.ifilt_axis(x, ha, hb, axis)
    _multiple(x, axis, 2)
    return _run("ifilt", [x], (ha, hb), axis)[0]


def filter2_sum_axis(a: torch.Tensor, b: torch.Tensor, h0, h1, axis: int):
    """``fb.filter2_sum_axis`` on the kernel, one two-input launch."""
    if _build.on_cpu(a, "filter2_sum_axis"):
        return fb.filter2_sum_axis(a, b, h0, h1, axis)
    if fb._as_taps(h0).size % 2 != fb._as_taps(h1).size % 2:
        raise ValueError("Filter length parities must match")
    return _run("filter2_sum", [a, b], (h0, h1), axis)[0]


def ifilt2_sum_axis(a: torch.Tensor, b: torch.Tensor, pair0, pair1,
                    axis: int):
    """``fb.ifilt2_sum_axis`` on the kernel, one two-input launch."""
    if _build.on_cpu(a, "ifilt2_sum_axis"):
        return fb.ifilt2_sum_axis(a, b, pair0, pair1, axis)
    _multiple(a, axis, 2)
    return _run("ifilt2_sum", [a, b], (*pair0, *pair1), axis)[0]
