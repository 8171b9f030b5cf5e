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
bfloat16 or float64, and signals shorter than the filter.  The host turns
every filter pair into output streams (:func:`level2.dfilt_streams`,
:func:`ilevel2.ifilt_streams`), so the kernels hold no parity rule: they
take each branch's stream order as one swap of the two sample parities,
computed from the plans.

The four entries are one design run both ways, launched by
:func:`_launch_stream`: the analysis entries (``filter2``, ``dfilt2``:
one input, both branch outputs) are ``csrc/streamana.cuh``, the synthesis
sums (``filter2_sum``, ``ifilt2_sum``: two inputs summed in registers)
``csrc/streamsum.cuh``, both on the pieces of ``csrc/streamtile.cuh``
(filter.cu's design).  Their taps travel by value under a compile-time
bound (:func:`_plan`, cached per filter set) and their tiling comes from
:func:`_stream_geometry`; the C entries refuse any other, and
``tests/test_torch_dual_tiling.py`` replays both on the CPU.  They take
filters of up to 32 taps of either parity (``filter2``, whose two
branches may differ in parity and so in output length, and
``filter2_sum``), qshift pairs of up to 32 taps (``dfilt2``, two streams
of 32) and of up to 64 (``ifilt2_sum``, four streams of up to 32); past
those bounds :func:`_launch_stream` runs the long-filter kernel
(:mod:`longfir`) in one launch instead.
:mod:`single`'s ``dfilt`` and ``ifilt`` (``csrc/single.cu``) are the
one-branch instances of the same two kernels, launched here too, and take
the same pairs; :mod:`single`'s ``filter`` has a kernel of its own
(``csrc/filter.cu``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from dtcwt_tpu_torch.ops import _build, fb, longfir
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
# stream entry -> (streams P, input step per group D, tap step S) of its
# branches' plans, each writing Y[P g + s] = sum_k t[s][k] x[D g + c[s] +
# S k]: the dual entries' two branches, single's dfilt and ifilt one
_STREAM_GEOM = {"filter2": (1, 1, 1), "dfilt2": (2, 4, 2),
                "filter2_sum": (1, 1, 1), "ifilt2_sum": (4, 2, 2),
                "dfilt": (2, 4, 2), "ifilt": (4, 2, 2)}


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

_filter_plan = fb.filter_streams


def _pairs(*pairs):
    pairs = [tuple(fb._as_taps(h) for h in p) for p in pairs]
    for ha, hb in pairs:
        fb._check_pair(ha, hb)
    return pairs


def _same_inputs(a: torch.Tensor, b: torch.Tensor, name: str) -> None:
    if a.shape != b.shape:
        raise ValueError("%s: branch inputs must have the same shape, got %s"
                         " and %s" % (name, tuple(a.shape), tuple(b.shape)))


def _table(plans):
    """The plans' taps as the kernels' host [branches][P][MAX_TAPS] float64
    table and the [branches][P] tap counts and offsets."""
    P = plans[0][0].shape[0]
    taps = np.zeros((len(plans), P, _MAX_TAPS))
    lens, offs = [], []
    for b, (t, o) in enumerate(plans):
        if t.shape[1] > _MAX_TAPS:
            raise ValueError("the kernels take at most %d taps per stream, "
                             "got %d" % (_MAX_TAPS, t.shape[1]))
        taps[b, :, :t.shape[1]] = t
        lens += [t.shape[1]] * P
        offs += list(o)
    return taps, _build.ints_arg(lens), _build.ints_arg(offs)


# ---------------------------------------------------------------------------
# the stream kernels (csrc/streamana.cuh, csrc/streamsum.cuh) of the dual
# entries and of single's dfilt and ifilt: plans, tiling, launch
# ---------------------------------------------------------------------------

def _inv_taps(plans, P: int, mt: int):
    """The plans' taps centred on the halo of tap bound *mt*
    (csrc/taps.cuh make_hs_taps, csrc/ipack.cuh make_ip_taps): ``(t
    [branches][P][mt], sw [branches])``, t[b][s][k] multiplying window
    sample k of stream s of branch b (qshift streams: of the parity ``(s &
    1) ^ sw[b]``), or None where a stream does not fit."""
    ph = (mt - 1) // 2
    t = np.zeros((len(plans), P, mt))
    sw = [0] * len(plans)
    for b, (taps, offs) in enumerate(plans):
        if P > 1:
            sw[b] = (offs[0] + 2 * ph) & 1
        for s in range(P):
            m = taps.shape[1]
            d = ph + offs[s] if P == 1 else offs[s] + 2 * ph
            sh = d if P == 1 else d >> 1
            if d < 0 or sh + m > mt or (
                    P > 1 and (d & 1) != ((s & 1) ^ sw[b])):
                return None
            t[b, s, sh:sh + m] = taps[s]
    return t, sw


#: Tap bounds of the stream kernels' instances by streams P, every dtype
#: (csrc/taps.cuh st_bound): filter 5 (legall), 7 (near_sym_a), 9
#: (antonini), 19 (near_sym_b) or 33, whose halo holds 32 taps of either
#: parity; dfilt a stream's window in sample pairs, 10 (qshift_06,
#: qshift_a), 14 (qshift_b), 16 (qshift_c), 18 (qshift_d) or 32
#: (qshift_32), which holds qshift pairs of 32; ifilt 5 (qshift_a), 7
#: (qshift_b), 9 (qshift_c, qshift_d), 17 (qshift_32) or 33, which holds
#: qshift pairs of 64
_TAP_BOUNDS = {1: (5, 7, 9, 19, 33), 2: (10, 14, 16, 18, 32),
               4: (5, 7, 9, 17, 33)}


def _tap_bound(plans, P: int) -> int:
    """The least tap bound of the stream kernels' instances that holds the
    plans."""
    for mt in _TAP_BOUNDS[P]:
        if _inv_taps(plans, P, mt) is not None:
            return mt
    raise ValueError("the dual kernels' largest tap bound, %d, does not "
                     "hold these filters" % _TAP_BOUNDS[P][-1])


class _Plan(NamedTuple):
    """A filter set's launch arguments: the host tap table, lens and
    offsets (kept alive here across launches), the plans (a branch each),
    the parity of each branch's filter (filter2, filter2_sum) and the tap
    bound."""
    taps: np.ndarray
    lens: np.ndarray
    offs: np.ndarray
    plans: list
    odd: Tuple[int, int]
    mt: int


_PLANS = {}


def _plan(name: str, filters) -> _Plan:
    """The launch arguments of stream entry *name*'s filter set
    (*filters*: the two filters, the two pairs' four, or single's dfilt and
    ifilt one pair's two), planned once per filter set (keyed by the
    filters' values) and cached."""
    f = [fb._as_taps(v) for v in filters]
    key = (name,) + tuple(v.tobytes() for v in f)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    P = _STREAM_GEOM[name][0]
    if P == 1:
        plans = [_filter_plan(f[0]), _filter_plan(f[1])]
    else:
        streams = dfilt_streams if P == 2 else ifilt_streams
        plans = [streams(*p) for p in _pairs(*zip(f[::2], f[1::2]))]
    taps, lens, offs = _table(plans)
    plan = _Plan(taps, lens, offs, plans, (f[0].size % 2, f[1].size % 2),
                 _tap_bound(plans, P))
    if len(_PLANS) >= 64:
        _PLANS.clear()
    _PLANS[key] = plan
    return plan


_THREADS = 256          # csrc/streamtile.cuh ST_THREADS
# columns path, by itemsize: threads across inner at most (a block of 64
# spans four group rows, whose windows overlap in L1; float64 runs faster
# on rows of 256 threads)
_COL_TX = {2: 64, 4: 64, 8: 256}
# st_col_groups: groups a columns-path thread by (streams P, inputs,
# branches): the analysis entries (their two branches' accumulators)
# filter 4 outputs, dfilt 2 groups of 2; the sums filter 8, ifilt 4 groups
# of 4; single's one-branch dfilt 2 groups of 2, ifilt 2 groups of 4
_COL_GROUPS = {(1, 1, 2): 4, (2, 1, 2): 2, (1, 2, 2): 8, (4, 2, 2): 4,
               (2, 1, 1): 2, (4, 1, 1): 2}
# columns path: a grid of fewer blocks than this (under one an SM of the
# H100's 132) takes one column a thread, 2-4 times the blocks
_FEW_BLOCKS = 132
_STAGE_BYTES = 16384    # an input a rows-path block stages
# streams P -> (samples a group steps D, samples a tap steps S):
# csrc/streamtile.cuh st_step, st_tap_step
_STEPS = {geo[0]: geo[1:] for geo in _STREAM_GEOM.values()}


class StreamGeometry(NamedTuple):
    """The tiling of one stream launch (``csrc/streamtile.cuh``), over the
    output groups (filter: an output; dfilt: two, ifilt: four, one of each
    stream).

    *path* ``"rows"`` (``inner = 1``): block ``b`` takes segment ``b %
    grid[1]`` (groups ``[s * seg, s * seg + seg)``) of the *rows* outer
    rows from ``(b // grid[1]) * rows``, each input's flat range staged in
    a region of *smem* / inputs bytes; its threads take items of *v*
    consecutive groups of one row in turn.  *path* ``"cols"``: block ``b``
    is (outer, group tile, column tile) ``b`` in ``grid`` (the last
    fastest); thread ``(tid % tx, tid // tx)`` owns *vc* columns from
    ``(ct * tx + tid % tx) * vc`` and *v* groups from ``rt * seg + (tid //
    tx) * v``.  *mt*: the tap bound; *smem*: dynamic shared memory bytes a
    block."""
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

    def args(self):
        """The ints the C entry takes: mt, path, v, vc, rows, seg, tx,
        smem."""
        return (self.mt, int(self.path == "cols"), self.v, self.vc,
                self.rows, self.seg, self.tx, self.smem)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def _stream_geometry(P: int, outer: int, n_in: int, inner: int, g: int,
                     mt: int, itemsize: int, aligned: bool,
                     inputs: int = 2, branches: int = 2) -> StreamGeometry:
    """The tiling of a stream entry with *P* streams a branch (1: filter2
    or filter2_sum, 2: dfilt2 or dfilt, 4: ifilt2_sum or ifilt) on *inputs*
    ``[outer, n_in, inner]`` inputs (2: a sum; 1: an analysis entry or
    single's dfilt and ifilt) and *branches* filters (2: a dual entry; 1:
    single's) into outputs of ``g`` groups (the longer branch's) at tap
    bound *mt*, for elements of *itemsize* bytes; *aligned*: the inputs and
    the outputs start on a column vector (16 bytes, bfloat16 8).  Rows path
    for ``inner = 1``;
    else the columns path, a thread owning a column vector where inner and
    *aligned* allow it and the grid keeps ``_FEW_BLOCKS`` blocks, one
    column otherwise.  Cached: the transforms ask for the same tiling at
    every call."""
    D, S = _STEPS[P]
    vec = 16 // itemsize
    if inner == 1:
        # several whole rows of a short axis, or segments of a long one
        gv = max(1, vec // P)
        tgt = _STAGE_BYTES // itemsize
        if n_in <= tgt:
            seg, rows = _cdiv(g, gv) * gv, max(1, min(outer, tgt // n_in))
        else:
            seg, rows = tgt // D, 1
        region = _cdiv(vec + (rows - 1) * n_in
                       + min(n_in, D * (seg - 1) + S * mt), vec) * vec
        return StreamGeometry("rows", mt, gv, 1, rows, seg, 1,
                              (_cdiv(outer, rows), _cdiv(g, seg)),
                              inputs * region * itemsize)
    rv = _COL_GROUPS[P, inputs, branches]

    def cols(vc):
        tx = min(_COL_TX[itemsize],
                 1 << (_cdiv(inner, vc) - 1).bit_length())
        seg = _THREADS // tx * rv
        return StreamGeometry("cols", mt, rv, vc, 1, seg, tx,
                              (outer, _cdiv(g, seg), _cdiv(inner, tx * vc)),
                              0)
    vc = 2 if itemsize == 8 else 4
    if inner % vc or not aligned:
        vc = 1
    geo = cols(vc)
    return cols(1) if vc > 1 and geo.blocks < _FEW_BLOCKS else geo


def _output(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def _launch_stream(name: str, ins, filters, n: int, axis: int, side=None):
    """Run stream entry *name* on the contiguous CUDA tensors *ins* (the
    analysis entries and single's dfilt and ifilt one input, the sums two)
    along *axis* whose signal has *n* samples; *filters*: the two filters,
    the two pairs' four, or one pair's two (dfilt, ifilt).  *side*: the
    inputs are extended by that many samples per side (from-extension
    mode) instead of reflected.  Returns the list of outputs: each
    branch's (analysis, dfilt, ifilt), or the sum.  Filters past the
    kernels' tap bound run on the long-filter kernel instead."""
    filters = [fb._as_taps(f) for f in filters]
    if not _build.within_bound(name, [f.size for f in filters]):
        return longfir.stream(name, ins, filters, n, axis, side)
    _build.check_no_grad(name, ins)
    P, D, S = _STREAM_GEOM[name]
    plan = _plan(name, filters)
    nb = len(plan.plans)
    x = ins[0]
    ax, outer, n_in, inner, code = _build.axis_view(name, ins, axis)
    # filter: n + 1 - m % 2 outputs a branch; dfilt, ifilt: n // D groups
    groups = [n + 1 - odd for odd in plan.odd] if P == 1 else [n // D] * nb
    _build.check_reach(name, plan.plans, groups, D, S, n_in, side)
    _build.check_sizes(name, outer, n_in, inner, P * max(groups))
    # an analysis entry writes each branch, a sum one output
    g_out = groups if len(ins) == 1 else groups[:1]
    outs = []
    for g in g_out:
        shape = list(x.shape)
        shape[ax] = P * g
        outs.append(_output(shape, x.dtype, x.device))
    if min(groups) < 1 or outer * inner == 0:
        return outs
    size = x.element_size()
    vb = 8 if size == 2 else 16
    geo = _stream_geometry(P, outer, n_in, inner, max(groups), plan.mt,
                           size, all(t.data_ptr() % vb == 0
                                     for t in ins + outs), len(ins), nb)
    err = getattr(_build.library(), "dtcwt_" + name)(
        *(t.data_ptr() for t in ins + outs), outer, n_in, inner,
        *g_out, side or 0, int(side is None),
        plan.taps.ctypes.data, plan.lens.ctypes.data, plan.offs.ctypes.data,
        code, *geo.args(), _build.stream_ptr(x.device))
    _build.check(name, err)
    _build.count(name)
    return outs


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------

def _filter2(x, h0, h1, axis, n, side=None):
    return tuple(_launch_stream("filter2", [x], (h0, h1), n, axis, side))


def filter2_axis(x: torch.Tensor, h0, h1, axis: int):
    """Both non-decimating branch filters with the input read once:
    ``(filter(x, h0), filter(x, h1))``."""
    if _build.on_cpu(x, "filter2_axis"):
        return filter2_axis_reference(x, h0, h1, axis)
    return _filter2(x, h0, h1, axis, x.shape[axis])


def filter2_fromext_axis(ext: torch.Tensor, side: int, h0, h1, axis: int):
    """:func:`filter2_axis` on a buffer extended by *side* per side."""
    if _build.on_cpu(ext, "filter2_fromext_axis"):
        return filter2_fromext_axis_reference(ext, side, h0, h1, axis)
    return _filter2(ext, h0, h1, axis, _build.ext_len(ext, side, axis), side)


def _dfilt2(x, pair0, pair1, axis, n, side=None):
    return tuple(_launch_stream("dfilt2", [x], (*pair0, *pair1), n, axis,
                                side))


def dfilt2_axis(x: torch.Tensor, pair0, pair1, axis: int):
    """Both decimate-by-2 branch pairs with the input read once:
    ``(dfilt(x, *pair0), dfilt(x, *pair1))``.  The axis length must be a
    multiple of 4."""
    if x.shape[axis] % 4:
        raise ValueError("Length of axis %d must be a multiple of 4" % axis)
    if _build.on_cpu(x, "dfilt2_axis"):
        return dfilt2_axis_reference(x, pair0, pair1, axis)
    return _dfilt2(x, pair0, pair1, axis, x.shape[axis])


def dfilt2_fromext_axis(ext: torch.Tensor, side: int, pair0, pair1,
                        axis: int):
    """:func:`dfilt2_axis` on a buffer extended by *side* per side."""
    if _build.on_cpu(ext, "dfilt2_fromext_axis"):
        return dfilt2_fromext_axis_reference(ext, side, pair0, pair1, axis)
    return _dfilt2(ext, pair0, pair1, axis, _build.ext_len(ext, side, axis),
                   side)


def _filter2_sum(a, b, h0, h1, axis, n, side=None):
    return _launch_stream("filter2_sum", [a, b], (h0, h1), n, axis,
                          side)[0]


def _check_parity(h0, h1) -> None:
    if fb._as_taps(h0).size % 2 != fb._as_taps(h1).size % 2:
        raise ValueError("Filter length parities must match")


def filter2_sum_axis(a: torch.Tensor, b: torch.Tensor, h0, h1, axis: int):
    """One synthesis-stage branch merge: ``filter(a, h0) + filter(b, h1)``
    with the sum kept on chip.  Both filters odd or both even."""
    _check_parity(h0, h1)
    _same_inputs(a, b, "filter2_sum_axis")
    if _build.on_cpu(a, "filter2_sum_axis"):
        return filter2_sum_axis_reference(a, b, h0, h1, axis)
    return _filter2_sum(a, b, h0, h1, axis, a.shape[axis])


def filter2_sum_fromext_axis(a: torch.Tensor, b: torch.Tensor, side: int,
                             h0, h1, axis: int):
    """:func:`filter2_sum_axis` on buffers extended by *side* per side."""
    _check_parity(h0, h1)
    _same_inputs(a, b, "filter2_sum_fromext_axis")
    if _build.on_cpu(a, "filter2_sum_fromext_axis"):
        return filter2_sum_fromext_axis_reference(a, b, side, h0, h1, axis)
    return _filter2_sum(a, b, h0, h1, axis, _build.ext_len(a, side, axis),
                        side)


def _ifilt2_sum(a, b, pair0, pair1, axis, n, side=None):
    return _launch_stream("ifilt2_sum", [a, b], (*pair0, *pair1), n, axis,
                          side)[0]


def ifilt2_sum_axis(a: torch.Tensor, b: torch.Tensor, pair0, pair1,
                    axis: int):
    """One synthesis-stage branch merge: ``ifilt(a, *pair0) + ifilt(b,
    *pair1)`` with the sum kept on chip.  The axis length must be even."""
    if a.shape[axis] % 2:
        raise ValueError("Length of axis %d must be a multiple of 2" % axis)
    _same_inputs(a, b, "ifilt2_sum_axis")
    if _build.on_cpu(a, "ifilt2_sum_axis"):
        return ifilt2_sum_axis_reference(a, b, pair0, pair1, axis)
    return _ifilt2_sum(a, b, pair0, pair1, axis, a.shape[axis])


def ifilt2_sum_fromext_axis(a: torch.Tensor, b: torch.Tensor, side: int,
                            pair0, pair1, axis: int):
    """:func:`ifilt2_sum_axis` on buffers extended by *side* per side."""
    _same_inputs(a, b, "ifilt2_sum_fromext_axis")
    if _build.on_cpu(a, "ifilt2_sum_fromext_axis"):
        return ifilt2_sum_fromext_axis_reference(a, b, side, pair0, pair1,
                                                 axis)
    return _ifilt2_sum(a, b, pair0, pair1, axis, _build.ext_len(a, side, axis),
                       side)
