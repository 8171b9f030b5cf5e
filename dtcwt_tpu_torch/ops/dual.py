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
:func:`ilevel2.ifilt_streams`), so the kernels hold no parity rule: the
sums' kernel takes each branch's stream order as one swap of the two
sample parities, computed from the plans.

The analysis entries (``filter2``, ``dfilt2``) are two-branch instances of
the stream kernel of ``csrc/streams.cuh``, launched by :func:`_launch`
with the streams' taps in a device table; they take filters of up to 32
taps a stream of any length and parity.  The same stream plans with one
branch are the single-stream kernels ``dfilt`` and ``ifilt`` of
:mod:`single` (``csrc/single.cu``), which launch through :func:`_launch`
too; :mod:`single`'s ``filter`` has a kernel of its own
(``csrc/filter.cu``).  The synthesis sums (``filter2_sum``,
``ifilt2_sum``) have a kernel of their own, ``csrc/streamsum.cuh``
(filter.cu's design, two inputs summed in registers), launched by
:func:`_launch_sum`: its taps travel by value under a compile-time bound
(:func:`_sum_plan`, cached per filter set) and its tiling comes from
:func:`_sum_geometry`; the C entries refuse any other, and
``tests/test_torch_dual_tiling.py`` replays it on the CPU.  They take
filters of up to 32 taps of either parity (``filter2_sum``) and qshift
pairs of up to 64 taps (``ifilt2_sum``, four streams of up to 32).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

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
# stream kernel -> (streams P, input step per group D, tap step S): branch b
# writes Y[P g + s] = sum_k t[s][k] x[D g + c[s] + S k] from the one input;
# the branches are the plans given to _launch (two here, one in ops/single)
_GEOM = {"filter2": (1, 1, 1), "dfilt2": (2, 4, 2), "dfilt": (2, 4, 2),
         "ifilt": (4, 2, 2)}
# synthesis sum -> (streams P, D, S) of its two branches' plans
_SUM_GEOM = {"filter2_sum": (1, 1, 1), "ifilt2_sum": (4, 2, 2)}

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


def _tap_table(plans, device) -> torch.Tensor:
    """The streams' taps as the kernel's [branches][P][MAX_TAPS] float64
    table on *device*, built once per filter set and device."""
    buf = _table(plans)[0]
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


def _check_reach(name: str, plans, groups, D: int, S: int, n_in: int,
                 side) -> None:
    """From-extension mode (*side* not None): raise ValueError unless every
    read of branch b's streams ``plans[b] = (taps [P, m_b], offsets)``
    over its ``groups[b]`` groups stays inside the buffer of *n_in*."""
    if side is None:
        return
    for (taps, offs), g in zip(plans, groups):
        for off in offs:
            first = off + side
            last = first + D * (g - 1) + S * (taps.shape[1] - 1)
            if g > 0 and (first < 0 or last >= n_in):
                raise ValueError(
                    "%s: an extension of %d per side does not cover the "
                    "filters' reach" % (name, side))


def _check_sizes(name: str, outer: int, n_in: int, inner: int,
                 rows: int) -> None:
    if max(outer, n_in, inner, rows) > _INT_MAX:
        raise ValueError("%s: the axis view [%d, %d, %d] exceeds the "
                         "kernel's 32-bit sizes" % (name, outer, n_in, inner))


def _launch(name: str, ins, plans, groups, axis: int, side=None):
    """Run stream kernel *name* on the contiguous CUDA tensor ``ins[0]``
    along *axis*: branch b's streams ``plans[b] = (taps [P, m_b],
    offsets)`` write ``P * groups[b]`` samples of output b (one or two
    branches, as the kernel has).  *side*: the input is extended by that
    many samples per side (from-extension mode) instead of reflected."""
    _build.check_no_grad(name, ins)
    P, D, S = _GEOM[name]
    x = ins[0]
    ax, outer, n_in, inner, code = _axis_view(name, ins, axis)
    shape = tuple(x.shape)
    _check_reach(name, plans, groups, D, S, n_in, side)
    _check_sizes(name, outer, n_in, inner, P * max(groups))
    offs = [o + (side or 0) for _, o_b in plans for o in o_b]
    outs = []
    for g in groups:
        oshape = list(shape)
        oshape[ax] = P * g
        outs.append(torch.empty(oshape, dtype=x.dtype, device=x.device))
    if min(groups) < 1 or outer * inner == 0:
        return outs
    table = _tap_table(plans, x.device)
    lens = _build.ints_arg([taps.shape[1] for taps, _ in plans
                            for _ in range(P)])
    offs = _build.ints_arg(offs)
    fn = getattr(_build.library(), "dtcwt_" + name)
    err = fn(x.data_ptr(), outs[0].data_ptr(),
             outs[1].data_ptr() if len(outs) == 2 else None, outer, n_in,
             inner, groups[0], groups[-1], int(side is None),
             table.data_ptr(), lens.ctypes.data, offs.ctypes.data, code,
             _build.stream_ptr(x.device))
    _build.check(name, err)
    _build.count(name)
    return outs


# ---------------------------------------------------------------------------
# the synthesis sums' kernel (csrc/streamsum.cuh): plans, tiling, launch
# ---------------------------------------------------------------------------

def _inv_taps(plans, P: int, mt: int):
    """The plans' taps centred on the halo of tap bound *mt*
    (csrc/taps.cuh make_hs_taps, csrc/ipack.cuh make_ip_taps): ``(t
    [2][P][mt], sw [2])``, t[b][s][k] multiplying window sample k of stream
    s of branch b (qshift streams: of the parity ``(s & 1) ^ sw[b]``), or
    None where a stream does not fit."""
    ph = (mt - 1) // 2
    t = np.zeros((2, P, mt))
    sw = [0, 0]
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


#: Tap bounds of the sums' instances by streams P, every dtype
#: (csrc/taps.cuh st_bound): filter 5 (legall), 7 (near_sym_a), 9
#: (antonini), 19 (near_sym_b) or 33, whose halo holds 32 taps of either
#: parity; ifilt 5 (qshift_a), 7 (qshift_b), 9 (qshift_c, qshift_d), 17
#: (qshift_32) or 33, which holds qshift pairs of 64
_SUM_BOUNDS = {1: (5, 7, 9, 19, 33), 4: (5, 7, 9, 17, 33)}


def _sum_tap_bound(plans, P: int) -> int:
    """The least tap bound of the sums' instances that holds the plans."""
    for mt in _SUM_BOUNDS[P]:
        if _inv_taps(plans, P, mt) is not None:
            return mt
    raise ValueError("the stream sums' largest tap bound, %d, does not hold "
                     "these filters" % _SUM_BOUNDS[P][-1])


class _SumPlan(NamedTuple):
    """A filter set's launch arguments: the host tap table, lens and
    offsets (kept alive here across launches), the plans, the parity of
    filter2_sum's filters and the tap bound."""
    taps: np.ndarray
    lens: np.ndarray
    offs: np.ndarray
    plans: list
    odd: int
    mt: int


_SUM_PLANS = {}


def _sum_plan(name: str, filters) -> _SumPlan:
    """The launch arguments of sum *name*'s filter set (*filters*: the two
    filters, or the two pairs' four), planned once per filter set (keyed by
    the filters' values) and cached."""
    f = [fb._as_taps(v) for v in filters]
    key = (name,) + tuple(v.tobytes() for v in f)
    plan = _SUM_PLANS.get(key)
    if plan is not None:
        return plan
    P = _SUM_GEOM[name][0]
    if P == 1:
        plans = [_filter_plan(f[0]), _filter_plan(f[1])]
    else:
        plans = [ifilt_streams(*p) for p in _pairs(f[:2], f[2:])]
    taps, lens, offs = _table(plans)
    plan = _SumPlan(taps, lens, offs, plans, f[0].size % 2,
                    _sum_tap_bound(plans, P))
    if len(_SUM_PLANS) >= 64:
        _SUM_PLANS.clear()
    _SUM_PLANS[key] = plan
    return plan


_THREADS = 256          # csrc/streamtile.cuh ST_THREADS
# columns path, by itemsize: threads across inner at most (a block of 64
# spans four group rows, whose windows overlap in L1; float64 runs faster
# on rows of 256 threads)
_COL_TX = {2: 64, 4: 64, 8: 256}
_COL_GROUPS = {1: 8, 4: 4}   # st_col_groups: groups a columns-path thread
# columns path: a grid of fewer blocks than this (under one an SM of the
# H100's 132) takes one column a thread, 2-4 times the blocks
_FEW_BLOCKS = 128
_STAGE_BYTES = 16384    # an input a rows-path block stages


class SumGeometry(NamedTuple):
    """The tiling of one sum launch (``csrc/streamsum.cuh``), over the
    output groups (filter: an output; ifilt: four, one of each stream).

    *path* ``"rows"`` (``inner = 1``): block ``b`` takes segment ``b %
    grid[1]`` (groups ``[s * seg, s * seg + seg)``) of the *rows* outer
    rows from ``(b // grid[1]) * rows``, each input's flat range staged in
    a region of *smem* / 2 bytes; its threads take items of *v*
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
def _sum_geometry(P: int, outer: int, n_in: int, inner: int, g: int,
                  mt: int, itemsize: int, aligned: bool) -> SumGeometry:
    """The tiling of a sum with *P* streams a branch (1: filter2_sum, 4:
    ifilt2_sum) on two ``[outer, n_in, inner]`` inputs into ``[outer, P
    g, inner]`` at tap bound *mt*, for elements of *itemsize* bytes;
    *aligned*: the inputs and the output start on a column vector (16
    bytes, bfloat16 8).  Rows path for ``inner = 1``; else the columns
    path, a thread owning a column vector where inner and *aligned* allow
    it and the grid keeps ``_FEW_BLOCKS`` blocks, one column otherwise.
    Cached: the transforms ask for the same tiling at every call."""
    D = 1 if P == 1 else 2
    vec = 16 // itemsize
    if inner == 1:
        # several whole rows of a short axis, or segments of a long one
        gv = vec if P == 1 else max(1, vec // 4)
        tgt = _STAGE_BYTES // itemsize
        if n_in <= tgt:
            seg, rows = _cdiv(g, gv) * gv, max(1, min(outer, tgt // n_in))
        else:
            seg, rows = tgt // D, 1
        region = _cdiv(vec + (rows - 1) * n_in
                       + min(n_in, D * (seg + mt - 1)), vec) * vec
        return SumGeometry("rows", mt, gv, 1, rows, seg, 1,
                           (_cdiv(outer, rows), _cdiv(g, seg)),
                           2 * region * itemsize)
    rv = _COL_GROUPS[P]

    def cols(vc):
        tx = min(_COL_TX[itemsize],
                 1 << (_cdiv(inner, vc) - 1).bit_length())
        seg = _THREADS // tx * rv
        return SumGeometry("cols", mt, rv, vc, 1, seg, tx,
                           (outer, _cdiv(g, seg), _cdiv(inner, tx * vc)), 0)
    vc = 2 if itemsize == 8 else 4
    if inner % vc or not aligned:
        vc = 1
    geo = cols(vc)
    return cols(1) if vc > 1 and geo.blocks < _FEW_BLOCKS else geo


def _sum_output(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def _launch_sum(name: str, a: torch.Tensor, b: torch.Tensor, filters,
                axis: int, n: int, side=None) -> torch.Tensor:
    """Run sum *name* (``filter2_sum``: *filters* the two filters;
    ``ifilt2_sum``: the two pairs' four) on the contiguous CUDA tensors
    *a*, *b* along *axis* whose signal has *n* samples; *side*: the
    inputs are extended by that many samples per side (from-extension
    mode) instead of reflected."""
    _build.check_no_grad(name, (a, b))
    P, D, S = _SUM_GEOM[name]
    plan = _sum_plan(name, filters)
    ax, outer, n_in, inner, code = _axis_view(name, [a, b], axis)
    g = n + 1 - plan.odd if P == 1 else n // 2
    _check_reach(name, plan.plans, [g, g], D, S, n_in, side)
    _check_sizes(name, outer, n_in, inner, P * g)
    shape = list(a.shape)
    shape[ax] = P * g
    y = _sum_output(shape, a.dtype, a.device)
    if g < 1 or outer * inner == 0:
        return y
    size = a.element_size()
    vb = 8 if size == 2 else 16
    geo = _sum_geometry(P, outer, n_in, inner, g, plan.mt, size,
                        all(t.data_ptr() % vb == 0 for t in (a, b, y)))
    err = getattr(_build.library(), "dtcwt_" + name)(
        a.data_ptr(), b.data_ptr(), y.data_ptr(), outer, n_in, inner, g,
        side or 0, int(side is None), plan.taps.ctypes.data,
        plan.lens.ctypes.data, plan.offs.ctypes.data, code, *geo.args(),
        _build.stream_ptr(a.device))
    _build.check(name, err)
    _build.count(name)
    return y


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
    return _launch_sum("filter2_sum", a, b, (h0, h1), axis, n, side)


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
    return _launch_sum("ifilt2_sum", a, b, (*pair0, *pair1), axis, n, side)


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
