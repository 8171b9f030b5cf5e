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
whose indices would overflow the kernel's ints.  The host pads each
stream's taps into chunks of the kernel's (:func:`_plan`, once per filter
set) and chooses the path and the tiling (:func:`_geometry`, cached per
launch shape); the C entry refuses any other.
"""

from __future__ import annotations

import functools
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
_THREADS = 256          # csrc/longfir.cu LF_THREADS
_MT = 8                 # LF_MT: taps a chunk
_SMEM_MAX = 227 * 1024  # LF_SMEM_MAX
#: Rows path: the most halo samples one staging round holds (chunks of
#: taps a round: 32 for filter, 16 for the qshift streams); a longer
#: filter is staged again for each round of chunks, double-buffered.
_HALO = 256
#: Rows path: short whole rows a block are halved until their staged
#: windows fit this many bytes.
_SMEM_BUDGET = 96 * 1024


class _Plan(NamedTuple):
    """A filter set's streams: the plans (a branch each), each branch's
    filter parity (P = 1), the kernel's tap table (a row of ``chunks``
    chunks of :data:`_MT` taps a slot, float64) and the ints base0, base1,
    sw0, sw1, chunks of its launches."""
    plans: list
    odd: tuple
    table: np.ndarray
    ints: tuple


_PLANS = {}
_DEVICE_TAPS = {}


def _slots(taps, offs, base, P, S):
    """Branch (*taps*, *offs*) on a window from sample offset *base*: its
    swap sw and, slot by slot, (tap shift e, taps).  Slot sigma reads the
    window's phase sigma & 1 (S = 2) and holds stream sigma ^ sw; a
    stream's taps start e window steps in."""
    sw = (offs[0] - base) % S
    slots = []
    for sigma in range(P):
        s = sigma ^ sw if P > 1 else 0
        d = offs[s] - base
        if d < 0 or d % S != (sigma & 1 if S == 2 else 0):
            raise ValueError("a stream plan the long-filter kernel does not "
                             "take: offsets %s" % (tuple(offs),))
        slots.append((d // S, taps[s]))
    return sw, slots


def _plan(name: str, filters) -> _Plan:
    """The streams of entry *name*'s filter set (*filters*: a filter a
    branch for P = 1, else a pair a branch, flat), planned once per filter
    set and cached.  The analysis form's branches share one window (its
    input); the sum form's take a window an input, branch 1's moved a
    sample where that makes its swap branch 0's (their streams sum)."""
    f = [fb._as_taps(v) for v in filters]
    key = (name,) + tuple(v.tobytes() for v in f)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    P = STREAMS[name]
    S = _OPS[P][2]
    if P == 1:
        plans = [fb.filter_streams(h) for h in f]
    else:
        streams = fb.dfilt_streams if P == 2 else fb.ifilt_streams
        plans = []
        for ha, hb in zip(f[::2], f[1::2]):
            fb._check_pair(ha, hb)
            plans.append(streams(ha, hb))
    if name.endswith("_sum"):
        bases = [min(o) for _, o in plans]
        if (plans[1][1][0] - bases[1]) % S != (plans[0][1][0] - bases[0]) % S:
            bases[1] -= 1
    else:
        bases = [min(min(o) for _, o in plans)] * len(plans)
    sws, slots = [], []
    for (taps, offs), base in zip(plans, bases):
        sw, sl = _slots(taps, offs, base, P, S)
        sws.append(sw)
        slots += sl
    chunks = -(-max(e + t.size for e, t in slots) // _MT)
    table = np.zeros((len(slots), chunks * _MT))
    for row, (e, t) in zip(table, slots):
        row[e:e + t.size] = t
    plan = _Plan(plans, tuple(h.size % 2 for h in f) if P == 1 else (),
                 table, (bases[0], bases[-1], sws[0], sws[-1], chunks))
    if len(_PLANS) >= 64:
        _PLANS.clear()
        _DEVICE_TAPS.clear()
    _PLANS[key] = plan
    return plan


def _device_taps(plan: _Plan, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """The plan's tap table on *device* in the kernel's accumulator type
    (float64 for float64, else float32), copied there once per filter
    set."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    key = (id(plan), acc, device)
    t = _DEVICE_TAPS.get(key)
    if t is None:
        t = torch.as_tensor(plan.table, dtype=acc, device=device)
        _DEVICE_TAPS[key] = t
    return t


#: Rows path: groups a thread by (streams P, a float64 accumulator)
#: (csrc/longfir.cu lf_row_groups)
_ROW_GROUPS = {(1, False): 12, (2, False): 3, (4, False): 6,
               (1, True): 6, (2, True): 3, (4, True): 3}


class _Tile(NamedTuple):
    """A launch's tiling (the C entry's ``tile``): mt, path (0 rows, 1
    columns), groups a thread, columns a thread, threads across inner,
    outer rows a block, groups a block, chunks a staging round, dynamic
    shared memory in bytes; and the grid's blocks."""
    mt: int
    path: int
    v: int
    vc: int
    tx: int
    rows: int
    seg: int
    cr: int
    smem: int
    blocks: int


@functools.lru_cache(maxsize=256)
def _geometry(P: int, nb: int, nin: int, outer: int, n_in: int, inner: int,
              gn: int, chunks: int, itemsize: int, vec_ok: bool) -> _Tile:
    """The tiling of a launch of *P* streams, *nb* branches and *nin*
    inputs on the view [outer, n_in, inner] with *gn* groups a row and
    *chunks* chunks of taps; *itemsize*: the storage type's bytes (8:
    float64, whose accumulator is wide); *vec_ok*: every pointer 16-byte
    aligned.

    Columns (inner > 1): a 16-byte vector of columns a thread (8 bytes of
    bfloat16) where inner and the pointers allow, else one; 128 bytes of a
    row across a warp's row of threads; 8 accumulators a column (RV =
    8 / slots groups).  Rows (inner = 1): GV groups a thread, at most one
    item of GV groups a thread: segments of up to 256 items of a row, or
    whole rows, several to a block where they are short; a staging round
    holds at most :data:`_HALO` halo samples, two rounds' buffers where a
    filter needs more than one."""
    D, S = _OPS[P][1], _OPS[P][2]
    slots = P if nin == 2 else P * nb
    wide = itemsize == 8
    if inner > 1:
        vec = 2 if wide else 4
        vc = vec if vec_ok and inner % vec == 0 else 1
        rv = 8 // slots
        tx = min(128 // (vc * itemsize),
                 1 << (-(-inner // vc) - 1).bit_length())
        seg = (_THREADS // tx) * rv
        blocks = outer * -(-gn // seg) * -(-inner // (tx * vc))
        return _Tile(_MT, 1, rv, vc, tx, 1, seg, chunks, 0, blocks)
    gv = _ROW_GROUPS[P, wide]
    asize, V = (8, 2) if wide else (4, 4)
    items = -(-gn // gv)
    n_seg = -(-items // _THREADS)
    seg = -(-items // n_seg) * gv
    rows = 1 if n_seg > 1 else max(1, min(outer, _THREADS // items))
    cr = min(chunks, _HALO // (S * _MT))
    bufs = 2 if cr < chunks else 1
    wp = -(-(D * (seg - 1) + S * _MT * cr + V - 1) // V) * V
    while rows > 1 and bufs * nin * rows * wp * asize > _SMEM_BUDGET:
        rows = max(1, rows // 2)
    smem = bufs * nin * rows * wp * asize
    if smem > _SMEM_MAX:
        raise ValueError("the long-filter kernel's window of %d samples "
                         "exceeds a block's shared memory" % wp)
    return _Tile(_MT, 0, gv, 1, 1, rows, seg, cr, smem,
                 -(-outer // rows) * n_seg)


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
    reach = (max(abs(b) for b in plan.ints[:2]) + S * plan.table.shape[1]
             + (side or 0))
    if (2 * n_in + D * max(groups) + reach > _build.INT_MAX
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
    ptrs = [t.data_ptr() for t in list(ins) + outs]
    tile = _geometry(P, nb, len(ins), outer, n_in, inner, max(groups),
                     plan.ints[4], x.element_size(),
                     all(p % 16 == 0 for p in ptrs))
    if tile.blocks > _build.INT_MAX:
        raise ValueError("%s: the axis view [%d, %d, %d] needs more blocks "
                         "than a grid holds" % (name, outer, n_in, inner))
    taps = _device_taps(plan, x.dtype, x.device)
    meta = _build.ints_arg((P, nb, groups[0], groups[-1]) + plan.ints)
    tiles = _build.ints_arg(tile[:9])
    y = [t.data_ptr() for t in outs] + [None]
    err = _build.library().dtcwt_longfir(
        ins[0].data_ptr(), ins[1].data_ptr() if len(ins) == 2 else None,
        y[0], y[1], outer, n_in, inner, int(len(ins) == 2), side or 0,
        int(side is None), taps.data_ptr(), meta.ctypes.data,
        tiles.ctypes.data, code, _build.stream_ptr(x.device))
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
