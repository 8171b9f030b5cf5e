"""The two-sided (H, W) stage-pair kernels of the 3-D DTCWT: CUDA kernels
and their plain versions.

Replaces the Pallas kernels of ``dtcwt_tpu/ops/pallas_hw.py``:

===================  ===================================  ==================
entry                computes, per ``[H, W]`` slice       Pallas builder
===================  ===================================  ==================
``filter_hw22``      ``u[j][k] = F_H(h_j) F_W(h_k) x``    ``_build_hw22``
``dfilt_hw22``       the same, decimating pairs           ``_build_hw22``
``filter_sum_hw22``  ``sum_jk F_H(g_j) F_W(g_k) v_jk``    ``_build_sum_hw22``
``ifilt_sum_hw22``   the same, interpolating pairs        ``_build_sum_hw22``
===================  ===================================  ==================

``F_A(f)`` is the filter *f* along axis A: a non-decimating odd-length
filter (``filter_*``: the output keeps its size), a decimating qshift pair
(``dfilt_hw22``: H/2 x W/2) or an interpolating one (``ifilt_sum_hw22``: 2H
x 2W).  The analysis entries return ``[[u00, u01], [u10, u11]]``, each
``[..., HO, WO]``, as the JAX entries do.  The contracts are the JAX
package's: odd-length filters for ``filter_*``, four pair filters of one
even length for the others, H and W multiples of 4 (``dfilt_hw22``) or 2
(``ifilt_sum_hw22``); any other H and W, the Pallas envelope's 512 cap and
lane multiples gone.

Each entry ``f`` has ``f_reference``, its plain version: :mod:`fb`'s dual
forms along W, then along H, computed at float32 for bfloat16 storage.  An
entry takes its route from the input's device: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel (``csrc/hw.cu``) or raises.  The
analysis kernel is ``csrc/hwana.cuh``'s, the synthesis kernel
``csrc/hwsum.cuh``'s: one design run both ways on the pieces of
``csrc/hwtile.cuh``.  Their tiles and tap bounds come from
:func:`_hw22_geometry` / :func:`_hw22_tap_bound` and
:func:`_sum_hw22_geometry` / :func:`_sum_tap_bound`, the C entries refuse
any other, and ``tests/test_torch_hw_tiling.py`` replays both on the CPU.
The kernels take float32, bfloat16 and float64, and filters of up to 32
taps a stream: odd filters of up to 31 taps, qshift pairs of up to 32
(``dfilt_hw22``) and 64 (``ifilt_sum_hw22``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from dtcwt_tpu_torch.ops import _build, dual, fb
from dtcwt_tpu_torch.ops.ilevel2 import ifilt_streams
from dtcwt_tpu_torch.ops.level2 import dfilt_streams
from dtcwt_tpu_torch.ops.dual import _inv_taps, _table
from dtcwt_tpu_torch.ops.pack3d import _SMEM_MAX, _filter_plans
from dtcwt_tpu_torch.utils import compute_view

__all__ = ["filter_hw22", "dfilt_hw22", "filter_sum_hw22", "ifilt_sum_hw22",
           "filter_hw22_reference", "dfilt_hw22_reference",
           "filter_sum_hw22_reference", "ifilt_sum_hw22_reference"]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _split22(x, split):
    """``[[u00, u01], [u10, u11]]``: *split(v, axis)* (a dual form) along W
    (branch k), then along H (branch j)."""
    out = [[None, None], [None, None]]
    for k, t in enumerate(split(compute_view(x), -1)):
        for j, u in enumerate(split(t, -2)):
            out[j][k] = u.to(x.dtype)
    return out


def _merge22(vs, merge):
    """``sum_jk F_H(j) F_W(k) v[j][k]``: *merge(a, b, axis)* (a dual sum
    form) along W for each H branch, then along H."""
    v = [compute_view(t) for t in vs]
    return merge(merge(v[0], v[1], -1), merge(v[2], v[3], -1), -2).to(
        vs[0].dtype)


def filter_hw22_reference(x: torch.Tensor, h0, h1):
    """Plain version of :func:`filter_hw22`."""
    return _split22(x, lambda v, ax: fb.filter2_axis(v, h0, h1, ax))


def dfilt_hw22_reference(x: torch.Tensor, pair0, pair1):
    """Plain version of :func:`dfilt_hw22`."""
    return _split22(x, lambda v, ax: fb.dfilt2_axis(v, pair0, pair1, ax))


def filter_sum_hw22_reference(v00, v01, v10, v11, g0, g1):
    """Plain version of :func:`filter_sum_hw22`."""
    return _merge22((v00, v01, v10, v11),
                    lambda a, b, ax: fb.filter2_sum_axis(a, b, g0, g1, ax))


def ifilt_sum_hw22_reference(v00, v01, v10, v11, pair0, pair1):
    """Plain version of :func:`ifilt_sum_hw22`."""
    return _merge22((v00, v01, v10, v11),
                    lambda a, b, ax: fb.ifilt2_sum_axis(a, b, pair0, pair1,
                                                        ax))


# ---------------------------------------------------------------------------
# checks and the launch
# ---------------------------------------------------------------------------

def _slices(vs, name: str, mult: int):
    """Check the inputs ``[..., H, W]`` (one shape, dtype and device, H and
    W multiples of *mult*); return (H, W)."""
    x = vs[0]
    if x.ndim < 2 or not x.is_floating_point():
        raise ValueError("%s needs floating [..., H, W] inputs, got %s %s"
                         % (name, x.dtype, tuple(x.shape)))
    for v in vs[1:]:
        if v.shape != x.shape or v.dtype != x.dtype or v.device != x.device:
            raise ValueError("%s: the four inputs must share one shape, dtype"
                             " and device" % name)
    H, W = x.shape[-2:]
    if H % mult or W % mult or min(H, W) < 1:
        raise ValueError("%s needs H and W multiples of %d, got %s"
                         % (name, mult, tuple(x.shape)))
    return H, W


def _odd(h0, h1, name: str):
    h0, h1 = fb._as_taps(h0), fb._as_taps(h1)
    if h0.size % 2 == 0 or h1.size % 2 == 0:
        raise ValueError("%s takes odd-length filters, got %d and %d taps"
                         % (name, h0.size, h1.size))
    return h0, h1


def _equal_pairs(pair0, pair1, name: str):
    pairs = dual._pairs(pair0, pair1)
    if pairs[0][0].size != pairs[1][0].size:
        raise ValueError("%s takes two pairs of one length, got %d and %d"
                         % (name, pairs[0][0].size, pairs[1][0].size))
    return pairs


def _outputs(n_out: int, N: int, Ho: int, Wo: int, dtype, device):
    """The kernels' outputs, *n_out* of ``[N, Ho, Wo]``."""
    return [torch.empty((N, Ho, Wo), dtype=dtype, device=device)
            for _ in range(n_out)]


def _launch(name: str, ins, Ho: int, Wo: int, n_out: int, args):
    """Run kernel *name* on the [..., H, W] tensors *ins* (one for
    analysis, four for synthesis); *args()*, called where there is work,
    gives the host tap table (taps, lens, offs) and the ints the C entry
    takes after the dtype (the kernel's tile).  Returns
    *n_out* outputs [..., Ho, Wo]."""
    _build.check_no_grad(name, ins)
    x = ins[0]
    lead, (H, W) = tuple(x.shape[:-2]), tuple(x.shape[-2:])
    N = int(np.prod(lead, dtype=np.int64))
    if max(N, H, W, Ho, Wo) > dual._INT_MAX:
        raise ValueError("%s: [%d, %d, %d] exceeds the kernel's 32-bit sizes"
                         % (name, N, H, W))
    code = _build.dtype_code(x.dtype)
    flat = [t.reshape((N, H, W)).contiguous() for t in ins]
    outs = _outputs(n_out, N, Ho, Wo, x.dtype, x.device)
    if N:
        (taps, lens, offs), tile = args()
        ptrs = ([t.data_ptr() for t in flat] + [None] * (4 - len(flat))
                + [o.data_ptr() for o in outs])
        fn = getattr(_build.library(), "dtcwt_" + name)
        err = fn(*ptrs, N, H, W, Ho, Wo, taps.ctypes.data, lens.ctypes.data,
                 offs.ctypes.data, code, *tile, _build.stream_ptr(x.device))
        _build.check(name, err)
        _build.count(name)
    return [o.reshape(lead + (Ho, Wo)) for o in outs]


# ---------------------------------------------------------------------------
# the kernels' tilings (csrc/hwana.cuh, csrc/hwsum.cuh; their shared pieces
# csrc/hwtile.cuh)
# ---------------------------------------------------------------------------

_TILE = 32                     # csrc/hwtile.cuh HS_TILE
#: Streams a stage of each entry (csrc/hw.cu)
_STREAMS = {"filter_hw22": 1, "dfilt_hw22": 2, "filter_sum_hw22": 1,
            "ifilt_sum_hw22": 4}
#: Tap bounds of the synthesis instances by streams a stage, every dtype
#: (csrc/hwtile.cuh hs_bound): the largest holds odd filters of 31 taps and
#: qshift pairs of 64
_SUM_BOUNDS = {1: (5, 7, 9, 19, 31), 4: (5, 7, 9, 17, 33)}
#: Tap bounds of the analysis instances, every dtype (hs_bound): filter the
#: synthesis's; dfilt a stream's window in half samples, the largest
#: holding qshift pairs of 32 (two streams of 32 taps at stride 2)
_HW_BOUNDS = {1: _SUM_BOUNDS[1], 2: (10, 14, 16, 18, 32)}


def _least_bound(plans, P: int, bounds, what: str) -> int:
    """The least of *bounds* that holds the plans (the taps centred on its
    halo, csrc/taps.cuh make_hs_taps, as :func:`dual._inv_taps`
    centres them)."""
    for mt in bounds:
        if _inv_taps(plans, P, mt) is not None:
            return mt
    raise ValueError("the hw %s kernel's largest tap bound, %d, does not "
                     "hold these filters" % (what, bounds[-1]))


def _sum_tap_bound(plans, P: int) -> int:
    """The least tap bound of the synthesis instances that holds the plans:
    filter 5 (legall), 7 (near_sym_a), 9 (antonini), 19 (near_sym_b) or 31;
    ifilt 5 (qshift_a), 7 (qshift_b), 9 (qshift_c, qshift_d), 17
    (qshift_32) or 33."""
    return _least_bound(plans, P, _SUM_BOUNDS[P], "synthesis")


def _hw22_tap_bound(plans, P: int) -> int:
    """The least tap bound of the analysis instances that holds the plans:
    filter 5 (legall), 7 (near_sym_a), 9 (antonini), 19 (near_sym_b) or
    31; dfilt a stream's length, 10 (qshift_06, qshift_a), 14 (qshift_b),
    16 (qshift_c), 18 (qshift_d) or 32 (qshift_32)."""
    return _least_bound(plans, P, _HW_BOUNDS[P], "analysis")


class Hw22Geometry(NamedTuple):
    """The tile of an analysis kernel (csrc/hwana.cuh HaGeo): oh x ow
    output samples of each of the four outputs, 256 threads a block, a
    block for each tile of each slice; the tap bound mt and its halo ph
    (window steps); the staged area xr x xc (square) of the one input from
    so samples before the tile's first input row and column (the halo
    P ph rounded up to 4, so that it starts 16 bytes aligned and even),
    its windows starting dl = so - P ph in; xs the staged row stride
    (dfilt's padded to 4 (mod 8) values); ns the samples a window of 4
    outputs reads from dl on (filter mt + 3, dfilt 2 mt + 4) and nw the W
    stage's window in 16-byte vectors; cw the values a staging chunk (f32
    and bf16 4, f64 2) and smem the dynamic shared memory bytes (the
    staged image [xr][xs], the W stage's two [xr][ow], the int row and
    column maps)."""
    oh: int
    ow: int
    mt: int
    ph: int
    so: int
    dl: int
    xr: int
    xc: int
    xs: int
    ns: int
    nw: int
    cw: int
    smem: int

    def tile(self):
        """The ints the C entry takes: oh, ow, mt, xr, xc, smem."""
        return self.oh, self.ow, self.mt, self.xr, self.xc, self.smem


@functools.lru_cache(maxsize=None)
def _hw22_geometry(P: int, mt: int, dtype: torch.dtype) -> Hw22Geometry:
    """The tile of an analysis kernel with *P* streams a stage (1: filter,
    2: dfilt) and tap bound *mt* (:func:`_hw22_tap_bound`) in *dtype*: 32 x
    32 output samples from a staged area of P 32 input samples and so each
    side.  At the main path's bounds in float32 its shared memory (17 KB
    for filter at 7, 47 KB for dfilt at 10) leaves an SM eight and four
    blocks; float64 at the largest bounds fits.  Cached: the sharded
    transform asks for the same tile at every call."""
    acc = 8 if dtype == torch.float64 else 4
    ph = (mt - 1) // 2
    so = (P * ph + 3) // 4 * 4
    dl = so - P * ph
    x = P * _TILE + 2 * so
    xs = x if P == 1 or x % 8 == 4 else x + 4
    vv = 16 // acc
    ns = mt + 3 if P == 1 else 2 * mt + 4
    nw = -(-(dl + ns) // vv) * vv
    smem = acc * (x * xs + 2 * x * _TILE) + 4 * 2 * x
    return Hw22Geometry(_TILE, _TILE, mt, ph, so, dl, x, x, xs, ns, nw, vv,
                        smem)


class SumHw22Geometry(NamedTuple):
    """The tile of a synthesis kernel (csrc/hwsum.cuh HsGeo): oh x ow output
    samples, 256 threads a block, a block for each tile of each slice; the
    tap bound mt and its halo ph; the staged area xr x xc (square) from
    so samples before the tile's first input row and column (filter: the
    tile's first; ifilt: half of it), so = ph rounded up to 4 for filter
    (its windows then start dl = so - ph in), 2 ph for ifilt (dl 0); xh
    the parity half of an ifilt staged row (0 for filter) and xs the staged
    row stride; cw the values a chunk of the filter's staging (f32 and bf16
    4, f64 2; 0 for ifilt, a value an item); rounds of staging (1: the four
    inputs together; 2: two a round, where four do not fit) and smem the
    dynamic shared memory bytes (4 / rounds staged images [xr][xs], the W
    stage's two [xr][ow], the int row and column maps)."""
    oh: int
    ow: int
    mt: int
    ph: int
    so: int
    dl: int
    xr: int
    xc: int
    xh: int
    xs: int
    cw: int
    rounds: int
    smem: int

    def tile(self):
        """The ints the C entry takes: oh, ow, mt, xr, xc, smem."""
        return self.oh, self.ow, self.mt, self.xr, self.xc, self.smem


@functools.lru_cache(maxsize=None)
def _sum_hw22_geometry(P: int, mt: int,
                       dtype: torch.dtype) -> SumHw22Geometry:
    """The tile of a synthesis kernel with *P* streams a stage (1: filter,
    4: ifilt) and tap bound *mt* (:func:`_sum_tap_bound`) in *dtype*: 32 x
    32 output samples.  At the main path's bounds in float32 its shared
    memory (36 KB for filter at 7, 16 KB for ifilt at 5) leaves an SM six
    and eight blocks; float64 at the largest bounds fits, ifilt in two
    rounds.  Cached: the sharded transform asks for the same tile at every
    call."""
    acc = 8 if dtype == torch.float64 else 4
    ph = (mt - 1) // 2
    if P == 1:
        so = (ph + 3) // 4 * 4
        dl, xh, cw = so - ph, 0, 16 // acc
        xr = xs = _TILE + 2 * so
    else:
        so, dl, cw = 2 * ph, 0, 0
        xr = _TILE // 2 + 2 * mt - 2
        xh = (xr // 2 + 3) // 8 * 8 + 4
        xs = 2 * xh

    def smem_of(images):
        return acc * (images * xr * xs + 2 * xr * _TILE) + 4 * 2 * xr
    rounds = 1 if smem_of(4) <= _SMEM_MAX else 2
    return SumHw22Geometry(_TILE, _TILE, mt, ph, so, dl, xr, xr, xh, xs, cw,
                           rounds, smem_of(4 // rounds))


class _Plan(NamedTuple):
    """A filter set's kernel arguments: the host tap table, lens and offsets
    (kept alive here across launches), the plans and the tap bound."""
    taps: np.ndarray
    lens: np.ndarray
    offs: np.ndarray
    plans: list
    mt: int


_PLANS = {}


def _plan(name: str, filters) -> _Plan:
    """The kernel arguments of entry *name*'s filter set (*filters*: the two
    odd filters, or the two pairs' four filters), planned once per filter
    set (keyed by the filters' values) and cached."""
    f = [np.asarray(v, np.float64).reshape(-1) for v in filters]
    key = (name,) + tuple(v.tobytes() for v in f)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    P = _STREAMS[name]
    streams = {2: dfilt_streams, 4: ifilt_streams}.get(P)
    plans = (_filter_plans(f[0], f[1]) if P == 1 else
             [streams(f[0], f[1]), streams(f[2], f[3])])
    taps, lens, offs = _table(plans)
    bound = _sum_tap_bound if "sum" in name else _hw22_tap_bound
    plan = _Plan(taps, lens, offs, plans, bound(plans, P))
    if len(_PLANS) >= 64:
        _PLANS.clear()
    _PLANS[key] = plan
    return plan


#: the synthesis entries' plans (the name their tests know)
_sum_plan = _plan


def _args(name: str, filters, dtype: torch.dtype):
    """A launch's arguments (:func:`_launch` *args*): the cached tap table
    and the tile of :func:`_hw22_geometry` or :func:`_sum_hw22_geometry`
    for *dtype* at the plan's tap bound."""
    plan = _plan(name, filters)
    geometry = _sum_hw22_geometry if "sum" in name else _hw22_geometry
    geo = geometry(_STREAMS[name], plan.mt, dtype)
    return (plan.taps, plan.lens, plan.offs), geo.tile()


def _nest(u):
    return [[u[0], u[1]], [u[2], u[3]]]


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------

def filter_hw22(x: torch.Tensor, h0, h1):
    """Both non-decimating branch filters along H and W in one pass:
    ``u[j][k] = filter_H(filter_W(x, h_k), h_j)``, each ``[..., H, W]``."""
    H, W = _slices([x], "filter_hw22", 1)
    h0, h1 = _odd(h0, h1, "filter_hw22")
    if dual._on_cpu(x, "filter_hw22"):
        return filter_hw22_reference(x, h0, h1)
    return _nest(_launch("filter_hw22", [x], H, W, 4, lambda: _args(
        "filter_hw22", (h0, h1), x.dtype)))


def dfilt_hw22(x: torch.Tensor, pair0, pair1):
    """Both decimate-by-2 branch pairs along H and W in one pass:
    ``u[j][k] = dfilt_H(dfilt_W(x, *pair_k), *pair_j)``, each
    ``[..., H/2, W/2]``."""
    H, W = _slices([x], "dfilt_hw22", 4)
    pairs = _equal_pairs(pair0, pair1, "dfilt_hw22")
    if dual._on_cpu(x, "dfilt_hw22"):
        return dfilt_hw22_reference(x, pair0, pair1)
    return _nest(_launch("dfilt_hw22", [x], H // 2, W // 2, 4, lambda: _args(
        "dfilt_hw22", pairs[0] + pairs[1], x.dtype)))


def filter_sum_hw22(v00, v01, v10, v11, g0, g1):
    """One synthesis (H, W) stage pair: ``sum_jk filter_H(filter_W(v[j][k],
    g_k), g_j)``, ``[..., H, W]``."""
    vs = [v00, v01, v10, v11]
    H, W = _slices(vs, "filter_sum_hw22", 1)
    g0, g1 = _odd(g0, g1, "filter_sum_hw22")
    if dual._on_cpu(v00, "filter_sum_hw22"):
        return filter_sum_hw22_reference(*vs, g0, g1)
    return _launch("filter_sum_hw22", vs, H, W, 1, lambda: _args(
        "filter_sum_hw22", (g0, g1), v00.dtype))[0]


def ifilt_sum_hw22(v00, v01, v10, v11, pair0, pair1):
    """One synthesis (H, W) stage pair with interpolate-by-2: ``sum_jk
    ifilt_H(ifilt_W(v[j][k], *pair_k), *pair_j)``, ``[..., 2H, 2W]``."""
    vs = [v00, v01, v10, v11]
    H, W = _slices(vs, "ifilt_sum_hw22", 2)
    pairs = _equal_pairs(pair0, pair1, "ifilt_sum_hw22")
    if dual._on_cpu(v00, "ifilt_sum_hw22"):
        return ifilt_sum_hw22_reference(*vs, pair0, pair1)
    return _launch("ifilt_sum_hw22", vs, 2 * H, 2 * W, 1, lambda: _args(
        "ifilt_sum_hw22", pairs[0] + pairs[1], v00.dtype))[0]
