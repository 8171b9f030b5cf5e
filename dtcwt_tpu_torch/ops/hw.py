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
analysis kernel is the (H, W) stage pair of ``csrc/pack3d.cu``'s analysis
without the pack, on the same host plans.  The synthesis kernel is
``csrc/hwsum.cuh``'s: its tile and tap bound come from
:func:`_sum_hw22_geometry` and :func:`_sum_tap_bound`, the C entry refuses
any other, and ``tests/test_torch_hw_tiling.py`` replays it on the CPU.
The kernels take float32, bfloat16 and float64, and filters of up to 32
taps a stream: odd filters of up to 31 taps, qshift pairs of up to 64.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from dtcwt_tpu_torch.ops import _build, dual, fb
from dtcwt_tpu_torch.ops.ilevel2 import ifilt_streams
from dtcwt_tpu_torch.ops.level2 import dfilt_streams
from dtcwt_tpu_torch.ops.pack3d import (_SMEM_MAX, _filter_plans, _inv_taps,
                                        _table)
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
    takes after the dtype (the synthesis tile; none for analysis).  Returns
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
# the synthesis kernel's tiling (csrc/hwsum.cuh)
# ---------------------------------------------------------------------------

_TILE = 32                     # csrc/hwsum.cuh HS_TILE
#: Streams a stage of each synthesis entry (csrc/hw.cu)
_SUM_P = {"filter_sum_hw22": 1, "ifilt_sum_hw22": 4}
#: Tap bounds of the synthesis instances by streams a stage, every dtype
#: (csrc/hwsum.cuh hs_bound): the largest holds odd filters of 31 taps and
#: qshift pairs of 64
_SUM_BOUNDS = {1: (5, 7, 9, 19, 31), 4: (5, 7, 9, 17, 33)}


def _sum_tap_bound(plans, P: int) -> int:
    """The least tap bound of the synthesis instances that holds the plans
    (the taps centred on its halo, csrc/hwsum.cuh make_hs_taps, as
    :func:`pack3d._inv_taps` centres them): filter 5 (legall), 7
    (near_sym_a), 9 (antonini), 19 (near_sym_b) or 31; ifilt 5 (qshift_a),
    7 (qshift_b), 9 (qshift_c, qshift_d), 17 (qshift_32) or 33."""
    for mt in _SUM_BOUNDS[P]:
        if _inv_taps(plans, P, mt) is not None:
            return mt
    raise ValueError("the hw synthesis kernel's largest tap bound, %d, does "
                     "not hold these filters" % _SUM_BOUNDS[P][-1])


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


class _SumPlan(NamedTuple):
    """A synthesis filter set's kernel arguments: the host tap table, lens
    and offsets (kept alive here across launches), the plans and the tap
    bound."""
    taps: np.ndarray
    lens: np.ndarray
    offs: np.ndarray
    plans: list
    mt: int


_SUM_PLANS = {}


def _sum_plan(name: str, filters) -> _SumPlan:
    """The kernel arguments of a synthesis filter set (*filters*: g0, g1 or
    the two pairs' four filters), planned once per filter set (keyed by the
    filters' values) and cached."""
    f = [np.asarray(v, np.float64).reshape(-1) for v in filters]
    key = (name,) + tuple(v.tobytes() for v in f)
    plan = _SUM_PLANS.get(key)
    if plan is not None:
        return plan
    P = _SUM_P[name]
    plans = (_filter_plans(f[0], f[1]) if P == 1 else
             [ifilt_streams(f[0], f[1]), ifilt_streams(f[2], f[3])])
    taps, lens, offs = _table(plans)
    plan = _SumPlan(taps, lens, offs, plans, _sum_tap_bound(plans, P))
    if len(_SUM_PLANS) >= 64:
        _SUM_PLANS.clear()
    _SUM_PLANS[key] = plan
    return plan


def _sum_args(name: str, filters, dtype: torch.dtype):
    """The synthesis launch's arguments (:func:`_launch` *args*): the cached
    tap table and the tile of :func:`_sum_hw22_geometry` for *dtype* at the
    plan's tap bound."""
    plan = _sum_plan(name, filters)
    geo = _sum_hw22_geometry(_SUM_P[name], plan.mt, dtype)
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
    plans = _filter_plans(h0, h1)
    return _nest(_launch("filter_hw22", [x], H, W, 4,
                         lambda: (_table(plans), ())))


def dfilt_hw22(x: torch.Tensor, pair0, pair1):
    """Both decimate-by-2 branch pairs along H and W in one pass:
    ``u[j][k] = dfilt_H(dfilt_W(x, *pair_k), *pair_j)``, each
    ``[..., H/2, W/2]``."""
    H, W = _slices([x], "dfilt_hw22", 4)
    pairs = _equal_pairs(pair0, pair1, "dfilt_hw22")
    if dual._on_cpu(x, "dfilt_hw22"):
        return dfilt_hw22_reference(x, pair0, pair1)
    plans = [dfilt_streams(*p) for p in pairs]
    return _nest(_launch("dfilt_hw22", [x], H // 2, W // 2, 4,
                         lambda: (_table(plans), ())))


def filter_sum_hw22(v00, v01, v10, v11, g0, g1):
    """One synthesis (H, W) stage pair: ``sum_jk filter_H(filter_W(v[j][k],
    g_k), g_j)``, ``[..., H, W]``."""
    vs = [v00, v01, v10, v11]
    H, W = _slices(vs, "filter_sum_hw22", 1)
    g0, g1 = _odd(g0, g1, "filter_sum_hw22")
    if dual._on_cpu(v00, "filter_sum_hw22"):
        return filter_sum_hw22_reference(*vs, g0, g1)
    return _launch("filter_sum_hw22", vs, H, W, 1, lambda: _sum_args(
        "filter_sum_hw22", (g0, g1), v00.dtype))[0]


def ifilt_sum_hw22(v00, v01, v10, v11, pair0, pair1):
    """One synthesis (H, W) stage pair with interpolate-by-2: ``sum_jk
    ifilt_H(ifilt_W(v[j][k], *pair_k), *pair_j)``, ``[..., 2H, 2W]``."""
    vs = [v00, v01, v10, v11]
    H, W = _slices(vs, "ifilt_sum_hw22", 2)
    pairs = _equal_pairs(pair0, pair1, "ifilt_sum_hw22")
    if dual._on_cpu(v00, "ifilt_sum_hw22"):
        return ifilt_sum_hw22_reference(*vs, pair0, pair1)
    return _launch("ifilt_sum_hw22", vs, 2 * H, 2 * W, 1, lambda: _sum_args(
        "ifilt_sum_hw22", pairs[0] + pairs[1], v00.dtype))[0]
