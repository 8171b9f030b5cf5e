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
version, a CUDA tensor launches the kernel (``csrc/hw.cu``: the (H, W)
stage pair of ``csrc/pack3d.cu`` without the (un)pack, on the same host
plans) or raises.  The kernels take float32, bfloat16 and float64.
"""

from __future__ import annotations

import numpy as np
import torch

from dtcwt_tpu_torch.ops import _build, dual, fb
from dtcwt_tpu_torch.ops.ilevel2 import ifilt_streams
from dtcwt_tpu_torch.ops.level2 import dfilt_streams
from dtcwt_tpu_torch.ops.pack3d import _filter_plans, _table
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


def _launch(name: str, ins, plans, Ho: int, Wo: int, n_out: int):
    """Run kernel *name* on the [..., H, W] tensors *ins* (one for analysis,
    four for synthesis); returns *n_out* outputs [..., Ho, Wo]."""
    _build.check_no_grad(name, ins)
    x = ins[0]
    lead, (H, W) = tuple(x.shape[:-2]), tuple(x.shape[-2:])
    N = int(np.prod(lead, dtype=np.int64))
    if max(N, H, W, Ho, Wo) > dual._INT_MAX:
        raise ValueError("%s: [%d, %d, %d] exceeds the kernel's 32-bit sizes"
                         % (name, N, H, W))
    code = _build.dtype_code(x.dtype)
    flat = [t.reshape((N, H, W)).contiguous() for t in ins]
    outs = [torch.empty((N, Ho, Wo), dtype=x.dtype, device=x.device)
            for _ in range(n_out)]
    if N:
        taps, lens, offs = _table(plans)
        ptrs = lambda ts: [t.data_ptr() for t in ts] + [None] * (4 - len(ts))
        fn = getattr(_build.library(), "dtcwt_" + name)
        err = fn(*ptrs(flat), *ptrs(outs), N, H, W, Ho, Wo, taps.ctypes.data,
                 lens.ctypes.data, offs.ctypes.data, code,
                 _build.stream_ptr(x.device))
        _build.check(name, err)
        _build.count(name)
    return [o.reshape(lead + (Ho, Wo)) for o in outs]


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
    return _nest(_launch("filter_hw22", [x], _filter_plans(h0, h1), H, W, 4))


def dfilt_hw22(x: torch.Tensor, pair0, pair1):
    """Both decimate-by-2 branch pairs along H and W in one pass:
    ``u[j][k] = dfilt_H(dfilt_W(x, *pair_k), *pair_j)``, each
    ``[..., H/2, W/2]``."""
    H, W = _slices([x], "dfilt_hw22", 4)
    pairs = _equal_pairs(pair0, pair1, "dfilt_hw22")
    if dual._on_cpu(x, "dfilt_hw22"):
        return dfilt_hw22_reference(x, pair0, pair1)
    return _nest(_launch("dfilt_hw22", [x], [dfilt_streams(*p) for p in pairs],
                         H // 2, W // 2, 4))


def filter_sum_hw22(v00, v01, v10, v11, g0, g1):
    """One synthesis (H, W) stage pair: ``sum_jk filter_H(filter_W(v[j][k],
    g_k), g_j)``, ``[..., H, W]``."""
    vs = [v00, v01, v10, v11]
    H, W = _slices(vs, "filter_sum_hw22", 1)
    g0, g1 = _odd(g0, g1, "filter_sum_hw22")
    if dual._on_cpu(v00, "filter_sum_hw22"):
        return filter_sum_hw22_reference(*vs, g0, g1)
    return _launch("filter_sum_hw22", vs, _filter_plans(g0, g1), H, W, 1)[0]


def ifilt_sum_hw22(v00, v01, v10, v11, pair0, pair1):
    """One synthesis (H, W) stage pair with interpolate-by-2: ``sum_jk
    ifilt_H(ifilt_W(v[j][k], *pair_k), *pair_j)``, ``[..., 2H, 2W]``."""
    vs = [v00, v01, v10, v11]
    H, W = _slices(vs, "ifilt_sum_hw22", 2)
    pairs = _equal_pairs(pair0, pair1, "ifilt_sum_hw22")
    if dual._on_cpu(v00, "ifilt_sum_hw22"):
        return ifilt_sum_hw22_reference(*vs, pair0, pair1)
    return _launch("ifilt_sum_hw22", vs, [ifilt_streams(*p) for p in pairs],
                   2 * H, 2 * W, 1)[0]
