"""The 1-D DTCWT over a device mesh: batch over the data axis, the signal
axis sharded (``dtcwt_tpu.parallel.transform1d_dist``,
``dtcwt_tpu/parallel/transform1d_dist.py:1-457``).

A global ``[B, N, C]`` batch of signals (along axis -2, as
:class:`Transform1d` takes a 3-D input) is split over a
:class:`~.mesh.Mesh`: the batch over its data axis and the samples over
its rows axis, each shard a tensor on its mesh device (the grid of
:mod:`._grid`, one column).  A sharded level first extends every shard by
its neighbours' edge samples (:func:`~.halo.halo_exchange`, at the width
rounded by :func:`._grid._round8`) and runs the dual kernels'
from-extension form (``dual.filter2_fromext_axis`` at level 1,
``dfilt2_fromext_axis`` after; the inverse ``ifilt2_sum_fromext_axis``,
then ``filter2_sum_fromext_axis``); once the decimated signal can no
longer shard cleanly it is gathered on the axis's first device and the
coarse levels run replicated on the kernels' own reflection (``*_axis``).
The inverse runs the coarse levels replicated and re-shards once.

The JAX package's lane folding of long signals with few columns
(``_folded_halo``, its fold plans, ``_fold`` / ``_unfold``) is a TPU
layout device that :class:`Transform1d`'s port leaves out too: every
sharded level takes the wide-halo route, whose results are the folded
route's (``tests/test_sharded1d.py`` holds the two equal).  The plans, the
planes layout's per-level storage cast (the highpasses each level, the
lowpass at the end), the size checks and the results are the JAX
class's; the results are assembled on the mesh's first device.  The
bandpass families are refused, as by the JAX class.  A rows axis that no
level can use logs a warning, as the 2-D and 3-D classes' do.

Gradients: on a card mesh, where grad mode is on and an input or a
pyramid leaf requires grad, each level's pass runs as one linear
``torch.autograd.Function`` over the shards whose backward is the
opposite sharded pass on the dual kernels (:mod:`._grid`); on a CPU mesh
autograd runs through the plain versions.
"""

from __future__ import annotations

import logging
from typing import List

import torch

from dtcwt_tpu_torch.defaults import DEFAULT_BIORT, DEFAULT_QSHIFT
from dtcwt_tpu_torch.ops import dual
from dtcwt_tpu_torch.ops.packing import (
    c2q1d, c2q1d_planes, q2c1d, q2c1d_planes)
from dtcwt_tpu_torch.parallel._grid import (
    GridShards, _axis_plan, _map, _round8, _unzip)
from dtcwt_tpu_torch.transforms.pyramid import PlanePyramid, Pyramid
from dtcwt_tpu_torch.transforms.transform1d import Transform1d
from dtcwt_tpu_torch.transforms.transform2d import (
    _pad_multiple4, normalize_biort, normalize_qshift)
from dtcwt_tpu_torch.utils import compute_view

__all__ = ["ShardedTransform1d"]

logger = logging.getLogger(__name__)


class ShardedTransform1d(GridShards):
    """An n-level 1-D DTCWT over a device mesh.

    ``forward`` / ``inverse`` take and return global ``[B, N, C]`` tensors
    and pyramids (signals along axis -2, as in :class:`Transform1d` for 3-D
    inputs) on the mesh's first device; the signal axis is sharded over
    *rows_axis*.
    """

    def __init__(self, mesh, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
                 data_axis: str = "data", rows_axis: str = "rows"):
        self.mesh = mesh
        self.biort = normalize_biort(biort)
        self.qshift = normalize_qshift(qshift)
        if len(self.biort) != 4 or len(self.qshift) != 8:
            raise ValueError("1-D transform does not use bandpass variants")
        self.data_axis = data_axis
        self.rows_axis = rows_axis
        if (data_axis not in mesh.axis_names
                or rows_axis not in mesh.axis_names):
            raise ValueError("mesh must define axes %r and %r"
                             % (data_axis, rows_axis))
        self._init_grid(mesh, data_axis, rows_axis, None, -2)
        self._nrows = self._nouter
        self._single = Transform1d(self.biort, self.qshift,
                                   device=self._first)

    def _plan(self, N: int, nlevels: int) -> List[bool]:
        """Per level: does its filter pass run signal-sharded?"""
        return _axis_plan(N, self._nrows, nlevels,
                          _round8(max(v.size // 2 for v in self.biort)),
                          _round8(max(v.size for v in self.qshift)))

    # ------------------------------------------------------------------
    def forward(self, X, nlevels: int = 3, layout: str = "interleaved"):
        """Forward transform of a global ``[B, N, C]`` tensor (B a multiple
        of the data axis, N even).  ``layout='planes'`` returns a 1-D
        :class:`PlanePyramid` of even/odd-sample re/im planes (bfloat16
        input is stored as bfloat16 only in this layout)."""
        X = torch.as_tensor(X, device=self._first)
        if X.ndim != 3:
            raise ValueError("ShardedTransform1d.forward expects [B, N, C]")
        if X.shape[-2] % 2 != 0:
            raise ValueError("Size of input X must be a multiple of 2")
        if layout not in ("interleaved", "planes"):
            raise ValueError("layout must be 'interleaved' or 'planes'")
        if nlevels == 0:
            return self._single.forward(X, 0, layout=layout)
        if X.shape[0] % self._ndata:
            raise ValueError("batch %d does not split over the %d devices of "
                             "the data axis" % (X.shape[0], self._ndata))
        planes = layout == "planes"
        plan = self._plan(X.shape[-2], nlevels)
        if self._nrows > 1 and not plan[0]:
            logger.warning(
                "ShardedTransform1d.forward: rows axis (%d shards) is unused "
                "for %d samples — the transform runs replicated. Signal "
                "sharding needs N divisible by %d with even local lengths "
                ">= the filter halo.", self._nrows, X.shape[-2], self._nrows)
        if not X.is_floating_point():
            X = X.float()
        if X.dtype == torch.bfloat16 and not planes:
            # interleaved pyramids are complex; there is no bfloat16 complex
            X = X.float()
        out = [self._forward_slice(x, a, plan, planes)
               for a, x in enumerate(X.split(X.shape[0] // self._ndata))]
        lowpass = self._whole([o[0] for o in out], -2, -1)
        Yh = []
        for level in range(nlevels):
            gs = [o[1][level] for o in out]
            if planes:
                Yh.append(tuple(self._whole([_map(lambda t: t[i], g)
                                             for g in gs], -2, -1)
                                for i in range(2)))
            else:
                Yh.append(self._whole(gs, -2, -1))
        if planes:
            return PlanePyramid(lowpass, tuple(r for r, _ in Yh),
                                tuple(i for _, i in Yh), kind="1d")
        return Pyramid(lowpass, tuple(Yh))

    def _forward_slice(self, x, a, plan, planes):
        """One batch slice (``transform1d_dist.py:184-262``): (lowpass grid,
        per-level highpass grids)."""
        sdt = x.dtype   # storage dtype; the filters run at float32 / 64
        h0o, _, h1o, _ = self.biort
        h0a, h0b, _, _, h1a, h1b, _, _ = self.qshift
        p0, p1 = (h0b, h0a), (h1b, h1a)
        halo1 = _round8(max(h0o.size // 2, h1o.size // 2))
        halo2 = _round8(max(h0a.size, h1a.size))

        def pack(hi):
            if not planes:
                return q2c1d(hi, -2)
            re, im = q2c1d_planes(hi, -2)
            return re.to(sdt), im.to(sdt)

        cur = self._scatter(compute_view(x), a, plan[0], False)
        on = plan[0]
        Yh = []
        for level in range(len(plan)):
            if on and not plan[level]:
                cur, on = self._gather(cur, -2), False
            if level == 0:
                cur, hi = _unzip(self._pass(cur, -2, on, halo1, "filter2",
                                            dual, h0o, h1o), 2)
            else:
                if not on and cur[0][0].shape[-2] % 4:
                    cur = _map(lambda v: _pad_multiple4(v, -2), cur)
                cur, hi = _unzip(self._pass(cur, -2, on, halo2, "dfilt2",
                                            dual, p0, p1), 2)
            Yh.append(_map(pack, hi))
        # the lowpass is cast to the storage dtype once, at the end
        return _map(lambda v: v.to(sdt), cur), Yh

    # ------------------------------------------------------------------
    def inverse(self, pyramid, gain_mask=None):
        """Inverse transform of a :class:`Pyramid` or 1-D
        :class:`PlanePyramid` (bfloat16 planes reconstruct to bfloat16).
        *gain_mask* is an optional length-``nlevels`` vector of per-level
        gains, as for :meth:`Transform1d.inverse`."""
        planes = isinstance(pyramid, PlanePyramid)
        on = lambda t: torch.as_tensor(t, device=self._first)
        if planes:
            levels = [(on(r), on(i)) for r, i in zip(pyramid.highpasses_re,
                                                     pyramid.highpasses_im)]
            # the re plane has the complex subband's shape
            shapes = [tuple(r.shape) for r, _ in levels]
        else:
            levels = [on(h) for h in pyramid.highpasses]
            shapes = [tuple(h.shape) for h in levels]
        low = on(pyramid.lowpass)
        nlevels = len(levels)
        if nlevels == 0:
            return low
        if low.shape[0] % self._ndata:
            raise ValueError("batch %d does not split over the %d devices of "
                             "the data axis" % (low.shape[0], self._ndata))
        if gain_mask is not None:
            # the gains scale each subband before any filtering
            gm = [float(g) for g in torch.as_tensor(gain_mask).reshape(-1)]
            if planes:
                levels = [((r * gm[i]).to(r.dtype), (m * gm[i]).to(m.dtype))
                          for i, (r, m) in enumerate(levels)]
            else:
                levels = [h * gm[i] for i, h in enumerate(levels)]
        plan = self._plan(2 * shapes[0][-2], nlevels)
        b = low.shape[0] // self._ndata
        cdt = compute_view(low).dtype

        def grid(t, a, level):
            return self._scatter(t.narrow(0, a * b, b), a, plan[level],
                                 False)

        def hi_of(level, a):
            """The level's real interleaved highpass at the compute
            precision (``transform1d_dist.py:336-342``)."""
            if planes:
                re, im = (compute_view(t) for t in levels[level])
                hi = c2q1d_planes(re, im, -2)
            else:
                hi = c2q1d(levels[level], -2)
            return grid(hi.to(cdt), a, level)

        out = [self._inverse_slice(
            grid(compute_view(low), a, nlevels - 1),
            [hi_of(level, a) for level in range(nlevels)], a, shapes, plan,
            low.dtype) for a in range(self._ndata)]
        return self._whole(out, -2, -1)

    def _inverse_slice(self, lo, his, a, shapes, plan, sdt):
        """One batch slice (``transform1d_dist.py:347-434``): its lowpass
        grid and per-level highpass grids to the grid of the
        reconstruction."""
        _, g0o, _, g1o = self.biort
        _, _, g0a, g0b, _, _, g1a, g1b = self.qshift
        halo_i = _round8(max(g0a.size // 2, g1a.size // 2))
        halo_f = _round8(max(g0o.size // 2, g1o.size // 2))
        R = self._nrows

        # the forward plan is a sharded run of fine levels, so the inverse
        # walks replicated -> sharded with at most one re-shard
        on = plan[-1]
        for level in range(len(his) - 1, 0, -1):
            lo = self._merge(lo, his[level], -2, on, halo_i, "ifilt2_sum",
                             (g0b, g0a), (g1b, g1a))
            n = lo[0][0].shape[-2]
            want = 2 * shapes[level - 1][-2]
            if on:
                # sharded levels are crop-free by the plan; the finer level
                # is sharded too
                if n * R != want:
                    raise ValueError("Yh sizes are not valid for the"
                                     " sharded inverse transform")
                continue
            if n != want:
                lo = _map(lambda v: v.narrow(-2, 1, n - 2).contiguous(), lo)
            if lo[0][0].shape[-2] != want:
                raise ValueError("Yh sizes are not valid for the inverse"
                                 " transform")
            if plan[level - 1]:
                lo, on = self._reshard(lo, a, -2), True
        out = self._merge(lo, his[0], -2, on, halo_f, "filter2_sum", g0o,
                          g1o)
        return _map(lambda v: v.to(sdt), out)
