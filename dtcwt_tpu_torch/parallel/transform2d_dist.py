"""The 2-D DTCWT over a device mesh: batch over the data axis, image rows
(and optionally columns) sharded (``dtcwt_tpu.parallel.transform2d_dist``,
``dtcwt_tpu/parallel/transform2d_dist.py:1-604``).

A global ``[B, H, W]`` image batch is split over a :class:`~.mesh.Mesh`
with axes ``('data', 'rows'[, 'cols'])``: the batch over the data axis, H
over the rows axis and, with *cols_axis*, W over a third axis.  Each shard
is a tensor on its mesh device (the grid of :mod:`._grid`).  A level runs
as three passes of the per-axis filter kernels, each along one image axis:
the column pass (H) on the image, then the row pass (W) on each of its two
outputs.  Along a sharded axis a pass first extends every shard by its
neighbours' edge samples (:func:`~.halo.halo_exchange`, at the width
rounded by :func:`._grid._round8`) and then runs the from-extension form of
its kernel; along an unsharded axis it runs the kernel's own reflection:

* the default families: ``dual.filter2_*`` at level 1, ``dual.dfilt2_*``
  after (both branches from one read), synthesis ``dual.filter2_sum_*`` /
  ``ifilt2_sum_*``;
* the bandpass families' third stream and the ``q05`` pass: the
  single-stream ``single.filter_*`` / ``dfilt_*`` / ``ifilt_*``.

The card's :class:`Transform2d` runs fused level kernels instead, so the
two agree to the rounding of sums taken in another order, not bit for bit.
The band packing is :func:`ops.level1._pack`, the quad unpacking
:func:`ops.ilevel2._quads`.  Once an axis can no longer shard cleanly
(an odd global size, a local extent not a multiple of 4 or under the halo,
a global multiple-of-4 pad) it is gathered on its first device and the
coarse levels run replicated along it; the inverse runs the coarse levels
replicated and re-shards once.  A replicated stretch is computed once, on
its first device, where JAX repeats it on each.  The plans, the warnings,
the per-level requantisation to the storage dtype and the results are the
JAX class's; the results are assembled on the mesh's first device.

Gradients: on a card mesh, where grad mode is on and an input or a
pyramid leaf requires grad, each filter pass and merge runs as one linear
``torch.autograd.Function`` over the shard grid, and its backward is the
opposite sharded pass on the kernels (``filter2`` <-> ``filter2_sum``
through the level-1 adjoint, ``dfilt2`` <-> ``ifilt2_sum``) or, for the
bandpass families' passes and the rest outside
``ops.adjoint.explicit_route``, the plain pass's vjp (:mod:`._grid`); the
glue between the passes is PyTorch's own autograd.  On a CPU mesh
autograd runs through the plain versions.
"""

from __future__ import annotations

import logging
from typing import List, Tuple

import torch

from dtcwt_tpu_torch.defaults import DEFAULT_BIORT, DEFAULT_QSHIFT
from dtcwt_tpu_torch.ops import dual, ilevel2, level1, single
from dtcwt_tpu_torch.parallel._grid import (
    GridShards, _axis_plan, _map, _round8, _unzip)
from dtcwt_tpu_torch.transforms.pyramid import (
    PLANE_BAND_ORDER, PlanePyramid, Pyramid)
from dtcwt_tpu_torch.transforms.transform2d import (
    Transform2d, _dup_edge, _pad_multiple4, normalize_biort,
    normalize_qshift)
from dtcwt_tpu_torch.utils import compute_view

__all__ = ["ShardedTransform2d"]

logger = logging.getLogger(__name__)


def _add(g, h):
    return _map(lambda u, v: u + v, g, h)


class ShardedTransform2d(GridShards):
    """An n-level 2-D DTCWT over a device mesh.

    :param mesh: a :class:`~.mesh.Mesh` with a batch axis, a rows axis and
        (optionally) a cols axis.
    :param biort, qshift: wavelets, as for :class:`Transform2d` (the
        bandpass families included).
    :param cols_axis: name of the mesh axis sharding image columns, or
        ``None`` (default) for rows-only sharding.

    ``forward`` / ``inverse`` take and return global ``[B, H, W]`` tensors
    and pyramids on the mesh's first device.
    """

    def __init__(self, mesh, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
                 data_axis: str = "data", rows_axis: str = "rows",
                 cols_axis: str = None):
        self.mesh = mesh
        self.biort = normalize_biort(biort)
        self.qshift = normalize_qshift(qshift)
        self.data_axis = data_axis
        self.rows_axis = rows_axis
        self.cols_axis = cols_axis
        if (data_axis not in mesh.axis_names
                or rows_axis not in mesh.axis_names):
            raise ValueError("mesh must define axes %r and %r"
                             % (data_axis, rows_axis))
        if cols_axis is not None and cols_axis not in mesh.axis_names:
            raise ValueError("mesh does not define cols axis %r"
                             % (cols_axis,))
        self._init_grid(mesh, data_axis, rows_axis, cols_axis, -2)
        self._nrows, self._ncols = self._nouter, self._ninner
        # the replicated fallback and nlevels == 0, on the first device
        self._single = Transform2d(self.biort, self.qshift,
                                   device=self._first)

    # ------------------------------------------------------------------
    # plans: which levels stay sharded, per image axis
    # ------------------------------------------------------------------
    def _halos(self) -> Tuple[int, int]:
        """The forward's exchanged halo widths, level 1 and levels >= 2."""
        halo1 = _round8(max(v.size // 2 for v in self.biort))
        halo2 = _round8(max(v.size for v in self.qshift))
        return halo1, halo2

    def _plan(self, H: int, W: int, nlevels: int):
        halo1, halo2 = self._halos()
        return (_axis_plan(H, self._nrows, nlevels, halo1, halo2),
                _axis_plan(W, self._ncols, nlevels, halo1, halo2))

    def _warn_degraded(self, what: str, H: int, W: int, rplan, cplan):
        """A warning where a mesh axis the caller asked for carries no level
        at all: the transform runs replicated along it."""
        if self._nrows > 1 and not rplan[0]:
            logger.warning(
                "ShardedTransform2d.%s: rows axis (%d shards) is unused for "
                "a %dx%d input — the transform runs row-replicated. Row "
                "sharding needs H divisible by %d with even local rows >= "
                "the filter halo.", what, self._nrows, H, W, self._nrows)
        if self._ncols > 1 and not cplan[0]:
            logger.warning(
                "ShardedTransform2d.%s: cols axis (%d shards) is unused for "
                "a %dx%d input — the transform runs column-replicated.",
                what, self._ncols, H, W)

    def _inverse_plan(self, low_shape, hp_shapes, nlevels: int, dim: int,
                      Rax: int) -> List[bool]:
        """Per inverse level along subband axis *dim* (-3 rows, -2 cols of
        the interleaved ``[..., h, w, 6]`` shapes): the largest crop-free
        run of fine levels whose local extents stay shardable runs sharded,
        the coarser levels replicated (``transform2d_dist.py:418-444``)."""
        plan = [False] * nlevels
        if Rax <= 1:
            return plan
        b, q = self.biort, self.qshift
        halo1 = _round8(max(v.size // 2 for v in b[1::2]))
        halo2 = _round8(max(v.size // 2 for v in q[2::4]))

        def level_ok(l):
            n_in = (2 * hp_shapes[l][dim] if l < nlevels - 1
                    else low_shape[dim + 1])
            halo = halo2 if l > 0 else max(halo1, halo2)
            return (n_in % Rax == 0 and (n_in // Rax) % 2 == 0
                    and (n_in // Rax) >= halo)

        def cropfree(l):
            return 2 * hp_shapes[l + 1][dim] == hp_shapes[l][dim]

        for start in range(nlevels - 1, -1, -1):
            if (all(level_ok(l) for l in range(start + 1))
                    and all(cropfree(l) for l in range(start))):
                plan[:start + 1] = [True] * (start + 1)
                break
        return plan

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def forward(self, X, nlevels: int = 3, layout: str = "interleaved",
                include_scale: bool = False):
        """Forward transform of a global ``[B, H, W]`` tensor (B a multiple
        of the data axis).  ``layout='planes'`` returns a
        :class:`PlanePyramid` (bfloat16 input is stored as bfloat16 only in
        this layout).  ``include_scale`` attaches the per-level lowpass
        images."""
        X = torch.as_tensor(X, device=self._first)
        if X.ndim != 3:
            raise ValueError("ShardedTransform2d.forward expects [B, H, W]")
        if layout not in ("interleaved", "planes"):
            raise ValueError("layout must be 'interleaved' or 'planes'")
        if nlevels == 0:
            return self._single.forward(X, 0, include_scale=include_scale,
                                        layout=layout)
        if X.shape[0] % self._ndata:
            raise ValueError("batch %d does not split over the %d devices of "
                             "the data axis" % (X.shape[0], self._ndata))
        planes = layout == "planes"
        B, H, W = X.shape
        rplan, cplan = self._plan(H, W, nlevels)
        self._warn_degraded("forward", H, W, rplan, cplan)
        if not X.is_floating_point():
            X = X.float()
        if X.dtype == torch.bfloat16 and not planes:
            # interleaved pyramids are complex; there is no bfloat16 complex
            X = X.float()
        out = [self._forward_slice(x, a, rplan, cplan, nlevels, planes,
                                   include_scale)
               for a, x in enumerate(X.split(B // self._ndata))]
        lowpass = self._whole([o[0] for o in out], -2, -1)
        Yh = []
        for level in range(nlevels):
            gs = [o[1][level] for o in out]
            if planes:
                re, im = zip(*(_unzip(g, 2) for g in gs))
                Yh.append((self._whole(re, -2, -1), self._whole(im, -2, -1)))
            else:
                Yh.append(self._whole(gs, -3, -2))
        scales = None
        if include_scale:
            scales = tuple(self._whole([o[2][level] for o in out], -2, -1)
                           for level in range(nlevels))
        if planes:
            return PlanePyramid(lowpass, tuple(r for r, _ in Yh),
                                tuple(i for _, i in Yh), scales)
        return Pyramid(lowpass, tuple(Yh), scales)

    def _forward_slice(self, x, a, rplan, cplan, nlevels, planes,
                       include_scale):
        """One batch slice (``transform2d_dist.py:243-342``): (lowpass grid,
        per-level subband grids, per-level lowpass grids)."""
        sdt = x.dtype   # storage dtype; the filters run at float32 / 64
        b, q = self.biort, self.qshift
        h0o, h1o = b[0], b[2]
        h2o = b[4] if len(b) == 6 else None
        p0, p1 = (q[1], q[0]), (q[5], q[4])
        p2 = (q[9], q[8]) if len(q) == 12 else None
        halo1 = _round8(max(v.size // 2 for v in b[0::2]))
        halo2 = _round8(max(v.size for v in q[0::4]))

        cur = self._scatter(compute_view(x), a, rplan[0], cplan[0])
        r_on, c_on = rplan[0], cplan[0]
        Yh, Yscale = [], []
        for level in range(nlevels):
            if r_on and not rplan[level]:
                cur, r_on = self._gather(cur, -2), False
            if c_on and not cplan[level]:
                cur, c_on = self._gather(cur, -1), False
            if level == 0:
                # odd sizes duplicate their last sample (the plans shard no
                # odd axis)
                for ax, local in ((-1, not c_on), (-2, not r_on)):
                    if local and cur[0][0].shape[ax] % 2:
                        cur = _map(lambda v: _dup_edge(v, ax), cur)
                two = lambda g, ax, on: _unzip(self._pass(
                    g, ax, on, halo1, "filter2", dual, h0o, h1o), 2)
                one = lambda g, ax, on, h: self._pass(
                    g, ax, on, halo1, "filter", single, h)
                lo, hi = two(cur, -2, r_on)
                lolo, q23 = two(lo, -1, c_on)
                if h2o is not None:
                    ba = one(cur, -2, r_on, h2o)
                    q05 = one(hi, -1, c_on, h0o)
                    q14 = one(ba, -1, c_on, h2o)
                else:
                    q05, q14 = two(hi, -1, c_on)
            else:
                # edge-repeat pads to a multiple of 4 on the local axes
                # only (the plans shard no axis that needs one)
                for ax, local in ((-2, not r_on), (-1, not c_on)):
                    if local and cur[0][0].shape[ax] % 4:
                        cur = _map(lambda v: _pad_multiple4(v, ax), cur)
                two = lambda g, ax, on: _unzip(self._pass(
                    g, ax, on, halo2, "dfilt2", dual, p0, p1), 2)
                one = lambda g, ax, on, p: self._pass(
                    g, ax, on, halo2, "dfilt", single, *p)
                lo, hi = two(cur, -2, r_on)
                lolo, q23 = two(lo, -1, c_on)
                if p2 is not None:
                    ba = one(cur, -2, r_on, p2)
                    q05 = one(hi, -1, c_on, p0)
                    q14 = one(ba, -1, c_on, p2)
                else:
                    q05, q14 = two(hi, -1, c_on)
            Yh.append(_map(lambda u, v, w: level1._pack(u, v, w, planes, sdt),
                           q05, q23, q14))
            # the lowpass requantised to the storage dtype at every level
            lolo = _map(lambda v: v.to(sdt), lolo)
            if include_scale:
                Yscale.append(lolo)
            cur = _map(lambda v: compute_view(v).contiguous(), lolo)
        return lolo, Yh, Yscale

    # ------------------------------------------------------------------
    # inverse
    # ------------------------------------------------------------------
    def inverse(self, pyramid, gain_mask=None):
        """Inverse transform of a :class:`Pyramid` or :class:`PlanePyramid`
        (bfloat16 planes reconstruct to bfloat16).  *gain_mask* is an
        optional ``(6, nlevels)`` array of per-subband gains in degree
        order, as for :meth:`Transform2d.inverse`."""
        planes = isinstance(pyramid, PlanePyramid)
        on = lambda t: torch.as_tensor(t, device=self._first)
        if planes:
            levels = [(on(r), on(i)) for r, i in zip(pyramid.highpasses_re,
                                                     pyramid.highpasses_im)]
            # shapes in the interleaved [..., h, w, 6] convention
            shapes = [tuple(r.shape[:-3]) + tuple(r.shape[-2:]) + (6,)
                      for r, _ in levels]
        else:
            levels = [on(h) for h in pyramid.highpasses]
            shapes = [tuple(h.shape) for h in levels]
        nlevels = len(levels)
        low = on(pyramid.lowpass)
        if nlevels == 0:
            return low
        low_shape = tuple(low.shape)
        rplan = self._inverse_plan(low_shape, shapes, nlevels, -3,
                                   self._nrows)
        cplan = self._inverse_plan(low_shape, shapes, nlevels, -2,
                                   self._ncols)
        if not rplan[0] and not cplan[0]:
            if self._nrows > 1 or self._ncols > 1:
                logger.warning(
                    "ShardedTransform2d.inverse: pyramid shapes (lowpass %s)"
                    " cannot be sharded over the %s mesh — running the "
                    "inverse replicated on every device.", low_shape,
                    self.mesh.shape)
            return self._single.inverse(pyramid, gain_mask)
        if low_shape[0] % self._ndata:
            raise ValueError("batch %d does not split over the %d devices of "
                             "the data axis" % (low_shape[0], self._ndata))
        sdt = low.dtype
        if gain_mask is not None:
            # the gains scale each subband before any filtering
            gm = torch.as_tensor(gain_mask, device=self._first)
            if planes:
                gp = gm[list(PLANE_BAND_ORDER)]
                levels = [((r * gp[:, i, None, None]).to(r.dtype),
                           (m * gp[:, i, None, None]).to(m.dtype))
                          for i, (r, m) in enumerate(levels)]
            else:
                levels = [h * gm[:, i].to(h.real.dtype)
                          for i, h in enumerate(levels)]
        # the filters run at the subbands' compute precision
        cdt = (compute_view(low) if planes else levels[0].real).dtype
        b = low_shape[0] // self._ndata

        def grid(t, a, level, odim, idim):
            return self._scatter(t.narrow(0, a * b, b), a, rplan[level],
                                 cplan[level], odim, idim)

        def bands(level, a):
            if planes:
                re, im = levels[level]
                return _map(lambda u, v: {"bands": (u, v)},
                            grid(re, a, level, -2, -1),
                            grid(im, a, level, -2, -1))
            return _map(lambda h: {"yh": h},
                        grid(levels[level], a, level, -3, -2))

        out = [self._inverse_slice(
            grid(compute_view(low).to(cdt), a, nlevels - 1, -2, -1),
            [bands(level, a) for level in range(nlevels)], a, shapes, rplan,
            cplan, sdt, cdt) for a in range(self._ndata)]
        return self._whole(out, -2, -1)

    def _inverse_slice(self, Z, bands, a, shapes, rplan, cplan, sdt, cdt):
        """One batch slice (``transform2d_dist.py:496-586``): its lowpass
        grid and per-level subband grids to the grid of the
        reconstruction."""
        nlevels = len(bands)
        b, q = self.biort, self.qshift
        g0o, g1o = b[1], b[3]
        g2o = b[5] if len(b) == 6 else None
        p0, p1 = (q[3], q[2]), (q[7], q[6])
        p2 = (q[11], q[10]) if len(q) == 12 else None
        halo1 = _round8(max(v.size // 2 for v in b[1::2]))
        halo2 = _round8(max(v.size // 2 for v in q[2::4]))

        def quads(g):
            return _unzip(_map(lambda kw: tuple(
                u.to(cdt) for u in ilevel2._quads(**kw)), g), 3)

        r_on, c_on = rplan[-1], cplan[-1]
        for level in range(nlevels - 1, 0, -1):
            lh, hl, hh = quads(bands[level])
            two = lambda ga, gb, ax, on: self._merge(
                ga, gb, ax, on, halo2, "ifilt2_sum", p0, p1)
            one = lambda g, ax, on, p: self._pass(
                g, ax, on, halo2, "ifilt", single, *p)
            y1 = two(Z, lh, -2, r_on)
            if p2 is not None:
                y2 = one(hl, -2, r_on, p0)
                y2bp = one(hh, -2, r_on, p2)
                Z = _add(two(y1, y2, -1, c_on), one(y2bp, -1, c_on, p2))
            else:
                y2 = two(hl, hh, -2, r_on)
                Z = two(y1, y2, -1, c_on)
            # the forward's pads cropped, on replicated axes only (the
            # plans shard no level that crops)
            for ax, dim, local in ((-2, -3, not r_on), (-1, -2, not c_on)):
                if not local:
                    continue
                want = 2 * shapes[level - 1][dim]
                if Z[0][0].shape[ax] != want:
                    Z = _map(lambda v: v.narrow(ax, 1, v.shape[ax] - 2), Z)
                if Z[0][0].shape[ax] != want:
                    raise ValueError("Sizes of highpasses are not valid for "
                                     "the inverse transform")
            # requantised to the storage dtype at every level
            Z = _map(lambda v: v.to(sdt).to(cdt).contiguous(), Z)
            if not r_on and rplan[level - 1]:
                Z, r_on = self._reshard(Z, a, -2), True
            if not c_on and cplan[level - 1]:
                Z, c_on = self._reshard(Z, a, -1), True
        lh, hl, hh = quads(bands[0])
        two = lambda ga, gb, ax, on: self._merge(
            ga, gb, ax, on, halo1, "filter2_sum", g0o, g1o)
        one = lambda g, ax, on, h: self._pass(
            g, ax, on, halo1, "filter", single, h)
        y1 = two(Z, lh, -2, r_on)
        if g2o is not None:
            y2 = one(hl, -2, r_on, g0o)
            y2bp = one(hh, -2, r_on, g2o)
            Z = _add(two(y1, y2, -1, c_on), one(y2bp, -1, c_on, g2o))
        else:
            y2 = two(hl, hh, -2, r_on)
            Z = two(y1, y2, -1, c_on)
        return _map(lambda v: v.to(sdt), Z)
