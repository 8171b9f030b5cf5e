"""The 3-D DTCWT over a device mesh: batch over the data axis, depth (and
optionally rows) sharded (``dtcwt_tpu.parallel.transform3d_dist``).

A global ``[B, D, H, W]`` volume is split over a :class:`~.mesh.Mesh`: the
batch over its data axis, the depth over its depth axis and, with
*rows_axis*, the height over a third axis.  Each shard is a tensor on its
mesh device.  A filter pass along a sharded axis first extends every shard
with its neighbours' edge samples (:func:`~.halo.halo_exchange`) and then
runs the from-extension form of its kernel.  The routes of one level:

* depth-sharded, rows local: the whole (H, W) stage pair of a shard is one
  launch (``hw.filter_hw22`` at level 1, ``hw.dfilt_hw22`` after), then
  the depth stage on the extended shards (``dual.filter2_fromext_axis`` /
  ``dfilt2_fromext_axis``) and the packing (``pack3d.pack_octants``); the
  inverse unpacks, merges along depth (``dual.filter2_sum_fromext_axis``
  / ``ifilt2_sum_fromext_axis``) and then along (H, W)
  (``hw.filter_sum_hw22`` / ``ifilt_sum_hw22``);
* rows-sharded: one axis at a time, W on the dual kernels, H and D
  extended;
* replicated (no axis shards at that level): the volume is gathered on the
  first device of each axis; a forward level runs as :class:`Transform3d`
  runs it (the level kernels of ``ops/pack3d``), an inverse level >= 2 as
  the depth-sharded route does without the halos, as the JAX package's
  ``Transform3d._level2_inv`` does.  An inverse whose pyramid shards on no
  axis is :meth:`Transform3d.inverse`.

A replicated axis is computed once, on its first device, where JAX repeats
it on each.  The plans (which levels shard), the warnings, the per-level
requantisation to the storage dtype and the results are the JAX class's;
the results are assembled on the mesh's first device.

Gradients: on a card mesh, where grad mode is on and an input or a
pyramid leaf requires grad, each depth or rows pass (:mod:`._grid`), each
shard's (H, W) stage pair and each replicated forward level runs as one
linear ``torch.autograd.Function``.  Its backward is the opposite stage on
the kernels (``dfilt_hw22`` <-> ``ifilt_sum_hw22``, ``filter_hw22`` and
``filter_sum_hw22`` through the per-axis level-1 adjoints, a replicated
level through :class:`Transform3d`'s adjoint pieces) or, outside
``ops.adjoint.explicit_route`` and for the ``discard_level_1`` lowpass
passes, the plain stage's vjp.  On a CPU mesh autograd runs through the
plain versions.
"""

from __future__ import annotations

import logging
from typing import List

import torch

from dtcwt_tpu_torch.defaults import DEFAULT_BIORT, DEFAULT_QSHIFT
from dtcwt_tpu_torch.ops import adjoint, dual, hw, linearize, pack3d, single
from dtcwt_tpu_torch.parallel._grid import (
    GridShards, _map, _round8, _unzip)
from dtcwt_tpu_torch.transforms.pyramid import PlanePyramid, Pyramid
from dtcwt_tpu_torch.transforms.transform2d import (
    normalize_biort, normalize_qshift)
from dtcwt_tpu_torch.transforms.transform3d import (
    Transform3d, _OCTANTS, _repeat_edges)
from dtcwt_tpu_torch.utils import compute_view

__all__ = ["ShardedTransform3d"]

logger = logging.getLogger(__name__)


class ShardedTransform3d(GridShards):
    """An n-level 3-D DTCWT over a device mesh: depth-axis sharding, plus an
    optional second spatial axis over the image rows (H).

    :param mesh: a :class:`~.mesh.Mesh` with a batch axis and a depth axis
        (default names ``'data'`` and ``'depth'``); pass *rows_axis* to also
        shard the H axis.
    :param ext_mode: 4 or 8, as for :class:`Transform3d`.

    ``forward`` / ``inverse`` take and return global ``[B, D, H, W]``
    tensors and pyramids (highpasses ``[B, D', H', W', 28]`` complex, or a
    3-D :class:`PlanePyramid`), on the mesh's first device.
    """

    def __init__(self, mesh, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
                 ext_mode: int = 4, data_axis: str = "data",
                 depth_axis: str = "depth", rows_axis: str = None):
        self.mesh = mesh
        self.biort = normalize_biort(biort)
        self.qshift = normalize_qshift(qshift)
        if len(self.biort) != 4 or len(self.qshift) != 8:
            raise ValueError("3-D transform does not use bandpass variants")
        if ext_mode not in (4, 8):
            raise ValueError("ext_mode must be one of 4 or 8")
        self.ext_mode = ext_mode
        self.data_axis = data_axis
        self.depth_axis = depth_axis
        self.rows_axis = rows_axis
        if data_axis not in mesh.axis_names or depth_axis not in mesh.axis_names:
            raise ValueError("mesh must define axes %r and %r"
                             % (data_axis, depth_axis))
        if rows_axis is not None and rows_axis not in mesh.axis_names:
            raise ValueError("mesh does not define rows axis %r" % rows_axis)
        self._init_grid(mesh, data_axis, depth_axis, rows_axis, -3)
        self._ndepth, self._nrows = self._nouter, self._ninner
        self._single = Transform3d(self.biort, self.qshift, ext_mode,
                                   device=self._first)

    # ------------------------------------------------------------------
    # plans
    # ------------------------------------------------------------------
    def _axis_plan(self, n: int, nlevels: int, Rax: int) -> List[bool]:
        """Per level: does the filter pass along a spatial axis of global
        extent *n* run sharded over a mesh axis of *Rax* devices?"""
        h0o, h1o = self.biort[0], self.biort[2]
        halo1 = _round8(max(h0o.size // 2, h1o.size // 2))
        halo2 = _round8(max(self.qshift[0].size, self.qshift[4].size))
        div = self.ext_mode
        plan = []
        d = n
        # even-length level-1 filters trim one trailing sample per axis, a
        # global edit that would unbalance the shards: run replicated
        sharded = Rax > 1 and h0o.size % 2 == 1
        for level in range(nlevels):
            if level == 0:
                sharded = (sharded and d % Rax == 0 and (d // Rax) % 2 == 0
                           and (d // Rax) >= halo1)
            else:
                need_pad = d % div != 0
                sharded = (sharded and not need_pad and d % Rax == 0
                           and (d // Rax) % 4 == 0 and (d // Rax) >= halo2)
                if need_pad:
                    d += 2 * (1 if div == 4 else 2)
                d >>= 1
            plan.append(sharded)
        return plan

    def _plan(self, D: int, nlevels: int) -> List[bool]:
        """Per level: does its depth pass run depth-sharded?"""
        return self._axis_plan(D, nlevels, self._ndepth)

    def _inverse_plan(self, low_shape, hp_shapes, nlevels: int, dim: int,
                      Rax: int) -> List[bool]:
        """Per inverse level, along volume axis *dim* (-3 depth, -2 rows):
        the largest crop-free run of fine levels whose local extents stay
        shardable runs sharded, the coarser levels replicated.  Even-length
        level-1 synthesis filters trim global samples: all replicated."""
        g0o, g1o = self.biort[1], self.biort[3]
        halo1 = _round8(max(g0o.size // 2, g1o.size // 2))
        halo2 = _round8(max(self.qshift[2].size // 2,
                            self.qshift[6].size // 2))

        def gshape(level):
            if hp_shapes[level] is not None:
                return hp_shapes[level][dim - 1]   # trailing band axis
            # discard_level_1: the grids double per finer level
            return low_shape[dim] * (2 ** (nlevels - 1 - level)) // 2

        def level_ok(l):
            n_in = 2 * gshape(l) if l < nlevels - 1 else low_shape[dim]
            halo = halo2 if l > 0 else max(halo1, halo2)
            return (n_in % Rax == 0 and (n_in // Rax) % 2 == 0
                    and (n_in // Rax) >= halo)

        def cropfree(l):
            return 2 * gshape(l + 1) == gshape(l)

        plan = [False] * nlevels
        if Rax > 1 and g0o.size % 2 == 1:
            for start in range(nlevels - 1, -1, -1):
                if (all(level_ok(l) for l in range(start + 1))
                        and all(cropfree(l) for l in range(start))):
                    plan[:start + 1] = [True] * (start + 1)
                    break
        return plan

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def forward(self, X, nlevels: int = 3, discard_level_1: bool = False,
                layout: str = "interleaved", include_scale: bool = False):
        """Forward transform of a global ``[B, D, H, W]`` volume (B a
        multiple of the data axis).  ``layout='planes'`` returns a 3-D
        :class:`PlanePyramid` (the bfloat16 storage route).
        ``include_scale`` attaches the per-level lowpass volumes."""
        X = torch.as_tensor(X, device=self._first)
        if X.ndim != 4:
            raise ValueError("ShardedTransform3d.forward expects [B, D, H, W]")
        div = 2 if self.ext_mode == 4 else 4
        if any(X.shape[d] % div for d in (-3, -2, -1)):
            raise ValueError(
                "Input shape should be a multiple of %d in each direction"
                " when ext_mode == %d" % (div, self.ext_mode))
        if layout not in ("interleaved", "planes"):
            raise ValueError("layout must be 'interleaved' or 'planes'")
        if nlevels == 0:
            return self._single.forward(X, 0, include_scale=include_scale,
                                        discard_level_1=discard_level_1,
                                        layout=layout)
        if X.shape[0] % self._ndata:
            raise ValueError("batch %d does not split over the %d devices of "
                             "the data axis" % (X.shape[0], self._ndata))
        if discard_level_1 and self.biort[0].size % 2 == 0:
            raise ValueError("discard_level_1 requires odd-length level-1"
                             " filters")
        planes = layout == "planes"
        B, D, H, _ = X.shape
        plan = self._plan(D, nlevels)
        rplan = self._axis_plan(H, nlevels, self._nrows)
        if self._ndepth > 1 and not plan[0]:
            logger.warning(
                "ShardedTransform3d.forward: depth axis (%d shards) is "
                "unused for a depth-%d volume — the transform runs "
                "depth-replicated.", self._ndepth, D)
        if self._nrows > 1 and not rplan[0]:
            logger.warning(
                "ShardedTransform3d.forward: rows axis (%d shards) is "
                "unused for a height-%d volume — the transform runs "
                "rows-replicated.", self._nrows, H)
        if not X.is_floating_point():
            X = X.float()
        if X.dtype == torch.bfloat16 and not planes:
            # interleaved pyramids are complex; there is no bfloat16 complex
            X = X.float()
        out = [self._forward_slice(x, a, plan, rplan, nlevels,
                                   discard_level_1, planes, include_scale)
               for a, x in enumerate(X.split(B // self._ndata))]
        lowpass = self._whole([o[0] for o in out], -3, -2)
        Yh = []
        for level in range(nlevels):
            gs = [o[1][level] for o in out]
            if gs[0] is None:
                Yh.append((None, None) if planes else None)
            elif planes:
                re, im = zip(*(_unzip(g, 2) for g in gs))
                Yh.append((self._whole(re, -3, -2), self._whole(im, -3, -2)))
            else:
                Yh.append(self._whole(gs, -4, -3))
        scales = None
        if include_scale:
            scales = tuple(self._whole([o[2][level] for o in out], -3, -2)
                           for level in range(nlevels))
        if planes:
            return PlanePyramid(lowpass, tuple(r for r, _ in Yh),
                                tuple(i for _, i in Yh), scales, kind="3d")
        return Pyramid(lowpass, tuple(Yh), scales)

    def _forward_slice(self, x, a, plan, rplan, nlevels, discard, planes,
                       include_scale):
        """One batch slice: (lowpass grid, per-level subband grids (None
        for a discarded level), per-level lowpass grids)."""
        sdt = x.dtype   # storage dtype; the filters run at float32 / 64
        h0o, h1o = self.biort[0], self.biort[2]
        q = self.qshift
        p0, p1 = (q[1], q[0]), (q[5], q[4])
        halo1 = _round8(max(h0o.size // 2, h1o.size // 2))
        halo2 = _round8(max(q[0].size, q[4].size))
        div = self.ext_mode
        rep = 1 if div == 4 else 2

        def filter2(g, axis, on):
            """Both biort branches along *axis*: two grids."""
            return _unzip(self._pass(g, axis, on, halo1, "filter2", dual,
                                     h0o, h1o), 2)

        def dfilt2(g, axis, on):
            """Both qshift branches along *axis*: two grids."""
            return _unzip(self._pass(g, axis, on, halo2, "dfilt2", dual,
                                     p0, p1), 2)

        def lowpass(g, axis, on):
            """The lowpass biort branch alone (discard_level_1)."""
            return self._pass(g, axis, on, halo1, "filter", single, h0o)

        cur = self._scatter(compute_view(x), a, plan[0], rplan[0])
        d_on, r_on = plan[0], rplan[0]
        Yh, Yscale = [], []

        def requant(g):
            # the lowpass in the storage dtype at each level boundary (the
            # include_scale entry), read back at the compute precision
            g = _map(lambda v: v.to(sdt), g)
            if include_scale:
                Yscale.append(g)
            return _map(compute_view, g)

        for level in range(nlevels):
            if d_on and not plan[level]:
                cur, d_on = self._gather(cur, -3), False
            if r_on and not rplan[level]:
                cur, r_on = self._gather(cur, -2), False
            if level == 0 and discard:
                # level 1 lowpass only: W, H, D
                out = lowpass(lowpass(cur, -1, False), -2, r_on)
                cur = requant(lowpass(out, -3, d_on))
                Yh.append(None)
                continue
            if not d_on and not r_on:
                # the gathered volume: the level as Transform3d runs it
                lll, hp = self._replicated_level(cur, level, planes)
                if planes:
                    hp = (hp[0].to(sdt), hp[1].to(sdt))
                cur = requant([[lll]])
                Yh.append([[hp]])
                continue
            if level == 0:
                split = filter2
            else:
                # edge-repeat pads on the local axes only (the plans shard
                # no axis that needs one)
                pads = [(-1, True), (-2, not r_on), (-3, not d_on)]
                for ax, local in pads:
                    if local:
                        cur = _map(lambda v: _repeat_edges(v, ax, rep)
                                   if v.shape[ax] % div else v, cur)
                split = dfilt2
            if r_on:
                # t21[k][j]: W branch k, then H branch j
                t21 = [split(t, -2, True) for t in split(cur, -1, False)]
            else:
                # the (H, W) stage pair of each shard in one launch
                u = self._hw_split(cur, level == 0)
                t21 = [[_map(lambda t: t[2 * j + k], u) for j in range(2)]
                       for k in range(2)]
            octs = {}
            for j in range(2):
                for k in range(2):
                    octs[(0, j, k)], octs[(1, j, k)] = split(t21[k][j], -3,
                                                             d_on)
            cur = requant(octs[(0, 0, 0)])
            Yh.append(_map(lambda *v: pack3d.pack_octants(
                dict(zip(_OCTANTS, v)), planes, sdt),
                *(octs[o] for o in _OCTANTS)))
        return _map(lambda v: v.to(sdt), cur), Yh, Yscale

    # ------------------------------------------------------------------
    # the stages that run as one Function each besides the grid's passes:
    # the (H, W) stage pair of every shard and a replicated forward level
    # ------------------------------------------------------------------
    def _hw_split(self, g, level1: bool):
        """The (H, W) analysis stage pair of each shard of *g* in one
        launch (``hw.filter_hw22`` at level 1, ``hw.dfilt_hw22`` after): a
        grid of ``(u00, u01, u10, u11)``.  Its adjoint is the per-axis
        level-1 adjoints (``adjoint.filter_hw22_adj``) or the synthesis
        pair ``hw.ifilt_sum_hw22``."""
        b, q = self.biort, self.qshift
        name, f = (("filter_hw22", (b[0], b[2])) if level1
                   else ("dfilt_hw22", ((q[1], q[0]), (q[5], q[4]))))

        def run(grid, plain):
            fn = linearize.entry(hw, name, plain)
            return _map(lambda v: tuple(u for row in fn(v, *f) for u in row),
                        grid)

        def adj():
            x = g[0][0]
            if not adjoint.explicit_route(b, q, x.dtype):
                return None
            if level1:
                # the fold reads a border of half the longer filter
                if min(x.shape[-2:]) < adjoint.fold_width(*f):
                    return None
                return lambda cot: _map(
                    lambda c: adjoint.filter_hw22_adj(*c, *f), cot)
            syn = ((q[3], q[2]), (q[7], q[6]))
            return lambda cot: _map(lambda c: hw.ifilt_sum_hw22(*c, *syn),
                                    cot)
        return linearize.dispatch(run, g, adj)

    def _hw_merge(self, V, level1: bool):
        """The (H, W) synthesis stage pair of each shard in one launch
        (``hw.filter_sum_hw22`` at level 1, ``hw.ifilt_sum_hw22`` after)
        of the four grids *V* (``v00, v01, v10, v11``).  Its adjoint is
        ``adjoint.filter_sum_hw22_adj`` or ``hw.dfilt_hw22``."""
        b, q = self.biort, self.qshift
        name, f = (("filter_sum_hw22", (b[1], b[3])) if level1
                   else ("ifilt_sum_hw22", ((q[3], q[2]), (q[7], q[6]))))

        def run(grid, plain):
            fn = linearize.entry(hw, name, plain)
            return _map(lambda t: fn(*t, *f), grid)

        def adj():
            x = V[0][0][0]
            if not adjoint.explicit_route(b, q, x.dtype):
                return None
            if level1:
                if min(x.shape[-2:]) < adjoint.fold_width(*f):
                    return None
                return lambda cot: _map(
                    lambda y: adjoint.filter_sum_hw22_adj(y, *f), cot)
            ana = ((q[1], q[0]), (q[5], q[4]))
            return lambda cot: _map(lambda y: tuple(
                u for row in hw.dfilt_hw22(y, *ana) for u in row), cot)
        return linearize.dispatch(run, _map(lambda *v: v, *V), adj)

    def _replicated_level(self, g, level: int, planes: bool):
        """A forward level of the gathered volume (the grid *g* of one
        shard) as :class:`Transform3d` runs it: ``(lowpass, subbands)``.
        Its adjoint is the level's piece of Transform3d's explicit
        adjoint, for odd filters and a pad-free level."""
        single3 = self._single
        step = single3._level1_fwd if level == 0 else single3._level2_fwd

        def run(grid, plain):
            lll, hp = step(grid[0][0], planes, plain)
            return [[(lll,) + (tuple(hp) if planes else (hp,))]]

        def adj():
            x = g[0][0]
            if not adjoint.explicit_route(self.biort, self.qshift, x.dtype):
                return None
            if level == 0:
                if min(x.shape[-3:]) < adjoint.fold_width(self.biort[0],
                                                          self.biort[2]):
                    return None
                piece = single3._level1_fwd_adj
            else:
                if any(s % self.ext_mode for s in x.shape[-3:]):
                    return None
                piece = single3._level2_fwd_adj
            # the subbands' gradient as _levels gives it: (re, im) planes
            # or (complex, None)
            return lambda cot: [[piece(cot[0][0][0], cot[0][0][1:] if planes
                                       else (cot[0][0][1], None))]]
        lll, *hp = linearize.dispatch(run, g, adj)[0][0]
        return lll, tuple(hp) if planes else hp[0]

    # ------------------------------------------------------------------
    # inverse
    # ------------------------------------------------------------------
    def inverse(self, pyramid):
        """Inverse transform of a :class:`Pyramid` or a 3-D
        :class:`PlanePyramid` (bfloat16 planes reconstruct to bfloat16)."""
        planes = isinstance(pyramid, PlanePyramid)
        on = lambda t: None if t is None else torch.as_tensor(
            t, device=self._first)
        if planes:
            levels = [None if r is None else (on(r), on(i)) for r, i in
                      zip(pyramid.highpasses_re, pyramid.highpasses_im)]
            # shapes in the interleaved [..., D, H, W, 28] convention
            shapes = [None if lv is None else tuple(lv[0].shape[:-4])
                      + tuple(lv[0].shape[-3:]) + (28,) for lv in levels]
        else:
            levels = [on(h) for h in pyramid.highpasses]
            shapes = [None if h is None else tuple(h.shape) for h in levels]
        nlevels = len(levels)
        low = on(pyramid.lowpass)
        if nlevels == 0:
            return low
        low_shape = tuple(low.shape)
        plan = self._inverse_plan(low_shape, shapes, nlevels, -3,
                                  self._ndepth)
        rplan = self._inverse_plan(low_shape, shapes, nlevels, -2,
                                   self._nrows)
        if not plan[0] and not rplan[0]:
            if self._ndepth > 1 or self._nrows > 1:
                logger.warning(
                    "ShardedTransform3d.inverse: pyramid shapes (lowpass %s)"
                    " cannot be sharded over the %s mesh — running the"
                    " inverse replicated on every device.", low_shape,
                    self.mesh.shape)
            return self._single.inverse(pyramid)
        if low_shape[0] % self._ndata:
            raise ValueError("batch %d does not split over the %d devices of "
                             "the data axis" % (low_shape[0], self._ndata))
        b = low_shape[0] // self._ndata

        def grid(t, a, level, ddim, rdim):
            return self._scatter(t.narrow(0, a * b, b), a, plan[level],
                                 rplan[level], ddim, rdim)

        def bands(level, a):
            lv = levels[level]
            if lv is None:
                return None
            if planes:
                return _map(lambda u, v: (u, v), grid(lv[0], a, level, -3, -2),
                            grid(lv[1], a, level, -3, -2))
            return grid(lv, a, level, -4, -3)

        out = [self._inverse_slice(
            grid(compute_view(low), a, nlevels - 1, -3, -2),
            [bands(level, a) for level in range(nlevels)], a, shapes, plan,
            rplan, low.dtype) for a in range(self._ndata)]
        return self._whole(out, -3, -2)

    def _inverse_slice(self, Yl, bands, a, shapes, plan, rplan, sdt):
        """One batch slice: its lowpass grid and per-level subband grids to
        the grid of the reconstruction."""
        nlevels = len(bands)
        g0o, g1o = self.biort[1], self.biort[3]
        q = self.qshift
        p0, p1 = (q[3], q[2]), (q[7], q[6])
        halo1 = _round8(max(g0o.size // 2, g1o.size // 2))
        halo2 = _round8(max(q[2].size // 2, q[6].size // 2))
        crop = 1 if self.ext_mode == 4 else 2

        def merge(va, vb, axis, on, level1):
            """One stage's branch merge along *axis*: the biort filters
            (level 1) or the qshift pairs."""
            if level1:
                return self._merge(va, vb, axis, on, halo1, "filter2_sum",
                                   g0o, g1o)
            return self._merge(va, vb, axis, on, halo2, "ifilt2_sum", p0, p1)

        def synth(octs, d_on, r_on, level1):
            if r_on:
                # rows-sharded: the reference pass order H, D, W
                U = {(i, k): merge(octs[(i, 0, k)], octs[(i, 1, k)], -2,
                                   True, level1)
                     for i in range(2) for k in range(2)}
                V = [merge(U[(0, k)], U[(1, k)], -3, d_on, level1)
                     for k in range(2)]
                return merge(V[0], V[1], -1, False, level1)
            # rows local: the depth merges, then the (H, W) merge of each
            # shard in one launch
            V = [merge(octs[(0, j, k)], octs[(1, j, k)], -3, d_on, level1)
                 for j in range(2) for k in range(2)]
            return self._hw_merge(V, level1)

        def unpack(g):
            per = _map(pack3d.unpack_octants, g)
            return {o: _map(lambda d: d[o], per) for o in _OCTANTS}

        d_on, r_on = plan[-1], rplan[-1]
        for level in range(nlevels - 1, 0, -1):
            curr = shapes[level][-4:-1]
            prev = (shapes[level - 1][-4:-1] if shapes[level - 1] is not None
                    else tuple(2 * s for s in curr))
            octs = unpack(bands[level])
            octs[(0, 0, 0)] = Yl
            Yl = synth(octs, d_on, r_on, False)
            # the ext_mode crops (reference rule: where 2 curr != prev), on
            # local axes only: the plans shard no level that crops
            for d, ax, local in ((0, -3, not d_on), (1, -2, not r_on),
                                 (2, -1, True)):
                if local and 2 * curr[d] != prev[d]:
                    Yl = _map(lambda v: v.narrow(ax, crop,
                                                 v.shape[ax] - 2 * crop), Yl)
            Yl = _map(lambda v: compute_view(v.to(sdt)).contiguous(), Yl)
            if not d_on and plan[level - 1]:
                Yl, d_on = self._reshard(Yl, a, -3), True
            if not r_on and rplan[level - 1]:
                Yl, r_on = self._reshard(Yl, a, -2), True
        if bands[0] is None:
            # discard_level_1: the lowpass synthesis alone, H, D, W
            def lowpass(g, axis, on):
                return self._pass(g, axis, on, halo1, "filter", single, g0o)
            Yl = lowpass(lowpass(lowpass(Yl, -2, r_on), -3, d_on), -1, False)
        else:
            octs = unpack(bands[0])
            octs[(0, 0, 0)] = Yl
            Yl = synth(octs, d_on, r_on, True)
        return _map(lambda v: v.to(sdt), Yl)
