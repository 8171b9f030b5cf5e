"""The shard grid the sharded transforms share: one batch slice of a global
tensor held as ``g[i][j]``, *i* over the shards of the mesh axis that
splits the outer spatial axis, *j* over those of the axis that splits the
inner one, one of either where that axis runs replicated.

The JAX package's collectives map onto the grid as its one-process
counterparts: an ``all_gather`` is a concatenation on the axis's first
device (:meth:`GridShards._gather`), a re-shard a ``narrow`` per shard
(:meth:`GridShards._reshard`), a halo exchange
:func:`~.halo.halo_exchange` over the shards of one axis
(:meth:`GridShards._exchange`); results are assembled on the mesh's first
device (:meth:`GridShards._whole`).  A filter pass along one axis of every
shard (:meth:`GridShards._pass`, :meth:`GridShards._merge`) reads the
exchanged halos where the axis is sharded and the kernel's own reflection
where it is not.

Gradients: on the card, where grad mode is on and a shard requires grad,
each pass runs as one linear ``torch.autograd.Function`` over the grid's
shards (``ops.linearize.dispatch``); the glue between the passes (the
scatters, gathers, packs, pads, crops and casts) stays PyTorch operators
that autograd differentiates.  The backward is chosen from the
configuration before the pass runs (:meth:`GridShards._adjoint_of`): the
opposite sharded pass on the kernels (a qshift ``dfilt2`` pass and the
``ifilt2_sum`` merge are each other's adjoint, qshift orthogonality of
the whole axis, each at its own halo; the level-1 ``filter2`` pass and
``filter2_sum`` merge take the zero-end exchange, the other's kernel with
the reversed filters and the border fold at the whole axis's ends), or
the plain route, ``torch.func.vjp`` of the pass on the plain versions:
the single-stream passes, families outside
``ops.adjoint.explicit_route``, a local extent shorter than the fold or
the adjoint's halo.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from dtcwt_tpu_torch.ops import adjoint, dual, linearize
from dtcwt_tpu_torch.parallel.halo import halo_exchange


def _round8(n: int) -> int:
    """Halo widths, rounded up to a multiple of 8 as the JAX package rounds
    them; the plans' minimum extents follow."""
    return -(-n // 8) * 8


def _axis_plan(extent: int, R: int, nlevels: int, halo1: int,
               halo2: int) -> List[bool]:
    """Per level: does the filter pass along an axis of global *extent*
    run sharded over a mesh axis of *R* devices?  Follows the level shapes
    of the 1-D and 2-D transforms (odd-size duplication, per-level
    multiple-of-4 pads; ``dtcwt_tpu/parallel/transform2d_dist.py:63-85``,
    ``transform1d_dist.py:108-130``), with halo widths *halo1* (level 1)
    and *halo2* as exchanged.  A one-device axis shards nothing."""
    plan = []
    n = extent + (extent % 2)
    sharded = R > 1 and extent % 2 == 0    # an odd global size cannot shard
    nl = n
    for level in range(nlevels):
        if level == 0:
            sharded = (sharded and n % R == 0 and (n // R) % 2 == 0
                       and (n // R) >= halo1)
        else:
            need_pad = nl % 4 != 0
            sharded = (sharded and not need_pad and nl % R == 0
                       and (nl // R) % 4 == 0 and (nl // R) >= halo2)
            if need_pad:
                nl += 2
            nl >>= 1
        plan.append(sharded)
    return plan


def _map(fn, *grids):
    """*fn* on each shard of one or more grids of one shape."""
    return [[fn(*(g[r][c] for g in grids)) for c in range(len(grids[0][0]))]
            for r in range(len(grids[0]))]


def _unzip(g, n: int):
    """A grid of n-tuples as n grids."""
    return tuple(_map(lambda t: t[i], g) for i in range(n))


def _cat(ts, dim: int):
    return ts[0] if len(ts) == 1 else torch.cat(ts, dim=dim)


def _same_filters(f, g) -> bool:
    """Whether the nests of filter taps *f* and *g* hold equal taps."""
    if isinstance(f, (tuple, list)):
        return (isinstance(g, (tuple, list)) and len(f) == len(g)
                and all(_same_filters(a, b) for a, b in zip(f, g)))
    return np.array_equal(np.ravel(f), np.ravel(g))


class GridShards:
    """The grid methods of a sharded transform over *mesh*: batch slices
    over *data_axis*, the tensor axis *outer_dim* over *outer_axis* and the
    axis after it over *inner_axis* (None: not sharded)."""

    def _init_grid(self, mesh, data_axis: str, outer_axis: str,
                   inner_axis, outer_dim: int) -> None:
        self._grid_axes = (data_axis, outer_axis, inner_axis)
        self._ndata = mesh.shape[data_axis]
        self._nouter = mesh.shape[outer_axis]
        self._ninner = mesh.shape[inner_axis] if inner_axis is not None else 1
        self._outer_dim = outer_dim
        self._first = mesh.devices.flat[0]

    def _device(self, a: int, r: int, c: int) -> torch.device:
        """The device of data slice *a*, outer shard *r*, inner shard *c*
        (index 0 of any other mesh axis)."""
        data, outer, inner = self._grid_axes
        pos = {data: a, outer: r}
        if inner is not None:
            pos[inner] = c
        return self.mesh.devices[tuple(pos.get(n, 0)
                                       for n in self.mesh.axis_names)]

    def _scatter(self, x, a, o_on, i_on, odim=None, idim=None):
        """Batch slice *a* of a global tensor as its grid: split along
        *odim* (default the outer axis) over the outer shards and along
        *idim* (default the axis after it) over the inner shards where
        those are on."""
        odim = self._outer_dim if odim is None else odim
        idim = odim + 1 if idim is None else idim
        split = lambda t, dim, n: t.split(t.shape[dim] // n, dim)
        return [[t.to(self._device(a, r, c)).contiguous()
                 for c, t in enumerate(split(part, idim,
                                             self._ninner if i_on else 1))]
                for r, part in enumerate(split(x, odim,
                                               self._nouter if o_on else 1))]

    def _exchange(self, g, n: int, axis: int, zero_ends: bool = False):
        """Every shard extended by *n* samples a side of *axis*: the outer
        axis over the outer shards, the inner one over the inner shards;
        with *zero_ends* zeros beyond the whole axis's ends."""
        if axis != self._outer_dim:
            return [halo_exchange(row, n, axis, zero_ends) for row in g]
        cols = [halo_exchange([row[c] for row in g], n, axis, zero_ends)
                for c in range(len(g[0]))]
        return [[col[r] for col in cols] for r in range(len(g))]

    def _ends_map(self, fn, axis: int, *grids):
        """``fn(front, back, *shards)`` on each shard of *grids*: *front*
        and *back* tell whether its ends along *axis* are the whole
        axis's."""
        rows, cols = len(grids[0]), len(grids[0][0])

        def ends(r, c):
            i, n = (r, rows) if axis == self._outer_dim else (c, cols)
            return i == 0, i == n - 1
        return [[fn(*ends(r, c), *(g[r][c] for g in grids))
                 for c in range(cols)] for r in range(rows)]

    def _gather(self, g, axis: int):
        """The shards joined along *axis* on the axis's first device."""
        if axis == self._outer_dim:
            return [[_cat([row[c].to(g[0][c].device) for row in g], axis)
                     for c in range(len(g[0]))]]
        return [[_cat([t.to(row[0].device) for t in row], axis)]
                for row in g]

    def _reshard(self, g, a: int, axis: int):
        """A grid replicated along *axis* split over that axis's shards."""
        if axis == self._outer_dim:
            n = g[0][0].shape[axis] // self._nouter
            return [[t.narrow(axis, r * n, n).to(self._device(a, r, c))
                     .contiguous() for c, t in enumerate(g[0])]
                    for r in range(self._nouter)]
        n = g[0][0].shape[axis] // self._ninner
        return [[row[0].narrow(axis, c * n, n).to(self._device(a, r, c))
                 .contiguous() for c in range(self._ninner)]
                for r, row in enumerate(g)]

    def _whole(self, grids, odim: int, idim: int):
        """The grids of every batch slice as one tensor on the first
        device."""
        return _cat([_cat([_cat([t.to(self._first) for t in row], idim)
                           for row in g], odim) for g in grids], 0)

    def _pass(self, g, axis: int, on: bool, halo: int, name: str, mod, *f):
        """Entry *name* of *mod* (``dual`` or ``single``) with filters *f*
        along *axis* of each shard of *g*: its from-extension form on the
        shards extended by *halo* where *on*, else its own reflection.  On
        the card, with a shard that requires grad, one linear Function
        whose backward :meth:`_adjoint_of` chooses."""
        return linearize.dispatch(
            lambda grid, plain: self._pass_run(grid, axis, on, halo, name,
                                               mod, f, plain),
            g, lambda: self._adjoint_of(name, mod, g, axis, on, f))

    def _merge(self, ga, gb, axis: int, on: bool, halo: int, name: str, *f):
        """A synthesis stage's branch merge, ``dual.<name>`` of two grids,
        as :meth:`_pass` runs one entry (the Function's operand is the
        grid of the shard pairs)."""
        return linearize.dispatch(
            lambda grid, plain: self._merge_run(grid, axis, on, halo, name,
                                                f, plain),
            _map(lambda u, v: (u, v), ga, gb),
            lambda: self._adjoint_of(name, dual, ga, axis, on, f))

    def _pass_run(self, g, axis, on, halo, name, mod, f, plain=False):
        """:meth:`_pass` itself, on the entries or (*plain*) their plain
        versions."""
        if on:
            fn = linearize.entry(mod, name + "_fromext_axis", plain)
            return _map(lambda e: fn(e, halo, *f, axis),
                        self._exchange(g, halo, axis))
        fn = linearize.entry(mod, name + "_axis", plain)
        return _map(lambda v: fn(v.contiguous(), *f, axis), g)

    def _merge_run(self, g, axis, on, halo, name, f, plain=False):
        """:meth:`_merge` itself on the grid *g* of shard pairs."""
        ga, gb = _unzip(g, 2)
        if on:
            fn = linearize.entry(dual, name + "_fromext_axis", plain)
            return _map(lambda u, v: fn(u, v, halo, *f, axis),
                        self._exchange(ga, halo, axis),
                        self._exchange(gb, halo, axis))
        fn = linearize.entry(dual, name + "_axis", plain)
        return _map(lambda u, v: fn(u.contiguous(), v.contiguous(), *f,
                                    axis), ga, gb)

    def _adjoint_of(self, name: str, mod, g, axis: int, on: bool, f):
        """The explicit adjoint of one pass or merge (*name* of *mod* with
        filters *f* along *axis* of grids shaped like *g*): a map from the
        result's gradient grid to the operand's, on the kernels; or None,
        the plain route.  Chosen from the filters, the dtype and the local
        extents alone, before the pass runs."""
        x = g[0][0]
        if mod is not dual or not adjoint.explicit_route(
                self.biort, self.qshift, x.dtype):
            return None
        n = x.shape[axis]
        q = self.qshift
        ana = ((q[1], q[0]), (q[5], q[4]))
        syn = ((q[3], q[2]), (q[7], q[6]))
        if name in ("filter2", "filter2_sum"):
            # the fold reads a border of half the longer filter
            if n < adjoint.fold_width(*f):
                return None
            return lambda cot: self._level1_adjoint(cot, name, axis, on, f)
        if name == "dfilt2" and _same_filters(f, ana):
            halo = _round8(max(v.size // 2 for v in (q[2], q[6])))
            if on and n // 2 < halo:
                return None
            return lambda cot: self._merge_run(cot, axis, on, halo,
                                               "ifilt2_sum", syn)
        if name == "ifilt2_sum" and _same_filters(f, syn):
            halo = _round8(max(q[0].size, q[4].size))
            if on and 2 * n < halo:
                return None
            return lambda cot: self._pass_run(cot, axis, on, halo,
                                              "dfilt2", dual, ana)
        return None

    def _level1_adjoint(self, cot, name: str, axis: int, on: bool, f):
        """The adjoint of a level-1 ``filter2`` pass (*cot*: the grid of
        its output pairs' gradients, to the input's) or ``filter2_sum``
        merge (the output's gradient, to the pairs'): along a sharded
        axis each cotangent shard extended by the fold's width with zeros
        beyond the whole axis's ends, the other entry's kernel on the
        reversed filters and the border fold at those ends alone."""
        p = adjoint.fold_width(*f)
        if name == "filter2":
            ya, yb = _unzip(cot, 2)
            if not on:
                return _map(lambda u, v: adjoint.filter2_sum_adj_axis(
                    u, v, *f, axis), ya, yb)
            return self._ends_map(
                lambda front, back, ea, eb, u, v:
                adjoint.filter2_sum_adj_fromext(ea, eb, u, v, p, *f, axis,
                                                front, back), axis,
                self._exchange(ya, p, axis, True),
                self._exchange(yb, p, axis, True), ya, yb)
        if not on:
            return _map(lambda y: adjoint.filter2_adj_axis(y, *f, axis), cot)
        return self._ends_map(
            lambda front, back, e, y: adjoint.filter2_adj_fromext(
                e, y, p, *f, axis, front, back), axis,
            self._exchange(cot, p, axis, True), cot)
