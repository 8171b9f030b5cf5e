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
"""

from __future__ import annotations

from typing import List

import torch

from dtcwt_tpu_torch.ops import dual
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

    def _exchange(self, g, n: int, axis: int):
        """Every shard extended by *n* samples a side of *axis*: the outer
        axis over the outer shards, the inner one over the inner shards."""
        if axis != self._outer_dim:
            return [halo_exchange(row, n, axis) for row in g]
        cols = [halo_exchange([row[c] for row in g], n, axis)
                for c in range(len(g[0]))]
        return [[col[r] for col in cols] for r in range(len(g))]

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
        shards extended by *halo* where *on*, else its own reflection."""
        if on:
            fn = getattr(mod, name + "_fromext_axis")
            return _map(lambda e: fn(e, halo, *f, axis),
                        self._exchange(g, halo, axis))
        fn = getattr(mod, name + "_axis")
        return _map(lambda v: fn(v.contiguous(), *f, axis), g)

    def _merge(self, ga, gb, axis: int, on: bool, halo: int, name: str, *f):
        """A synthesis stage's branch merge, ``dual.<name>`` of two grids,
        as :meth:`_pass` runs one entry."""
        if on:
            fn = getattr(dual, name + "_fromext_axis")
            return _map(lambda u, v: fn(u, v, halo, *f, axis),
                        self._exchange(ga, halo, axis),
                        self._exchange(gb, halo, axis))
        fn = getattr(dual, name + "_axis")
        return _map(lambda u, v: fn(u.contiguous(), v.contiguous(), *f,
                                    axis), ga, gb)
