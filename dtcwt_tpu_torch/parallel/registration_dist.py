"""DTCWT image registration with the pyramid pixels split over the rows of a
device mesh (``dtcwt_tpu.parallel.registration_dist``,
``dtcwt_tpu/parallel/registration_dist.py:1-124``).

The estimator's pixel-parallel work is the Qtilde accumulation: per pixel,
27-element outer products over the six subbands of a level, reduced to one
global 27-vector for the first solve and box-filtered as fields after.  The
JAX package places the pyramid row-sharded and lets GSPMD split that work;
here each row shard computes the Qtilde field of its own rows on its
device.  A shard's field is not that of a cut-out image: the phase
gradients along y and the confidence read the neighbouring rows, and the
grid's y coordinate is the global row.  So each interior side of a shard
takes one neighbour row (not a reflection), the field is computed on that
extended block with its rows at their global coordinates, and the extra
rows are dropped; only the two physical ends keep the edge rules.  The
first solve's per-shard sums are reduced on the mesh's first device; the
warp, the box filter, the rescale and the 6x6 solves run there on the
gathered fields, on :func:`registration._estimatereg`'s schedule.  A level
whose row count does not divide the rows axis runs on the first device.
Nothing is read back to the host.
"""

from __future__ import annotations

import logging

import torch

from dtcwt_tpu_torch import registration as _reg
from dtcwt_tpu_torch.parallel.batch import _axis_devices
from dtcwt_tpu_torch.sampling import _tensor
from dtcwt_tpu_torch.transforms.pyramid import PlanePyramid, Pyramid

__all__ = ["estimatereg_sharded", "shard_pyramid_rows"]

logger = logging.getLogger(__name__)


def shard_pyramid_rows(pyr, mesh, rows_axis: str = "rows"):
    """One :class:`Pyramid` per device of *rows_axis* of *mesh*, in mesh
    order: the row slice of each leaf (highpasses ``[H', W', 6]``, lowpass
    and scales ``[H, W]``) whose row count divides the axis, the whole leaf
    otherwise, on the shard's device.  A lowpass or highpass that is not
    sliced although it has at least ``4 * R`` rows (a real loss of
    parallelism, not a tiny coarse level) logs a warning.  A
    :class:`PlanePyramid` is taken through :meth:`~PlanePyramid.interleaved`.
    """
    if isinstance(pyr, PlanePyramid):
        pyr = pyr.interleaved()
    devices = _axis_devices(mesh, rows_axis)
    R = len(devices)

    def put(a, what=None):
        if a is None:
            return [None] * R
        a = _tensor(a, devices[0])
        if a.shape[0] % R == 0:
            n = a.shape[0] // R
            return [a.narrow(0, r * n, n).to(d).contiguous()
                    for r, d in enumerate(devices)]
        if what is not None and a.shape[0] >= 4 * R:
            logger.warning(
                "shard_pyramid_rows: %s with %d rows does not divide the "
                "%d-shard %r mesh axis — it runs replicated (degraded "
                "sharding). Pad the image so every level's row count "
                "divides the mesh.", what, a.shape[0], R, rows_axis)
        return [a.to(d) for d in devices]

    low = put(pyr.lowpass, "lowpass")
    hps = [put(h, "highpass level %d" % i)
           for i, h in enumerate(pyr.highpasses)]
    scales = None if pyr.scales is None else [put(s) for s in pyr.scales]
    return [Pyramid(low[r], tuple(h[r] for h in hps),
                    None if scales is None else tuple(s[r] for s in scales))
            for r in range(R)]


def _blocks(parts):
    """Each row slice of *parts* (in mesh order, each on its device) with
    one neighbouring row on each interior side: (block, rows added above)."""
    out = []
    for r, p in enumerate(parts):
        top = ([parts[r - 1].narrow(0, parts[r - 1].shape[0] - 1, 1)
                .to(p.device)] if r > 0 else [])
        bot = ([parts[r + 1].narrow(0, 0, 1).to(p.device)]
               if r < len(parts) - 1 else [])
        out.append((torch.cat(top + [p] + bot, dim=0), len(top)))
    return out


def _qtilde_rows(parts1, parts2, height: int):
    """The Qtilde field of each row slice pair (``[n, M, 6]`` subbands on
    the shards' devices) of a level of *height* rows, as the whole level's
    field holds it at those rows."""
    out, y0 = [], 0
    for p, (b1, k), (b2, _) in zip(parts1, _blocks(parts1), _blocks(parts2)):
        q = _reg._qtilde_level(b1, b2, y0 - k, height)
        out.append(q.narrow(0, k, p.shape[0]))
        y0 += p.shape[0]
    return out


def estimatereg_sharded(source, reference, mesh, regshape=None, levels=None,
                        rows_axis: str = "rows"):
    """Estimate the registration of *source* onto *reference* with the
    Qtilde accumulation split over the row shards of ``mesh[rows_axis]``.

    *source* / *reference* are single-image :class:`Pyramid` (or plane
    layout :class:`PlanePyramid`) objects; their leaves are placed with
    :func:`shard_pyramid_rows`.  Returns the ``NxMx6`` field of
    :func:`registration.estimatereg` on the mesh's first device."""
    if isinstance(source, PlanePyramid):
        source = source.interleaved()
    if isinstance(reference, PlanePyramid):
        reference = reference.interleaved()
    first = mesh.devices.flat[0]
    src_parts = shard_pyramid_rows(source, mesh, rows_axis)
    ref_parts = shard_pyramid_rows(reference, mesh, rows_axis)
    src, ref = _reg._pyramid(source, first), _reg._pyramid(reference, first)
    avecs_shape = _reg._avecs_shape(src, regshape, 0, "estimatereg_sharded")
    levels = _reg._levels(levels, len(src.highpasses))
    devices = _axis_devices(mesh, rows_axis)
    R = len(devices)

    def parts(hp, whole, placed, level):
        """The row slices of one level's subbands on the shards' devices:
        the *placed* shards' where *hp* is the *whole* pyramid's leaf (a
        level the refinement did not warp), else *hp* split."""
        if hp is whole.highpasses[level]:
            return [p.highpasses[level] for p in placed]
        n = hp.shape[0] // R
        return [hp.narrow(0, r * n, n).to(d).contiguous()
                for r, d in enumerate(devices)]

    def qtilde(s, r, lv, total):
        out = []
        for level in lv:
            a, b = s.highpasses[level], r.highpasses[level]
            if a.shape[0] % R:
                # the level runs replicated, on the first device
                q = _reg._qtilde_level(a, b)
                out.append(q.sum(dim=(0, 1)) if total else q)
                continue
            qs = _qtilde_rows(parts(a, src, src_parts, level),
                              parts(b, ref, ref_parts, level),
                              a.shape[0])
            if total:
                out.append(sum(q.sum(dim=(0, 1)).to(first) for q in qs))
            else:
                out.append(torch.cat([q.to(first) for q in qs], dim=0))
        return out

    return _reg._estimatereg(src, ref, avecs_shape, levels, 0, qtilde)
