"""Halo exchange for filter passes along a sharded axis
(``dtcwt_tpu.parallel.halo``).

Every filter reads a symmetric extension of its input.  Where the filtered
axis is split over shards, an interior shard boundary takes the
neighbouring shard's edge samples instead of a reflection, and only the two
physical ends keep the reflect-with-repeated-end-samples rule.  The result
is what ``fb.symmetric_extend`` of the whole axis holds at each shard's
place.  With *zero_ends* the two physical ends take zeros instead: the
zero extension of the whole axis, which the sharded level-1 adjoints
(:mod:`.._grid`) correlate before they fold the ends.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from dtcwt_tpu_torch.ops import fb

__all__ = ["halo_exchange"]


def halo_exchange(shards: Sequence[torch.Tensor], n: int,
                  axis: int = -2, zero_ends: bool = False
                  ) -> List[torch.Tensor]:
    """Extend each of *shards*, the local tensors along one mesh axis in
    mesh order, by *n* samples a side of *axis*: an interior side gets the
    neighbour's edge samples, copied to the shard's device; the first and
    last shards reflect their outer edge, or with *zero_ends* take *n*
    zeros there.  *n* may not exceed a shard's extent along *axis*."""
    shards = list(shards)
    if n == 0:
        return shards
    for x in shards:
        if n > x.shape[axis]:
            raise ValueError(
                "halo width %d exceeds local extent %d of axis %d; use fewer "
                "shards or gather the axis" % (n, x.shape[axis], axis))
    if len(shards) == 1 and not zero_ends:
        return [fb.symmetric_extend(shards[0], n, axis)]
    first = lambda x: x.narrow(axis, 0, n)
    last = lambda x: x.narrow(axis, x.shape[axis] - n, n)
    end = ((lambda edge: torch.zeros_like(edge)) if zero_ends
           else (lambda edge: edge.flip(axis)))
    out = []
    for i, x in enumerate(shards):
        top = (end(first(x)) if i == 0
               else last(shards[i - 1]).to(x.device))
        bot = (end(last(x)) if i == len(shards) - 1
               else first(shards[i + 1]).to(x.device))
        out.append(torch.cat([top, x, bot], dim=axis))
    return out
