"""Count the tensor operations one sharded 3-D round trip issues, by the
entry that issues them, on the CPU.

    python tools/count_sharded_ops.py [--depth 256] [--shards 4]

On the card a kernel entry (``ops/hw``, ``ops/dual``) is one launch, so
the operations that cost host time there are the others: the octant
(un)packing, the halo exchanges and the moves of the shards.  This runs
``chip_smoke.py``'s sharded round trip, ``[1, depth, 32, 32]`` over a
``(1, shards)`` mesh of CPU devices, 3 levels, f32 interleaved, under
``torch.profiler``, and prints for each entry the number of operations
issued inside it and for "glue" those issued outside every entry (the
count depends on the depth and the mesh, through the plans, not on H and
W).
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dtcwt_tpu_torch.ops import dual, hw, pack3d  # noqa: E402
from dtcwt_tpu_torch.parallel import (  # noqa: E402
    ShardedTransform3d, make_mesh, transform3d_dist)

_TAG = "entry:"


def _tagged(mod, name):
    fn = getattr(mod, name)

    def run(*a, **k):
        with record_function(_TAG + name):
            return fn(*a, **k)
    setattr(mod, name, run)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--depth", type=int, default=256)
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args()
    for mod, names in ((hw, hw.__all__), (dual, dual.__all__)):
        for n in names:
            if not n.endswith("_reference"):
                _tagged(mod, n)
    for n in ("pack_octants", "unpack_octants", "fwd_level1_pack",
              "fwd_level2_pack", "inv_level1_pack", "inv_level2_pack"):
        _tagged(pack3d, n)
    _tagged(transform3d_dist, "halo_exchange")
    st = ShardedTransform3d(make_mesh((1, args.shards), ("data", "depth"),
                                      ["cpu"] * args.shards))
    x = torch.from_numpy(np.random.RandomState(31).rand(
        1, args.depth, 32, 32).astype(np.float32))
    st.inverse(st.forward(x, 3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st.inverse(st.forward(x, 3))
    events = prof.events()
    ranges = [e for e in events if e.name.startswith(_TAG)]

    def owner(e):
        inner = [r for r in ranges if r.time_range.start <= e.time_range.start
                 and e.time_range.end <= r.time_range.end]
        if not inner:
            return "glue"
        return min(inner, key=lambda r: r.time_range.elapsed_us()).name[
            len(_TAG):]

    ops = [e for e in events if e.name.startswith("aten::") and (
        e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]
    calls = collections.Counter(r.name[len(_TAG):] for r in ranges)
    counts = collections.Counter(owner(e) for e in ops)
    for name, n in counts.most_common():
        print("%-28s %6d operations in %4d calls" % (name, n,
                                                     calls.get(name, 0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
