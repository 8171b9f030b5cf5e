"""Sharded execution over a device mesh (``dtcwt_tpu.parallel``): meshes of
``torch.device``, halo exchange, the row- (and column-) sharded 2-D, the
signal-sharded 1-D and the depth-sharded 3-D transforms, batch data
parallelism for any transform, and registration with its pixels split
over the rows of a mesh.

The JAX package runs one program over a ``jax.sharding.Mesh`` with
``shard_map``; here one process holds each shard as a tensor on its mesh
device and moves halos by device-to-device copies.  A mesh may repeat a
device, so ``make_mesh((1, 8), ("data", "depth"), ["cpu"] * 8)`` runs the
JAX tests' eight-device layout on a CPU and ``["cuda"] * 4`` a four-shard
program on one card.  Importing this package builds nothing.
"""

from dtcwt_tpu_torch.parallel.halo import halo_exchange
from dtcwt_tpu_torch.parallel.mesh import Mesh, make_mesh
from dtcwt_tpu_torch.parallel.transform2d_dist import ShardedTransform2d
from dtcwt_tpu_torch.parallel.batch import BatchSharded, shard_batch
from dtcwt_tpu_torch.parallel.transform1d_dist import ShardedTransform1d
from dtcwt_tpu_torch.parallel.transform3d_dist import ShardedTransform3d
from dtcwt_tpu_torch.parallel.registration_dist import (
    estimatereg_sharded, shard_pyramid_rows)

__all__ = ["make_mesh", "Mesh", "halo_exchange", "ShardedTransform1d",
           "ShardedTransform2d", "ShardedTransform3d", "BatchSharded",
           "shard_batch", "estimatereg_sharded", "shard_pyramid_rows"]
