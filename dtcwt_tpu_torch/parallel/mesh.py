"""Device meshes (``dtcwt_tpu.parallel.mesh``).

A :class:`Mesh` is the counterpart of ``jax.sharding.Mesh`` in one process:
an array of ``torch.device`` with a name per axis.  A sharded transform
keeps each shard as a tensor on its mesh device and moves halos between
shards by device-to-device copies.  A device may repeat: ``["cpu"] * 8``
stands in for eight devices on a CPU, and ``["cuda"] * 4`` runs a real
four-shard program on one card, which measures what the sharding costs,
not how it scales; on a node with several cards each shard can sit on a
card of its own.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh"]


class Mesh:
    """*devices*: an object array of ``torch.device``, one axis per name in
    *axis_names*.  ``shape[name]`` is that axis's size, as in JAX."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError("a %d-axis mesh needs %d axis names, got %r"
                             % (devices.ndim, devices.ndim, axis_names))
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        # raises where there is no card
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "rows"),
              devices=None) -> Mesh:
    """A :class:`Mesh` of *shape* over *devices* (default: every CUDA
    device, and raise where there is none).  ``shape=None`` puts every
    device on the first axis.  A device may repeat."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise RuntimeError("make_mesh: no CUDA device; pass devices="
                               "['cpu'] * n for a mesh on the CPU")
        devices = ["cuda:%d" % i for i in range(n)]
    devices = [_device(d) for d in devices]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != len(devices):
        raise ValueError("Mesh shape %r does not match %d devices"
                         % (tuple(shape), len(devices)))
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(shape)), axis_names)
