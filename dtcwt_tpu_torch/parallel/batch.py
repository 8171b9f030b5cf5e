"""Batch data-parallelism for any transform over a device mesh
(``dtcwt_tpu.parallel.batch``, ``dtcwt_tpu/parallel/batch.py:1-68``).

Every transform is batched over its leading axes and pointwise in them, so
data parallelism is a split of the batch over one mesh axis with no
communication between the slices.  In JAX that is one sharding annotation
on a global array; a one-process mesh has no global sharded tensor, so here
:func:`shard_batch` returns the list of the slices, each on its device, and
:class:`BatchSharded` runs the wrapped transform once per slice and joins
the results on the mesh's first device.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from dtcwt_tpu_torch.transforms.pyramid import PlanePyramid, Pyramid

__all__ = ["BatchSharded", "shard_batch"]


def _tree_map(fn, tree):
    """*fn* on every tensor leaf (numpy arrays as tensors) of a tensor, a
    pyramid or a nest of tuples, lists and dicts; None and other leaves
    stay as they are."""
    if isinstance(tree, np.ndarray):
        tree = torch.as_tensor(tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, PlanePyramid):
        return PlanePyramid(_tree_map(fn, tree.lowpass),
                            _tree_map(fn, tree.highpasses_re),
                            _tree_map(fn, tree.highpasses_im),
                            _tree_map(fn, tree.scales), kind=tree.kind)
    if isinstance(tree, Pyramid):
        return Pyramid(_tree_map(fn, tree.lowpass),
                       _tree_map(fn, tree.highpasses),
                       _tree_map(fn, tree.scales))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _leaves(tree):
    out = []
    _tree_map(out.append, tree)
    return out


def _axis_devices(mesh, axis: str):
    """The devices along *axis* of *mesh* in mesh order (index 0 of every
    other axis)."""
    k = mesh.axis_names.index(axis)
    idx = [0] * len(mesh.axis_names)
    out = []
    for i in range(mesh.shape[axis]):
        idx[k] = i
        out.append(mesh.devices[tuple(idx)])
    return out


def shard_batch(tree, mesh, axis: str = "data"):
    """The slices of *tree* (a tensor, a pyramid, or a nest of them whose
    tensor leaves share a leading batch axis) over the devices of *axis*
    of *mesh*, in mesh order: a list of trees, each leaf's leading-axis
    slice on its device.  Leaves of no dimension are copied to each.  A
    one-process mesh has no global sharded tensor, so where JAX returns
    one array placed over the mesh this returns the slices."""
    devices = _axis_devices(mesh, axis)
    n = len(devices)

    def part(i):
        def take(x):
            if x.ndim == 0:
                return x.to(devices[i])
            b = x.shape[0] // n
            return x.narrow(0, i * b, b).to(devices[i]).contiguous()
        return _tree_map(take, tree)
    return [part(i) for i in range(n)]


def _join(parts, device):
    """The slices' trees joined along the leading axis on *device*."""
    flat = [_leaves(p) for p in parts]
    it = iter(range(len(flat[0])))

    def cat(x):
        i = next(it)
        if x.ndim == 0:
            return x.to(device)
        return torch.cat([f[i].to(device) for f in flat], dim=0)
    return _tree_map(cat, parts[0])


class BatchSharded:
    """Run a transform data-parallel over the *axis* mesh axis.

    >>> mesh = make_mesh((8,), ("data",), ["cuda"] * 8)
    >>> t = BatchSharded(Transform2d(), mesh)
    >>> pyr = t.forward(frames, nlevels=3)      # frames: [N, H, W], N % 8 == 0
    >>> recon = t.inverse(pyr)

    *transform* is a :class:`Transform1d`, :class:`Transform2d`,
    :class:`Transform3d` or any object with ``forward`` / ``inverse`` over
    tensors or pyramids with a leading batch axis.  Each slice runs through
    a copy of the transform on the slice's device (where the transform has
    a ``device``; the port's transforms move their inputs there), cached
    per device; the results are joined on the mesh's first device.
    """

    def __init__(self, transform, mesh, axis: str = "data"):
        self.transform = transform
        self.mesh = mesh
        self.axis = axis
        self._copies = {}

    def _check(self, n: int):
        size = self.mesh.shape[self.axis]
        if n % size != 0:
            raise ValueError(
                "Batch size %d is not divisible by mesh axis %r of size %d"
                % (n, self.axis, size))

    def _on(self, device):
        """The transform for slices on *device*."""
        if not hasattr(self.transform, "device"):
            return self.transform
        if torch.device(self.transform.device) == device:
            return self.transform
        if device not in self._copies:
            t = copy.copy(self.transform)
            t.device = device
            self._copies[device] = t
        return self._copies[device]

    def _run(self, method: str, tree, args, kwargs):
        first = _leaves(tree)[0]
        self._check(first.shape[0])
        devices = _axis_devices(self.mesh, self.axis)
        parts = [getattr(self._on(d), method)(p, *args, **kwargs)
                 for d, p in zip(devices, shard_batch(tree, self.mesh,
                                                      self.axis))]
        return _join(parts, self.mesh.devices.flat[0])

    def forward(self, X, *args, **kwargs):
        return self._run("forward", torch.as_tensor(
            X, device=self.mesh.devices.flat[0]), args, kwargs)

    def inverse(self, pyramid, *args, **kwargs):
        return self._run("inverse", pyramid, args, kwargs)
