"""Moving pyramids between numpy and the port.

The transform has no learned weights: its parameters are the filter tuples
(named families, or explicit tuples of numpy arrays given to
``Transform2d(biort=..., qshift=...)``), and its state is the pyramid.  These
functions carry a pyramid across the numpy boundary in both directions, for
both containers, keeping each leaf's dtype, so that a pyramid made elsewhere
(for example by the JAX package) can be inverted here and the reverse.
"""

from __future__ import annotations

import numpy as np
import torch

from dtcwt_tpu_torch.transforms.pyramid import PlanePyramid, Pyramid

__all__ = ["pyramid_from_numpy", "pyramid_to_numpy"]


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)     # a writable host copy
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (ml_dtypes provides it): move the
        # bits and reinterpret them
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(p, fn):
    """*p*'s container with *fn* applied to every leaf; ``None`` leaves (the
    first level of a ``discard_level_1`` pyramid) stay ``None``."""
    f = lambda a: None if a is None else fn(a)
    scales = None if p.scales is None else tuple(f(s) for s in p.scales)
    if hasattr(p, "highpasses_re"):
        return PlanePyramid(f(p.lowpass),
                            tuple(f(r) for r in p.highpasses_re),
                            tuple(f(i) for i in p.highpasses_im), scales,
                            kind=getattr(p, "kind", "2d"))
    return Pyramid(f(p.lowpass), tuple(f(h) for h in p.highpasses), scales)


def pyramid_from_numpy(p, device="cuda"):
    """A :class:`Pyramid` or :class:`PlanePyramid` of tensors on *device*
    (the card unless the caller asks for ``"cpu"``) from any object with
    the container's attributes whose leaves convert to numpy arrays
    (``highpasses_re`` present means a plane pyramid, whose ``kind``, 1-D,
    2-D or 3-D, is kept)."""
    return _map(p, lambda a: _to_tensor(a, device))


def pyramid_to_numpy(p):
    """The same container with every leaf a numpy array on the host."""
    return _map(p, _to_numpy)
