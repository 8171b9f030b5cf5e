"""Shared helpers: the symmetric-reflection index map and the compute view
of bfloat16 storage (``dtcwt_tpu.utils.reflect`` and ``compute_view``)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["reflect", "compute_view"]


def reflect(x, minx, maxx):
    """Reflect values of *x* into ``[minx, maxx]`` by repeated folding at the
    two endpoints (a triangle-wave index map).

    With integer *x* and half-integer bounds this is symmetric extension
    *with repeated end samples*, the boundary rule of every filter in the
    transform, for any extension width (also wider than the signal).  Works
    on numpy arrays, which is how the index maps are built.
    """
    x = np.asarray(x)
    rng = maxx - minx
    rng2 = 2.0 * rng
    mod = np.fmod(x - minx, rng2)
    mod = np.where(mod < 0, mod + rng2, mod)
    out = np.where(mod >= rng, rng2 - mod, mod) + minx
    return out.astype(x.dtype)


def compute_view(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 is a storage type: the arithmetic runs in float32, as the
    kernels accumulate in float32.  Identity for every other dtype."""
    return x.float() if x.dtype == torch.bfloat16 else x
