"""Shared helpers: the symmetric-reflection index map, the compute view of
bfloat16 storage, dtype rules, test-image generators, pyramid unpacking and
stacked matrix products (``dtcwt_tpu.utils`` without ``asnumpy`` /
``asdevice``, whose counterparts are ``convert.pyramid_to_numpy`` and
``.cpu()``).

The dtype helpers and the stacked products take tensors or numpy arrays
and return tensors: a tensor keeps its device, a numpy array becomes a CPU
tensor.  The test images are computed in float64 on *device*, the card
unless the caller asks for the CPU."""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "reflect", "asfarray", "appropriate_complex_type_for", "as_column_vector",
    "compute_view", "drawedge", "drawcirc", "unpack",
    "stacked_2d_matrix_vector_prod", "stacked_2d_vector_matrix_prod",
    "stacked_2d_matrix_matrix_prod",
]


def reflect(x, minx, maxx):
    """Reflect values of *x* into ``[minx, maxx]`` by repeated folding at the
    two endpoints (a triangle-wave index map).

    With integer *x* and half-integer bounds this is symmetric extension
    *with repeated end samples*, the boundary rule of every filter in the
    transform, for any extension width (also wider than the signal).  Works
    on numpy arrays, which is how the filters' index maps are built, and on
    tensors, which stay on their device (the samplers' coordinates).
    """
    if isinstance(x, torch.Tensor):
        xp, cast = torch, lambda a: a.to(x.dtype)
    else:
        x = np.asarray(x)
        xp, cast = np, lambda a: a.astype(x.dtype)
    rng = maxx - minx
    rng2 = 2.0 * rng
    mod = xp.fmod(x - minx, rng2)
    mod = xp.where(mod < 0, mod + rng2, mod)
    return cast(xp.where(mod >= rng, rng2 - mod, mod) + minx)


def compute_view(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 is a storage type: the arithmetic runs in float32, as the
    kernels accumulate in float32.  Identity for every other dtype."""
    return x.float() if x.dtype == torch.bfloat16 else x


def _tensor(x, device=None) -> torch.Tensor:
    """*x* as a tensor: a tensor as it is (moved to *device* where given),
    anything else through numpy, whose dtype rules it keeps (a Python
    float is float64)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x if device is None else x.to(device)


def asfarray(X) -> torch.Tensor:
    """*X* as a floating (or complex) tensor: an inexact dtype is kept,
    integers and bools become float64."""
    X = _tensor(X)
    if X.is_floating_point() or X.is_complex():
        return X
    return X.to(torch.float64)


def appropriate_complex_type_for(X) -> torch.dtype:
    """The complex dtype matching the precision of *X*: complex stays,
    float32 and the half types become complex64, the rest complex128.
    bfloat16 is a storage type computed in float32, hence complex64."""
    dt = _tensor(X).dtype
    if dt.is_complex:
        return dt
    if dt in (torch.float32, torch.float16, torch.bfloat16):
        return torch.complex64
    return torch.complex128


def as_column_vector(v) -> torch.Tensor:
    """*v* as an ``(N, 1)`` column: a row (or a 1-D or 0-D input) is
    transposed, anything else returned as at least 2-D."""
    v = torch.atleast_2d(_tensor(v))
    return v.permute(*reversed(range(v.ndim))) if v.shape[0] == 1 else v


def drawedge(theta, r, w, N, device="cuda") -> torch.Tensor:
    """An N x N float64 image of a soft step edge at *theta* degrees through
    image coordinate *r*, its raised-cosine profile *w* pixels wide."""
    thetar = float(theta) * np.pi / 180.0
    centre = (np.array([N, N], dtype=np.float64) - 1.0) / 2.0 + 1.0
    rr = -np.array([np.cos(thetar), np.sin(thetar)]) * (
        np.asarray(r, np.float64) - centre)
    w = max(1.0, float(w))
    ramp = torch.arange(N, dtype=torch.float64, device=device) - (N + 1) / 2.0
    # plane[i, j] = -sin(theta)*ramp[j] - r0  +  -cos(theta)*ramp[i] - r1
    plane = (-np.sin(thetar) * ramp[None, :] - float(rr[0])) \
        + (-np.cos(thetar) * ramp[:, None] - float(rr[1]))
    return 0.5 + 0.5 * torch.sin(torch.clamp(plane * (np.pi / w), -np.pi / 2,
                                             np.pi / 2))


def drawcirc(r, w, du, dv, N, device="cuda") -> torch.Tensor:
    """An N x N float64 image of a soft-edged circle of radius *r* offset
    (*du*, *dv*) from the centre, its cosine edge *w* pixels wide."""
    w = max(float(w), 1.0)
    r = float(r)
    ramp = torch.arange(N, dtype=torch.float64, device=device) - (N + 1) / 2.0
    ones = torch.ones((N, 1), dtype=torch.float64, device=device)
    x = ones * ((ramp - dv) / r)
    y = (((ramp - du) / r)[None, :] * ones.T).T
    arg = (torch.exp(-0.5 * (x ** 2 + y ** 2)).T - np.exp(-0.5)) * (
        r * 3.0 / w)
    return 0.5 + 0.5 * torch.sin(torch.clamp(arg, -np.pi / 2, np.pi / 2))


def unpack(pyramid, backend="numpy"):
    """Yield a pyramid's lowpass, its highpasses and, where it has them, its
    scales.  *backend* is accepted for the reference's signature; the
    leaves are what the pyramid holds.  A :class:`PlanePyramid` unpacks
    through its interleaved view."""
    if hasattr(pyramid, "highpasses_re"):
        pyramid = pyramid.interleaved()
    yield pyramid.lowpass
    yield pyramid.highpasses
    if pyramid.scales is not None:
        yield pyramid.scales


def _tensors(*xs):
    """*xs* as tensors on the device of the first tensor among them."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return [_tensor(x, dev) for x in xs]


def stacked_2d_matrix_vector_prod(mats, vecs) -> torch.Tensor:
    """``mats[..., :, :] @ vecs[..., :]`` over the leading axes."""
    return torch.einsum("...ij,...j->...i", *_tensors(mats, vecs))


def stacked_2d_vector_matrix_prod(vecs, mats) -> torch.Tensor:
    """``mats[..., :, :].T @ vecs[..., :]`` over the leading axes."""
    mats, vecs = _tensors(mats, vecs)
    return torch.einsum("...ij,...i->...j", mats, vecs)


def stacked_2d_matrix_matrix_prod(mats1, mats2) -> torch.Tensor:
    """``mats1[..., :, :] @ mats2[..., :, :]`` over the leading axes."""
    return torch.einsum("...ij,...jk->...ik", *_tensors(mats1, mats2))
