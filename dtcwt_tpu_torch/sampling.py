"""Rescaling and resampling of low- and highpass subbands, including the
phase-unwrapping forms for complex highpass coefficients
(``dtcwt_tpu.sampling``).

Conventions, as in the JAX package: integer coordinate (x, y) is the
*centre* of pixel ``im[y, x]``; out-of-range samples reflect symmetrically
with repeated end samples.  The samplers gather and accumulate on real or
complex images with any trailing channel axes.

Device rule: a tensor stays on its device, and the other inputs (numpy
arrays, lists, coordinates) join it there; where no input is a tensor they
go to *device*, the card by default, which raises where there is none.
Nothing moves to the host.  Constants that come from the host (the rescale
operators, the phase tables, index maps) are copied to a device once and
kept: a copy from the host waits for the device's queue.

The phase ramps of the ``*_highpass`` forms are computed in float64 from
the coordinates and cast to the subbands' complex dtype.  At float64 every
function equals the JAX package's (with x64); at float32 a ramp has the
float64 phase rounded once, where a float32 phase would be a thousandth of
a radian off at a few thousand pixels.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from dtcwt_tpu_torch.utils import reflect

__all__ = (
    "sample", "sample_highpass",
    "rescale", "rescale_highpass",
    "upsample", "upsample_highpass",
    "DTHETA_DX_2D", "DTHETA_DY_2D",
)

_W0 = -3 * np.pi / 2.15
_W1 = -np.pi / 2.15

#: Expected per-pixel phase advance of each 2-D subband in x
DTHETA_DX_2D = np.array((_W1, _W0, _W0, _W0, _W0, _W1))
#: Expected per-pixel phase advance of each 2-D subband in y
DTHETA_DY_2D = np.array((_W0, _W0, _W1, -_W1, -_W0, -_W0))


# --- devices and host constants ---------------------------------------------

def _device(device, *xs) -> torch.device:
    """Where an algorithm runs: *device* where given, else the first tensor's
    device among *xs*, else the card (which raises where there is none)."""
    if device is None:
        dev = next((x.device for x in xs if isinstance(x, torch.Tensor)),
                   torch.device("cuda"))
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        kind = next((type(x).__name__ for x in xs
                     if not isinstance(x, torch.Tensor)), "numpy")
        raise RuntimeError("no CUDA device for a %s input: pass device='cpu' "
                           "for the plain version" % kind)
    return dev


def _tensor(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if x.device == dev else x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def _coords(x, dev: torch.device) -> torch.Tensor:
    """Coordinates as a floating tensor of their own dtype; integers become
    float64, as the JAX package's weights of integer coordinates are."""
    x = _tensor(x, dev)
    return x if x.is_floating_point() else x.to(torch.float64)


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype: torch.dtype, device: torch.device
           ) -> torch.Tensor:
    """A small constant tensor, copied to *device* once."""
    return torch.tensor(values, dtype=dtype).to(device)


def _complex_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.complex64)


# --- the gather samplers ----------------------------------------------------

def _fold(c: torch.Tensor, n: int) -> torch.Tensor:
    """Integer sample index of coordinates *c* on an axis of *n* samples:
    symmetric reflection, then truncation toward zero (``astype(int32)``)."""
    return reflect(c, -0.5, n - 0.5).long()


def _gather(im: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor, nb: int
            ) -> torch.Tensor:
    """``im[..., yi, xi, ...]``: *im* is ``[*B, H, W, *C]`` with *nb* batch
    axes, the indices ``[*B, *Q]``; the result is ``[*B, *Q, *C]``."""
    if nb == 0:
        return im[yi, xi]
    lead = im.shape[:nb]
    n = math.prod(lead)
    flat = im.reshape((n,) + im.shape[nb:])
    q = yi.shape[nb:]
    b = torch.arange(n, device=im.device).view((n,) + (1,) * len(q))
    out = flat[b, yi.reshape((n,) + q), xi.reshape((n,) + q)]
    return out.reshape(lead + out.shape[1:])


def _lanczos(x, a=3.0):
    return torch.sinc(x) * torch.sinc(x / a)


def _hat(x):
    return torch.clamp_min(1.0 - torch.abs(x), 0.0)


#: method -> (1-D tap offsets relative to floor(coord), tap weight function
#: of the signed distance): every interpolator is the same separable
#: gather-accumulate loop over this stencil (``dtcwt_tpu/sampling.py:62-68``)
_STENCILS = {
    "bilinear": (range(0, 2), _hat),
    "lanczos": (range(-2, 4), _lanczos),
}


def _sample(im, xs, ys, method, nb: int = 0):
    """:func:`sample` on ``[*B, H, W, *C]`` images with *nb* batch axes and
    ``[*B, *Q]`` coordinates (``dtcwt_tpu/sampling.py:71-94``)."""
    h, w = im.shape[nb], im.shape[nb + 1]
    method = method or "lanczos"
    if method == "nearest":
        return _gather(im, _fold(torch.round(ys), h),
                       _fold(torch.round(xs), w), nb)
    if method not in _STENCILS:
        raise NotImplementedError(
            'Sampling method "{0}" is not implemented.'.format(method))
    offsets, weight = _STENCILS[method]
    fx, fy = torch.floor(xs), torch.floor(ys)
    extra = (1,) * (im.ndim - nb - 2)
    # each offset's index map and weight once (the same values as the JAX
    # loop, which recomputes them for every tap)
    xi = [_fold(fx + d, w) for d in offsets]
    yi = [_fold(fy + d, h) for d in offsets]
    wx = [weight((xs - fx) - d) for d in offsets]
    wy = [weight((ys - fy) - d) for d in offsets]
    acc = None
    for i in range(len(offsets)):
        for j in range(len(offsets)):
            wt = wx[i] * wy[j]
            term = wt.reshape(wt.shape + extra) * _gather(im, yi[j], xi[i], nb)
            acc = term if acc is None else acc + term
    return acc.to(im.dtype) if method == "bilinear" else acc


def sample(im, xs, ys, method=None, device=None):
    """Sample *im* at fractional centre-of-pixel coordinates (xs, ys) using
    ``'lanczos'`` (default), ``'bilinear'`` or ``'nearest'`` interpolation
    (``dtcwt_tpu/sampling.py:71-94``).  Out-of-range coordinates reflect
    symmetrically (repeated end samples).  The coordinates keep their own
    dtype, so float64 coordinates promote a float32 image's ``lanczos``
    result to float64; ``bilinear`` and ``nearest`` return *im*'s dtype."""
    dev = _device(device, im, xs, ys)
    im = torch.atleast_2d(_tensor(im, dev))
    xs, ys = _coords(xs, dev), _coords(ys, dev)
    if xs.shape != ys.shape:
        raise ValueError("Shape of xs and ys must match")
    return _sample(im, xs, ys, method)


# --- the separable rescale --------------------------------------------------

def _rescale_grid(src_shape, dst_shape, dev):
    """Source coordinates ``(sxs [dw], sys [dh, 1])`` of the rescale grid,
    in float64 (``dtcwt_tpu/sampling.py:97-103``)."""
    sh, sw = src_shape[:2]
    dh, dw = dst_shape[:2]
    f64 = torch.float64
    sxs = (float(sw) / float(dw)) * (torch.arange(dw, dtype=f64, device=dev)
                                     + 0.5) - 0.5
    sys = (float(sh) / float(dh)) * (torch.arange(dh, dtype=f64, device=dev)
                                     + 0.5) - 0.5
    return sxs, sys[:, None]


def _interp_matrix(src: int, dst: int, method: str) -> np.ndarray:
    """(dst, src) separable interpolation operator for the regular rescale
    grid, with the samplers' symmetric-reflect index folding baked in
    (``dtcwt_tpu/sampling.py:106-133``): the same weights and taps as the
    gather samplers, as two matrix products."""
    cs = (float(src) / float(dst)) * (np.arange(dst) + 0.5) - 0.5
    A = np.zeros((dst, src))
    rows = np.arange(dst)

    def fold(idx):
        return reflect(idx, -0.5, src - 0.5).astype(np.int64)

    if method == "nearest":
        A[rows, fold(np.round(cs))] = 1.0
    elif method == "bilinear":
        fl = np.floor(cs)
        fr = cs - fl
        np.add.at(A, (rows, fold(fl)), 1.0 - fr)
        np.add.at(A, (rows, fold(fl + 1)), fr)
    else:  # lanczos
        a = 3
        fl = np.floor(cs)
        fr = cs - fl
        for dx in range(-a + 1, a + 1):
            w = np.sinc(fr - dx) * np.sinc((fr - dx) / a)
            np.add.at(A, (rows, fold(fl + dx)), w)
    return A


@functools.lru_cache(maxsize=32)
def _interp_tensor(src: int, dst: int, method: str, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """:func:`_interp_matrix` in *dtype* on *device*, copied there once."""
    return torch.from_numpy(_interp_matrix(src, dst, method)).to(dtype).to(
        device)


def _rescale_real(im, ay, ax, nb: int):
    tmp = torch.tensordot(ay, im, dims=([1], [nb]))        # [dh, *B, sw, *C]
    out = torch.tensordot(ax, tmp, dims=([1], [nb + 1]))   # [dw, dh, *B, *C]
    return out.permute(tuple(range(2, 2 + nb)) + (1, 0)
                       + tuple(range(2 + nb, out.ndim)))


def _rescale(im, shape, method, nb: int = 0):
    """:func:`rescale` on ``[*B, H, W, *C]`` with *nb* batch axes
    (``dtcwt_tpu/sampling.py:136-155``).  An integer image is rescaled in
    float64."""
    method = method or "lanczos"
    if method not in ("nearest", "bilinear", "lanczos"):
        raise NotImplementedError(
            'Sampling method "{0}" is not implemented.'.format(method))
    if not (im.is_floating_point() or im.is_complex()):
        im = im.to(torch.float64)
    rdt = im.dtype.to_real()
    ay = _interp_tensor(im.shape[nb], shape[0], method, rdt, im.device)
    ax = _interp_tensor(im.shape[nb + 1], shape[1], method, rdt, im.device)
    if im.is_complex():
        return torch.complex(_rescale_real(im.real, ay, ax, nb),
                             _rescale_real(im.imag, ay, ax, nb))
    return _rescale_real(im, ay, ax, nb)


def rescale(im, shape, method=None, device=None):
    """Resample *im* so that its (half-pixel-inclusive) extent maps onto an
    array of size *shape* (``dtcwt_tpu/sampling.py:158-162``): two matrix
    products with the cached operators of :func:`_interp_matrix`."""
    im = torch.atleast_2d(_tensor(im, _device(device, im)))
    return _rescale(im, shape, method)


# --- the highpass forms -----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dtheta(sbs: tuple, device: torch.device):
    return (_const(tuple(DTHETA_DX_2D[list(sbs)]), torch.float64, device),
            _const(tuple(DTHETA_DY_2D[list(sbs)]), torch.float64, device))


def _phase_image(xs, ys, unwrap, sbs, dtype):
    """``exp(-+j(w_x x + w_y y))`` phase ramps of subbands *sbs*, stacked on
    a trailing axis, in complex *dtype* (``dtcwt_tpu/sampling.py:165-178``;
    the phase in float64)."""
    dx, dy = _dtheta(tuple(int(s) for s in sbs), xs.device)
    ph = dx * xs.to(torch.float64)[..., None] + \
        dy * ys.to(torch.float64)[..., None]
    sign = -1.0 if unwrap else 1.0
    return torch.complex(torch.cos(ph), sign * torch.sin(ph)).to(dtype)


def _subbands(im, sbs):
    """``im[..., sbs]`` (the identity for all six in order)."""
    if len(sbs) == im.shape[-1] and list(sbs) == list(range(len(sbs))):
        return im
    return im.index_select(-1, _const(tuple(int(s) for s in sbs), torch.long,
                                      im.device))


def _pixel_grid(h: int, w: int, dev):
    """The integer pixel centres ``(X [w], Y [h, 1])`` in float64."""
    f64 = torch.float64
    return (torch.arange(w, dtype=f64, device=dev),
            torch.arange(h, dtype=f64, device=dev)[:, None])


def _unwrap(im, sbs, nb: int):
    X, Y = _pixel_grid(im.shape[nb], im.shape[nb + 1], im.device)
    sel = _subbands(im, sbs)
    return sel * _phase_image(X, Y, True, sbs, _complex_dtype(sel.dtype))


def _sample_highpass(im, xs, ys, method, sbs, nb: int = 0):
    """:func:`sample_highpass` on ``[*B, H, W, 6]`` stacks with *nb* batch
    axes (``dtcwt_tpu/sampling.py:181-189``)."""
    sampled = _sample(_unwrap(im, sbs, nb), xs, ys, method, nb)
    return _phase_image(xs, ys, False, sbs, sampled.dtype) * sampled


def _sbs(sbs):
    return np.arange(6) if sbs is None else np.asarray(sbs)


def sample_highpass(im, xs, ys, method=None, sbs=None, device=None):
    """As :func:`sample` for complex highpass subband stacks ``[H, W, 6]``:
    unwrap each subband's expected phase ramp to about DC, sample, re-wrap
    (``dtcwt_tpu/sampling.py:181-189``).  *sbs* selects or reorders
    subbands."""
    dev = _device(device, im, xs, ys)
    im = _tensor(im, dev)
    xs, ys = _coords(xs, dev), _coords(ys, dev)
    if xs.shape != ys.shape:
        raise ValueError("Shape of xs and ys must match")
    return _sample_highpass(im, xs, ys, method, _sbs(sbs))


def rescale_highpass(im, shape, method=None, sbs=None, device=None):
    """As :func:`rescale` with the highpass phase unwrap and re-wrap
    (``dtcwt_tpu/sampling.py:192-201``)."""
    im = _tensor(im, _device(device, im))
    sbs = _sbs(sbs)
    sxs, sys = _rescale_grid(im.shape, shape, im.device)
    sampled = _rescale(_unwrap(im, sbs, 0), shape, method)
    return sampled * _phase_image(sxs, sys, False, sbs, sampled.dtype)


# --- the factor-two upsamplers ----------------------------------------------

def _upsample_taps(method):
    """(offsets, weights of the sample at x - 0.25, at x + 0.25)."""
    if method == "lanczos":
        a = 3.0
        offsets = np.arange(-a, a + 1)
        l_as = np.sinc(-0.25 - offsets) * np.sinc((-0.25 - offsets) / a)
        l_bs = np.sinc(0.25 - offsets) * np.sinc((0.25 - offsets) / a)
        return [int(o) for o in offsets], l_as, l_bs
    if method == "nearest":
        return [0], [1.0], [1.0]
    if method == "bilinear":
        return [-1, 0, 1], [0.25, 0.75, 0.0], [0.0, 0.75, 0.25]
    raise ValueError("Unknown interpolation mode: {0}".format(method))


@functools.lru_cache(maxsize=256)
def _column_fold(m: int, di: int, device: torch.device) -> torch.Tensor:
    cols = reflect(np.arange(m, dtype=np.float64) + di, -0.5, m - 0.5)
    return torch.from_numpy(cols.astype(np.int64)).to(device)


def _upsample_columns(X, method=None):
    """Double the column count by interleaving two shifted interpolation
    convolutions, A at x - 0.25 and B at x + 0.25
    (``dtcwt_tpu/sampling.py:204-236``)."""
    method = method or "lanczos"
    X = torch.atleast_2d(X)
    M = X.shape[1]
    offsets, l_as, l_bs = _upsample_taps(method)
    A = B = None
    for di, l_a, l_b in zip(offsets, l_as, l_bs):
        gathered = X.index_select(1, _column_fold(M, di, X.device))
        ta = gathered * float(l_a)
        tb = gathered * float(l_b)
        A = ta if A is None else A + ta
        B = tb if B is None else B + tb
    stacked = torch.stack([A, B], dim=2)
    return stacked.reshape(X.shape[:1] + (2 * M,) + X.shape[2:])


def _upsample(image, method):
    swap = lambda X: X.transpose(0, 1)
    return _upsample_columns(swap(_upsample_columns(swap(image), method)),
                             method)


def upsample(image, method=None, device=None):
    """Upsample rows and columns by a factor of two, trailing axes kept
    (``dtcwt_tpu/sampling.py:239-248``)."""
    image = torch.atleast_2d(_tensor(image, _device(device, image)))
    return _upsample(image, method)


def upsample_highpass(im, method=None, device=None):
    """As :func:`upsample` for complex subband stacks ``[H, W, 6]``, with the
    phase unwrap and re-wrap around the interpolation
    (``dtcwt_tpu/sampling.py:251-261``)."""
    im = torch.atleast_2d(_tensor(im, _device(device, im)))
    h, w = im.shape[0], im.shape[1]
    f64 = torch.float64
    sxs = 0.5 * (torch.arange(2 * w, dtype=f64, device=im.device) + 0.5) - 0.5
    sys = 0.5 * (torch.arange(2 * h, dtype=f64, device=im.device)[:, None]
                 + 0.5) - 0.5
    sampled = _upsample(_unwrap(im, np.arange(6), 0), method)
    return sampled * _phase_image(sxs, sys, False, np.arange(6),
                                  sampled.dtype)
