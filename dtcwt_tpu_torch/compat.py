"""MATLAB-toolbox-style functional API (``dtcwt_tpu.compat``).

``dtwavexfm`` / ``dtwaveifm`` (1-D), ``dtwavexfm2`` / ``dtwaveifm2`` (and
the ``...2b`` aliases, 2-D) and ``dtwavexfm3`` / ``dtwaveifm3`` (3-D) unpack
the :class:`Pyramid` into ``(Yl, Yh[, Yscale])`` tuples for script-style
use.  Each call builds its Transform on *device*: the card by default, the
plain PyTorch path with ``device="cpu"``.  Prefer the Transform classes in
new code.
"""

from __future__ import annotations

from dtcwt_tpu_torch.defaults import DEFAULT_BIORT, DEFAULT_QSHIFT
from dtcwt_tpu_torch.transforms.pyramid import Pyramid
from dtcwt_tpu_torch.transforms.transform1d import Transform1d
from dtcwt_tpu_torch.transforms.transform2d import Transform2d
from dtcwt_tpu_torch.transforms.transform3d import Transform3d

__all__ = [
    "dtwavexfm", "dtwaveifm",
    "dtwavexfm2", "dtwaveifm2", "dtwavexfm2b", "dtwaveifm2b",
    "dtwavexfm3", "dtwaveifm3",
]


def _unpack(res, include_scale):
    if include_scale:
        return res.lowpass, res.highpasses, res.scales
    return res.lowpass, res.highpasses


def dtwavexfm(X, nlevels=3, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
              include_scale=False, device="cuda"):
    """n-level 1-D DTCWT of a vector (or the columns of a matrix).
    Returns ``(Yl, Yh)`` or ``(Yl, Yh, Yscale)``."""
    res = Transform1d(biort, qshift, device=device).forward(
        X, nlevels, include_scale)
    return _unpack(res, include_scale)


def dtwaveifm(Yl, Yh, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
              gain_mask=None, device="cuda"):
    """Inverse of :func:`dtwavexfm`."""
    return Transform1d(biort, qshift, device=device).inverse(
        Pyramid(Yl, Yh), gain_mask=gain_mask)


def dtwavexfm2(X, nlevels=3, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
               include_scale=False, device="cuda"):
    """n-level 2-D DTCWT.  Returns ``(Yl, Yh)`` or ``(Yl, Yh, Yscale)``."""
    res = Transform2d(biort, qshift, device=device).forward(
        X, nlevels, include_scale)
    return _unpack(res, include_scale)


def dtwaveifm2(Yl, Yh, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
               gain_mask=None, device="cuda"):
    """Inverse of :func:`dtwavexfm2`."""
    return Transform2d(biort, qshift, device=device).inverse(
        Pyramid(Yl, Yh), gain_mask=gain_mask)


# The MATLAB toolbox's bandpass ('b') variants are the main functions with
# the bandpass wavelet names; the aliases keep scripts working.
dtwavexfm2b = dtwavexfm2
dtwaveifm2b = dtwaveifm2


def dtwavexfm3(X, nlevels=3, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
               include_scale=False, ext_mode=4, discard_level_1=False,
               device="cuda"):
    """n-level 3-D DTCWT with 28 directional subbands per level."""
    res = Transform3d(biort, qshift, ext_mode, device=device).forward(
        X, nlevels, include_scale, discard_level_1)
    return _unpack(res, include_scale)


def dtwaveifm3(Yl, Yh, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
               ext_mode=4, device="cuda"):
    """Inverse of :func:`dtwavexfm3`."""
    return Transform3d(biort, qshift, ext_mode, device=device).inverse(
        Pyramid(Yl, Yh))
