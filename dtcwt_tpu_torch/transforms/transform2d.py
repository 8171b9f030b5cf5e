"""2-D dual-tree complex wavelet transform, forward and inverse
(``dtcwt_tpu.transforms.transform2d``).

Each level is one call of a level module (``ops/level1``, ``ops/level2``,
``ops/ilevel2``, ``ops/ilevel1``), which runs its CUDA kernel on a CUDA
tensor and its plain PyTorch version on a CPU tensor.  What stays here is
glue in PyTorch: odd-size edge duplication, the per-level multiple-of-4
padding, the inverse's crop, the gain-mask pre-scaling and the bfloat16
rules.  Levels hand each other plain lowpass images.  The transform runs on its
``device`` ("cuda" unless the caller asks for "cpu") and moves its inputs
there.

On the card, where grad mode is on and an input requires grad, the level
chain runs as one ``linearize.linear_vjp`` Function: its backward is the
explicit adjoint (``_fwd_adjoint_fn``, ``_inv_adjoint_fn``: the opposite
qshift level kernels and ``ops/adjoint``'s level-1 adjoints on the dual
kernels) where the filters, dtype and shapes allow, and the plain chain's
``torch.func.vjp`` elsewhere.  The glue stays outside the Function, and
autograd differentiates it.
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch
from torch import nn

from dtcwt_tpu_torch.coeffs import biort as _biort, qshift as _qshift
from dtcwt_tpu_torch.defaults import DEFAULT_BIORT, DEFAULT_QSHIFT
from dtcwt_tpu_torch.ops import (
    adjoint, ilevel1, ilevel2, level1, level2, linearize)
from dtcwt_tpu_torch.transforms.pyramid import (
    PLANE_BAND_ORDER, PlanePyramid, Pyramid)

__all__ = ["Transform2d", "normalize_biort", "normalize_qshift"]

_log = logging.getLogger(__name__)


def _flat(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float64).reshape(-1)


def normalize_biort(biort) -> Tuple[np.ndarray, ...]:
    """Accept a named family or an explicit (h0o, g0o, h1o, g1o[, h2o, g2o])
    tuple of arrays; return flat float64 numpy vectors."""
    if isinstance(biort, str):
        biort = _biort(biort)
    biort = tuple(_flat(v) for v in biort)
    if len(biort) not in (4, 6):
        raise ValueError("Biort wavelet must have 6 or 4 components.")
    return biort


def normalize_qshift(qshift) -> Tuple[np.ndarray, ...]:
    """Accept a named family or an explicit 8/12-tuple of qshift filters;
    return flat float64 numpy vectors."""
    if isinstance(qshift, str):
        qshift = _qshift(qshift)
    qshift = tuple(_flat(v) for v in qshift)
    if len(qshift) not in (8, 12):
        raise ValueError("Qshift wavelet must have 12 or 8 components.")
    return qshift


def _dup_edge(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Duplicate the trailing sample along *dim* (odd-size fixup)."""
    return torch.cat([x, x.narrow(dim, x.shape[dim] - 1, 1)], dim=dim)


def _pad_multiple4(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Replicate the first and last samples along *dim* (pre-level pad)."""
    return torch.cat([x.narrow(dim, 0, 1), x,
                      x.narrow(dim, x.shape[dim] - 1, 1)], dim=dim)


def _crop_to(Z: torch.Tensor, next_hw) -> torch.Tensor:
    """Crop rows/cols that exist only because the forward pass padded this
    level to a multiple of 4.  *next_hw* is the next-finer level's subband
    (h, w)."""
    want = tuple(2 * s for s in next_hw)
    if Z.shape[-2] != want[0]:
        Z = Z[..., 1:-1, :]
    if Z.shape[-1] != want[1]:
        Z = Z[..., :, 1:-1]
    if tuple(Z.shape[-2:]) != want:
        raise ValueError("Sizes of highpasses are not valid for the"
                         " inverse transform")
    return Z.contiguous()


def _level_bands(pyramid):
    """Each level's subbands as the level entries take them: ``{"yh":
    complex}`` or ``{"bands": (re, im)}``."""
    if isinstance(pyramid, PlanePyramid):
        return [{"bands": (r, i)} for r, i in zip(pyramid.highpasses_re,
                                                  pyramid.highpasses_im)]
    return [{"yh": h} for h in pyramid.highpasses]


def _band_hw(pyramid):
    """Each level's subband (h, w)."""
    if isinstance(pyramid, PlanePyramid):
        return [tuple(r.shape[-2:]) for r in pyramid.highpasses_re]
    return [tuple(h.shape[-3:-1]) for h in pyramid.highpasses]


class Transform2d(nn.Module):
    """An n-level 2-D DTCWT parameterised by *biort* (level-1) and *qshift*
    (level>=2) wavelets: named families or explicit coefficient tuples of
    numpy arrays.  The transform has no learned weights; the filters are
    host-side float64 taps.

    *device* is where the transform runs: every input (numpy array, list or
    tensor on another device) and every pyramid leaf is moved there.  The
    default, ``"cuda"``, runs the CUDA kernels (and raises where there is no
    card); ``device="cpu"`` runs the plain PyTorch versions."""

    def __init__(self, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
                 device="cuda"):
        super().__init__()
        self.biort = normalize_biort(biort)
        self.qshift = normalize_qshift(qshift)
        self.device = torch.device(device)

    def forward(self, X, nlevels: int = 3, include_scale: bool = False,
                layout: str = "interleaved"):
        """Forward transform of a ``[..., H, W]`` real tensor into a
        :class:`Pyramid` (complex ``[..., h, w, 6]`` subbands) or, with
        ``layout='planes'``, a :class:`PlanePyramid`.  Odd sizes have their
        last row/column duplicated first.  bfloat16 input is stored as
        bfloat16 only in the plane layout (and computed at float32).  On
        the card an input that requires grad gets its gradient through
        :mod:`ops.linearize`."""
        X = torch.as_tensor(X, device=self.device)
        if X.ndim < 2:
            raise ValueError("Transform2d.forward needs at least a 2-D input")
        if layout not in ("interleaved", "planes"):
            raise ValueError("layout must be 'interleaved' or 'planes'")
        planes = layout == "planes"

        if not X.is_floating_point():
            X = X.to(torch.get_default_dtype())
        if X.dtype == torch.bfloat16 and not planes:
            # there is no bfloat16 complex dtype for the interleaved layout
            X = X.float()
        if X.shape[-2] % 2 or X.shape[-1] % 2:
            _log.warning(
                "The image entered is now a %dx%d NOT a %dx%d; odd "
                "dimensions have their last row/column duplicated prior "
                "to decomposition.", X.shape[-2] + X.shape[-2] % 2,
                X.shape[-1] + X.shape[-1] % 2, X.shape[-2], X.shape[-1])
            if X.shape[-2] % 2:
                X = _dup_edge(X, -2)
            if X.shape[-1] % 2:
                X = _dup_edge(X, -1)
        X = X.contiguous()

        if nlevels == 0:
            scales = [] if include_scale else None
            if planes:
                return PlanePyramid(X, (), (), scales)
            return Pyramid(X, (), scales)

        return linearize.dispatch(
            lambda x, plain: self._forward_levels(x, nlevels, include_scale,
                                                  planes, plain), X,
            lambda: self._fwd_adjoint_fn(X.shape, X.dtype, nlevels,
                                         include_scale, planes))

    def _forward_levels(self, X, nlevels: int, include_scale: bool,
                        planes: bool, plain: bool = False):
        """The level chain of the forward on the prepared image *X*: the
        level entries, or with *plain* their plain versions."""
        b, q = self.biort, self.qshift
        h0o, h1o = b[0], b[2]
        h2o = b[4] if len(b) == 6 else None
        h0a, h0b, h1a, h1b = q[0], q[1], q[4], q[5]
        h2a, h2b = (q[8], q[9]) if len(q) == 12 else (None, None)
        fwd1 = linearize.entry(level1, "fwd_level1", plain)
        fwd2 = linearize.entry(level2, "fwd_level2", plain)

        scales = [] if include_scale else None
        lolo, yh = fwd1(X, h0o, h1o, planes=planes, h2o=h2o)
        Yh = [yh]
        if include_scale:
            scales.append(lolo)
        for _ in range(1, nlevels):
            if lolo.shape[-2] % 4:
                lolo = _pad_multiple4(lolo, -2)
            if lolo.shape[-1] % 4:
                lolo = _pad_multiple4(lolo, -1)
            lolo, yh = fwd2(lolo, h0a, h0b, h1a, h1b, planes=planes,
                            h2a=h2a, h2b=h2b)
            Yh.append(yh)
            if include_scale:
                scales.append(lolo)
        if planes:
            return PlanePyramid(lolo, tuple(r for r, _ in Yh),
                                tuple(i for _, i in Yh), scales)
        return Pyramid(lolo, tuple(Yh), scales)

    # ------------------------------------------------------------------
    # explicit adjoints (ops/adjoint.py): a qshift level's adjoint is the
    # opposite level kernel, level 1's a zero-extension correlation on the
    # dual kernels plus a border fold.  None outside their envelope: the
    # backward then differentiates the plain chain.
    # ------------------------------------------------------------------
    def _fwd_adjoint_fn(self, shape, dtype, nlevels: int, include_scale: bool,
                        planes: bool):
        """The forward's adjoint (result gradient -> image gradient), or
        None where the filters, dtype, scales or shapes (a pad in the chain,
        a level-1 side shorter than the fold) leave its envelope."""
        if include_scale or not adjoint.explicit_route(self.biort,
                                                       self.qshift, dtype):
            return None
        H, W = shape[-2:]
        h0o, h1o = self.biort[0], self.biort[2]
        if (H % 2 ** nlevels or W % 2 ** nlevels
                or min(H, W) < max(h0o.size, h1o.size) // 2):
            return None
        q = self.qshift
        g0a, g0b, g1a, g1b = q[2], q[3], q[6], q[7]

        def adj(cot):
            bands = _level_bands(cot)
            Z = cot.lowpass.contiguous()
            for lvl in range(nlevels - 1, 0, -1):
                Z = ilevel2.inv_level2(Z, g0a=g0a, g0b=g0b, g1a=g1a,
                                       g1b=g1b, **bands[lvl])
            return adjoint.level1_fwd_adj_quads(Z, *ilevel2._quads(
                **bands[0]), h0o, h1o)
        return adj

    def _inv_adjoint_fn(self, pyramid):
        """The (gain-free) inverse's adjoint (image gradient -> pyramid
        gradient) of the prepared *pyramid*, or None outside its envelope:
        a crop in the chain, subbands of another dtype than the lowpass, a
        level-1 side shorter than the fold."""
        planes = isinstance(pyramid, PlanePyramid)
        low = pyramid.lowpass
        if not adjoint.explicit_route(self.biort, self.qshift, low.dtype):
            return None
        if planes and {a.dtype for a in pyramid.highpasses_re
                       + pyramid.highpasses_im} != {low.dtype}:
            return None
        hw = _band_hw(pyramid)
        double = lambda s: tuple(2 * v for v in s)
        if (any(hw[lvl - 1] != double(hw[lvl]) for lvl in range(1, len(hw)))
                or tuple(low.shape[-2:]) != double(hw[-1])):
            return None
        g0o, g1o = self.biort[1], self.biort[3]
        if min(hw[0]) * 2 < max(g0o.size, g1o.size) // 2:
            return None
        q = self.qshift
        h0a, h0b, h1a, h1b = q[0], q[1], q[4], q[5]

        def adj(xbar):
            z, yh = adjoint.level1_inv_adj(xbar, g0o, g1o, planes)
            Yh = [yh]
            for _ in range(1, len(hw)):
                z, yh = level2.fwd_level2(z, h0a, h0b, h1a, h1b,
                                          planes=planes)
                Yh.append(yh)
            if planes:
                return PlanePyramid(z, tuple(r for r, _ in Yh),
                                    tuple(i for _, i in Yh))
            return Pyramid(z, tuple(Yh))
        return adj

    # ------------------------------------------------------------------
    # channel/batch layout adapters
    # ------------------------------------------------------------------
    _FORMATS_3D = ("nhw", "chw", "hwn", "hwc")
    _FORMATS_4D = ("nchw", "nhwc")

    @classmethod
    def _check_format(cls, data_format: str, ndim: int) -> str:
        fmt = data_format.lower()
        formats = cls._FORMATS_3D + cls._FORMATS_4D
        if fmt not in formats:
            raise ValueError("The data format must be one of: %s" % (formats,))
        want = 3 if fmt in cls._FORMATS_3D else 4
        if ndim != want:
            raise ValueError("%r data format expects a %d-D input, got %d-D"
                             % (fmt, want, ndim))
        return fmt

    def forward_channels(self, X, data_format, nlevels: int = 3,
                         include_scale: bool = False) -> Pyramid:
        """Forward transform of a batch of multi-channel images, each channel
        transformed on its own.

        *data_format* is one of ``nhw``/``chw``/``hwn``/``hwc`` (3-D inputs)
        or ``nchw``/``nhwc`` (4-D); the outputs keep the batch/channel axes
        where the input has them.  The transform is batched over any leading
        axes, so this only moves axes, and the outputs are views of the
        pyramid's leaves (a channel-last input is made contiguous once, by
        :meth:`forward`, as the kernels read it)."""
        X = torch.as_tensor(X, device=self.device)
        fmt = self._check_format(data_format, X.ndim)
        if fmt in ("hwn", "hwc"):
            X = X.movedim(-1, 0)
        elif fmt == "nhwc":
            X = X.movedim(-1, 1)
        p = self.forward(X, nlevels, include_scale)
        if fmt in ("nhw", "chw", "nchw"):
            return p
        src = 0 if fmt in ("hwn", "hwc") else 1
        img = lambda a: a.movedim(src, -1)
        hp = lambda a: a.movedim(src, -2)
        return Pyramid(img(p.lowpass), tuple(hp(h) for h in p.highpasses),
                       None if p.scales is None
                       else tuple(img(s) for s in p.scales))

    def inverse_channels(self, pyramid: Pyramid, data_format,
                         gain_mask=None) -> torch.Tensor:
        """Inverse of :meth:`forward_channels`; *data_format* must be the
        one the forward call used."""
        on = lambda a: torch.as_tensor(a, device=self.device)
        low = on(pyramid.lowpass)
        fmt = self._check_format(data_format, low.ndim)
        if fmt in ("nhw", "chw", "nchw"):
            p = pyramid
        else:
            # channel axis: -1 in images, -2 in [..., H, W, 6] highpasses
            ch_dst = 0 if fmt in ("hwn", "hwc") else 1
            p = Pyramid(low.movedim(-1, ch_dst),
                        tuple(on(h).movedim(-2, ch_dst)
                              for h in pyramid.highpasses))
        Z = self.inverse(p, gain_mask)
        if fmt in ("hwn", "hwc"):
            return Z.movedim(0, -1)
        if fmt == "nhwc":
            return Z.movedim(1, -1)
        return Z

    def inverse(self, pyramid, gain_mask=None) -> torch.Tensor:
        """Inverse transform of a :class:`Pyramid` or :class:`PlanePyramid`.
        *gain_mask* is an optional ``(6, nlevels)`` array of per-subband
        gains in degree order.  On the card a pyramid leaf that requires
        grad gets its gradient through :mod:`ops.linearize`."""
        plane_pyr = isinstance(pyramid, PlanePyramid)
        Z = torch.as_tensor(pyramid.lowpass, device=self.device)
        sdt = Z.dtype
        if plane_pyr:
            Yb = [(torch.as_tensor(r, device=self.device).contiguous(),
                   torch.as_tensor(i, device=self.device).contiguous())
                  for r, i in zip(pyramid.highpasses_re,
                                  pyramid.highpasses_im)]
        else:
            Yh = [torch.as_tensor(h, device=self.device).contiguous()
                  for h in pyramid.highpasses]
            if Yh:
                # the kernels read the lowpass at the subbands' precision
                Z = Z.to(Yh[0].real.dtype)

        if gain_mask is not None:
            # Gains scale each subband before any filtering, so applying them
            # up front is the reference semantics, and the level kernels
            # (and the backward's adjoint) run gain-free.
            gm = torch.as_tensor(gain_mask, device=Z.device)
            if plane_pyr:
                gp = gm[list(PLANE_BAND_ORDER)]
                Yb = [((r * gp[:, lvl, None, None]).to(r.dtype),
                       (i * gp[:, lvl, None, None]).to(i.dtype))
                      for lvl, (r, i) in enumerate(Yb)]
            else:
                Yh = [h * gm[:, lvl].to(h.real.dtype)
                      for lvl, h in enumerate(Yh)]

        if plane_pyr:
            pyr = PlanePyramid(Z.contiguous(), tuple(r for r, _ in Yb),
                               tuple(i for _, i in Yb))
        else:
            pyr = Pyramid(Z.contiguous(), tuple(Yh))
        if not pyr.nlevels:
            return Z.to(sdt)

        return linearize.dispatch(self._inverse_levels, pyr,
                                  lambda: self._inv_adjoint_fn(pyr)).to(sdt)

    def _inverse_levels(self, pyramid, plain: bool = False) -> torch.Tensor:
        """The level chain of the inverse on the prepared, gain-free
        *pyramid* (contiguous leaves): the level entries, or with *plain*
        their plain versions."""
        b, q = self.biort, self.qshift
        g0o, g1o = b[1], b[3]
        g2o = b[5] if len(b) == 6 else None
        g0a, g0b, g1a, g1b = q[2], q[3], q[6], q[7]
        g2a, g2b = (q[10], q[11]) if len(q) == 12 else (None, None)
        inv2 = linearize.entry(ilevel2, "inv_level2", plain)
        inv1 = linearize.entry(ilevel1, "inv_level1", plain)

        bands, hw = _level_bands(pyramid), _band_hw(pyramid)
        Z = pyramid.lowpass
        for lvl in range(len(bands) - 1, 0, -1):
            Z = inv2(Z, g0a=g0a, g0b=g0b, g1a=g1a, g1b=g1b, g2a=g2a,
                     g2b=g2b, **bands[lvl])
            Z = _crop_to(Z, hw[lvl - 1])
        return inv1(Z, g0o=g0o, g1o=g1o, g2o=g2o, **bands[0])
