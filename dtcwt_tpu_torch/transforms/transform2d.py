"""2-D dual-tree complex wavelet transform, forward and inverse
(``dtcwt_tpu.transforms.transform2d``).

Each level is one call of a level module (``ops/level1``, ``ops/level2``,
``ops/ilevel2``, ``ops/ilevel1``), which runs its CUDA kernel on a CUDA
tensor and its plain PyTorch version on a CPU tensor.  What stays here is
glue in PyTorch: odd-size edge duplication, the per-level multiple-of-4
padding, the inverse's crop, the gain-mask pre-scaling and the bfloat16
rules.  Levels hand each other plain lowpass images.
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch
from torch import nn

from dtcwt_tpu_torch.coeffs import biort as _biort, qshift as _qshift
from dtcwt_tpu_torch.defaults import DEFAULT_BIORT, DEFAULT_QSHIFT
from dtcwt_tpu_torch.ops import ilevel1, ilevel2, level1, level2
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


class Transform2d(nn.Module):
    """An n-level 2-D DTCWT parameterised by *biort* (level-1) and *qshift*
    (level>=2) wavelets: named families or explicit coefficient tuples of
    numpy arrays.  The transform has no learned weights; the filters are
    host-side float64 taps."""

    def __init__(self, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT):
        super().__init__()
        self.biort = normalize_biort(biort)
        self.qshift = normalize_qshift(qshift)

    def forward(self, X, nlevels: int = 3, include_scale: bool = False,
                layout: str = "interleaved"):
        """Forward transform of a ``[..., H, W]`` real tensor into a
        :class:`Pyramid` (complex ``[..., h, w, 6]`` subbands) or, with
        ``layout='planes'``, a :class:`PlanePyramid`.  Odd sizes have their
        last row/column duplicated first.  bfloat16 input is stored as
        bfloat16 only in the plane layout (and computed at float32)."""
        X = torch.as_tensor(X)
        if X.ndim < 2:
            raise ValueError("Transform2d.forward needs at least a 2-D input")
        if layout not in ("interleaved", "planes"):
            raise ValueError("layout must be 'interleaved' or 'planes'")
        planes = layout == "planes"
        b, q = self.biort, self.qshift
        h0o, h1o = b[0], b[2]
        h2o = b[4] if len(b) == 6 else None
        h0a, h0b, h1a, h1b = q[0], q[1], q[4], q[5]
        h2a, h2b = (q[8], q[9]) if len(q) == 12 else (None, None)

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

        scales = [] if include_scale else None
        if nlevels == 0:
            if planes:
                return PlanePyramid(X, (), (), scales)
            return Pyramid(X, (), scales)

        lolo, yh = level1.fwd_level1(X, h0o, h1o, planes=planes, h2o=h2o)
        Yh = [yh]
        if include_scale:
            scales.append(lolo)
        for _ in range(1, nlevels):
            if lolo.shape[-2] % 4:
                lolo = _pad_multiple4(lolo, -2)
            if lolo.shape[-1] % 4:
                lolo = _pad_multiple4(lolo, -1)
            lolo, yh = level2.fwd_level2(lolo, h0a, h0b, h1a, h1b,
                                         planes=planes, h2a=h2a, h2b=h2b)
            Yh.append(yh)
            if include_scale:
                scales.append(lolo)
        if planes:
            return PlanePyramid(lolo, tuple(r for r, _ in Yh),
                                tuple(i for _, i in Yh), scales)
        return Pyramid(lolo, tuple(Yh), scales)

    def inverse(self, pyramid, gain_mask=None) -> torch.Tensor:
        """Inverse transform of a :class:`Pyramid` or :class:`PlanePyramid`.
        *gain_mask* is an optional ``(6, nlevels)`` array of per-subband
        gains in degree order."""
        b, q = self.biort, self.qshift
        g0o, g1o = b[1], b[3]
        g2o = b[5] if len(b) == 6 else None
        g0a, g0b, g1a, g1b = q[2], q[3], q[6], q[7]
        g2a, g2b = (q[10], q[11]) if len(q) == 12 else (None, None)

        plane_pyr = isinstance(pyramid, PlanePyramid)
        Z = torch.as_tensor(pyramid.lowpass)
        sdt = Z.dtype
        if plane_pyr:
            Yb = [(torch.as_tensor(r, device=Z.device).contiguous(),
                   torch.as_tensor(i, device=Z.device).contiguous())
                  for r, i in zip(pyramid.highpasses_re,
                                  pyramid.highpasses_im)]
            hw = [tuple(r.shape[-2:]) for r, _ in Yb]
        else:
            Yh = [torch.as_tensor(h, device=Z.device).contiguous()
                  for h in pyramid.highpasses]
            hw = [tuple(h.shape[-3:-1]) for h in Yh]
            if Yh:
                # the kernels read the lowpass at the subbands' precision
                Z = Z.to(Yh[0].real.dtype)
        nlevels = len(hw)

        if gain_mask is not None:
            # Gains scale each subband before any filtering, so applying them
            # up front is the reference semantics, and the level kernels
            # run gain-free.
            gm = torch.as_tensor(gain_mask, device=Z.device)
            if plane_pyr:
                gp = gm[list(PLANE_BAND_ORDER)]
                Yb = [((r * gp[:, lvl, None, None]).to(r.dtype),
                       (i * gp[:, lvl, None, None]).to(i.dtype))
                      for lvl, (r, i) in enumerate(Yb)]
            else:
                Yh = [h * gm[:, lvl].to(h.real.dtype)
                      for lvl, h in enumerate(Yh)]

        band = (lambda lvl: {"bands": Yb[lvl]}) if plane_pyr else \
            (lambda lvl: {"yh": Yh[lvl]})
        Z = Z.contiguous()
        for lvl in range(nlevels - 1, 0, -1):
            Z = ilevel2.inv_level2(Z, g0a=g0a, g0b=g0b, g1a=g1a, g1b=g1b,
                                   g2a=g2a, g2b=g2b, **band(lvl))
            Z = _crop_to(Z, hw[lvl - 1])
        if nlevels >= 1:
            Z = ilevel1.inv_level1(Z, g0o=g0o, g1o=g1o, g2o=g2o, **band(0))
        return Z.to(sdt)
