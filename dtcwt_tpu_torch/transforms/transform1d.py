"""1-D dual-tree complex wavelet transform, forward and inverse
(``dtcwt_tpu.transforms.transform1d``, its flat path).

A 1-D vector, or a 2-D array whose *columns* are independent signals;
higher-rank inputs are ``[..., N, C]`` batches over the leading axes.  The
signal length must be even; levels >= 2 pad to a multiple of 4 by repeating
the edge samples, and the inverse crops correspondingly.

Each level is one call of a dual-stream module entry (``ops/dual``), which
runs its CUDA kernel on a CUDA tensor and its plain PyTorch version on a CPU
tensor: the forward runs ``filter2_axis`` once, then ``dfilt2_axis`` per
level; the inverse runs ``ifilt2_sum_axis`` per level, then
``filter2_sum_axis``.  The kernels read any axis in place, so the JAX
package's lane folding of long signals with few columns (a TPU
vector-layout device, bit-identical to the flat transform) is not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from dtcwt_tpu_torch.defaults import DEFAULT_BIORT, DEFAULT_QSHIFT
from dtcwt_tpu_torch.ops import dual, linearize
from dtcwt_tpu_torch.ops.packing import (
    c2q1d, c2q1d_planes, q2c1d, q2c1d_planes)
from dtcwt_tpu_torch.transforms.pyramid import PlanePyramid, Pyramid
from dtcwt_tpu_torch.transforms.transform2d import (
    _pad_multiple4, normalize_biort, normalize_qshift)
from dtcwt_tpu_torch.utils import compute_view

__all__ = ["Transform1d"]


def _signal_axis(x: torch.Tensor) -> int:
    return 0 if x.ndim <= 2 else -2


class Transform1d(nn.Module):
    """An n-level 1-D DTCWT parameterised by *biort* / *qshift* wavelets
    (named families or explicit coefficient tuples; no bandpass variants).

    *device* is where the transform runs: every input and pyramid leaf is
    moved there.  The default, ``"cuda"``, runs the CUDA kernels (and raises
    where there is no card); ``device="cpu"`` runs the plain versions."""

    def __init__(self, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
                 device="cuda"):
        super().__init__()
        self.biort = normalize_biort(biort)
        self.qshift = normalize_qshift(qshift)
        if len(self.biort) != 4 or len(self.qshift) != 8:
            raise ValueError("1-D transform does not use bandpass variants")
        self.device = torch.device(device)

    def forward(self, X, nlevels: int = 3, include_scale: bool = False,
                layout: str = "interleaved"):
        """Forward transform of a vector or a columns-of-signals array into
        a :class:`Pyramid` (complex ``[..., N_l, C]`` subbands) or, with
        ``layout='planes'``, a :class:`PlanePyramid` of ``kind='1d'`` whose
        re/im pair per level is the even/odd deinterleave of the tree
        output.  The signal axis (axis 0 for <= 2-D input, axis -2
        otherwise) must have even length.  bfloat16 input is stored as
        bfloat16 only in the plane layout (and computed at float32).  On
        the card an input that requires grad gets its gradient through
        :mod:`ops.linearize`."""
        X = torch.as_tensor(X, device=self.device)
        if X.ndim == 1:
            X = X[:, None]
        axis = _signal_axis(X)
        if X.shape[axis] % 2 != 0:
            raise ValueError("Size of input X must be a multiple of 2")
        if layout not in ("interleaved", "planes"):
            raise ValueError("layout must be 'interleaved' or 'planes'")
        planes = layout == "planes"

        if not X.is_floating_point():
            X = X.to(torch.get_default_dtype())
        if X.dtype == torch.bfloat16 and not planes:
            # there is no bfloat16 complex dtype for the interleaved layout
            X = X.float()

        if nlevels == 0:
            scales = () if include_scale else None
            if planes:
                return PlanePyramid(X, (), (), scales, kind="1d")
            return Pyramid(X, (), scales)

        # no explicit adjoint: the backward differentiates the plain chain,
        # as the JAX package's transposes its XLA evaluation
        return linearize.dispatch(
            lambda x, plain: self._forward_levels(x, nlevels, include_scale,
                                                  planes, plain), X)

    def _forward_levels(self, X, nlevels: int, include_scale: bool,
                        planes: bool, plain: bool = False):
        """The level chain of the forward on the prepared signal *X*: the
        dual entries, or with *plain* their plain versions."""
        h0o, _, h1o, _ = self.biort
        h0a, h0b, _, _, h1a, h1b, _, _ = self.qshift
        filter2 = linearize.entry(dual, "filter2_axis", plain)
        dfilt2 = linearize.entry(dual, "dfilt2_axis", plain)
        axis = _signal_axis(X)
        sdt = X.dtype   # storage dtype; the filters run at compute dtype

        def pack(hi):
            if not planes:
                return q2c1d(hi, axis)
            re, im = q2c1d_planes(hi, axis)
            return re.to(sdt), im.to(sdt)

        lo, hi = filter2(compute_view(X).contiguous(), h0o, h1o, axis)
        Yh, Yscale = [pack(hi)], [lo.to(sdt)] if include_scale else []
        for _ in range(1, nlevels):
            if lo.shape[axis] % 4 != 0:
                lo = _pad_multiple4(lo, axis)
            lo, hi = dfilt2(lo, (h0b, h0a), (h1b, h1a), axis)
            Yh.append(pack(hi))
            if include_scale:
                Yscale.append(lo.to(sdt))

        lo = lo.to(sdt)
        scales = tuple(Yscale) if include_scale else None
        if planes:
            return PlanePyramid(lo, tuple(r for r, _ in Yh),
                                tuple(i for _, i in Yh), scales, kind="1d")
        return Pyramid(lo, tuple(Yh), scales)

    def forward_channels(self, X, nlevels: int = 3,
                         include_scale: bool = False):
        """Forward transform of a 3-D batch of matrices whose *columns* (the
        second dimension) are the signals.  Inputs of 1 or 2 dimensions
        should use :meth:`forward`."""
        X = torch.as_tensor(X, device=self.device)
        if X.ndim != 3:
            raise ValueError(
                "Incorrect input shape for the forward_channels method %s. "
                "For inputs of 1 or 2 dimensions, use the forward method."
                % (tuple(X.shape),))
        return self.forward(X, nlevels, include_scale)

    def inverse_channels(self, pyramid, gain_mask=None) -> torch.Tensor:
        """Inverse of :meth:`forward_channels` on a 3-D pyramid."""
        if torch.as_tensor(pyramid.lowpass).ndim != 3:
            raise ValueError(
                "Incorrect input shape for the inverse_channels method %s. "
                "For inputs of 1 or 2 dimensions, use the inverse method."
                % (tuple(pyramid.lowpass.shape),))
        return self.inverse(pyramid, gain_mask)

    def inverse(self, pyramid, gain_mask=None) -> torch.Tensor:
        """Inverse transform of a :class:`Pyramid` or 1-D
        :class:`PlanePyramid`.  *gain_mask* is an optional
        length-``nlevels`` vector of per-level gains.  A single-column
        signal comes back as a vector.  On the card a pyramid leaf that
        requires grad gets its gradient through :mod:`ops.linearize`."""
        on = lambda a: torch.as_tensor(a, device=self.device)

        lo = on(pyramid.lowpass)
        ret_flat = lo.ndim == 2 and lo.shape[-1] == 1
        sdt = lo.dtype
        plane_pyr = isinstance(pyramid, PlanePyramid)
        if plane_pyr:
            bands = [(on(r), on(i)) for r, i in zip(pyramid.highpasses_re,
                                                    pyramid.highpasses_im)]
        else:
            bands = [on(h) for h in pyramid.highpasses]
        if gain_mask is not None:
            # the gains scale each subband before any filtering
            gm = [float(g) for g in torch.as_tensor(gain_mask).reshape(-1)]
            if plane_pyr:
                bands = [((r * gm[lvl]).to(r.dtype), (i * gm[lvl]).to(i.dtype))
                         for lvl, (r, i) in enumerate(bands)]
            else:
                bands = [h * gm[lvl] for lvl, h in enumerate(bands)]

        lo = compute_view(lo).contiguous()
        if not bands:
            return lo.to(sdt)
        if plane_pyr:
            pyr = PlanePyramid(lo, tuple(r for r, _ in bands),
                               tuple(i for _, i in bands), kind="1d")
        else:
            pyr = Pyramid(lo, tuple(bands))

        Z = linearize.dispatch(self._inverse_levels, pyr)
        if ret_flat:
            return Z[:, 0].to(sdt)
        return Z.to(sdt)

    def _inverse_levels(self, pyramid, plain: bool = False) -> torch.Tensor:
        """The level chain of the inverse on the prepared, gain-free
        *pyramid* (its lowpass at the compute precision): the dual entries,
        or with *plain* their plain versions."""
        _, g0o, _, g1o = self.biort
        _, _, g0a, g0b, _, _, g1a, g1b = self.qshift
        ifilt2_sum = linearize.entry(dual, "ifilt2_sum_axis", plain)
        filter2_sum = linearize.entry(dual, "filter2_sum_axis", plain)
        lo = pyramid.lowpass
        axis = _signal_axis(lo)
        if isinstance(pyramid, PlanePyramid):
            bands = list(zip(pyramid.highpasses_re, pyramid.highpasses_im))
        else:
            bands = list(pyramid.highpasses)

        def hi_at(level):
            """The level's real interleaved highpass branch input, at the
            lowpass's compute dtype."""
            if isinstance(bands[level], tuple):
                re, im = (compute_view(a) for a in bands[level])
                hi = c2q1d_planes(re, im, axis)
            else:
                hi = c2q1d(bands[level], axis)
            return hi.to(lo.dtype)

        def length(level):
            band = bands[level]
            return (band[0] if isinstance(band, tuple) else band).shape[axis]

        for level in range(len(bands) - 1, 0, -1):
            lo = ifilt2_sum(lo, hi_at(level), (g0b, g0a), (g1b, g1a), axis)
            want = 2 * length(level - 1)
            if lo.shape[axis] != want:
                lo = lo.narrow(axis, 1, lo.shape[axis] - 2).contiguous()
            if lo.shape[axis] != want:
                raise ValueError("Yh sizes are not valid for the inverse"
                                 " transform")
        return filter2_sum(lo, hi_at(0), g0o, g1o, axis)
