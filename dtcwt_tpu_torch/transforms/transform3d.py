"""3-D dual-tree complex wavelet transform, forward and inverse
(``dtcwt_tpu.transforms.transform3d``).

A ``[..., D, H, W]`` volume; each level has 28 directional subbands, the 7
highpass octants of the separable tree packed 4 to an octant in the order
:data:`ops.pack3d._OCTANTS`.  Each level is one call of an ``ops/pack3d``
entry, which on a CUDA tensor runs the depth stage on the dual-stream
kernels (``ops/dual``) and the (H, W) stages and the (un)pack in one
kernel, and on a CPU tensor its plain PyTorch version.  Odd-length level-1
filters take that route; even-length custom level-1 filters run the
separable tree on the dual kernels with the packing in PyTorch, the JAX
package's own route for them.  ``discard_level_1`` replaces level 1 by its
lowpass-only tree: three single-stream filter passes (``ops/single``) each
way.  What stays here is glue: the ``ext_mode`` divisibility check and
edge-repeat padding of levels >= 2, the inverse's crop, the even-filter
trims and the bfloat16 rules (bfloat16 is storage: the arithmetic runs at
float32, and the lowpass is stored in bfloat16 at each level boundary).
The transform runs on its ``device`` ("cuda" unless the caller asks for
"cpu") and moves its inputs there.
"""

from __future__ import annotations

import torch
from torch import nn

from dtcwt_tpu_torch.defaults import DEFAULT_BIORT, DEFAULT_QSHIFT
from dtcwt_tpu_torch.ops import dual, pack3d, single
from dtcwt_tpu_torch.transforms.pyramid import PlanePyramid, Pyramid
from dtcwt_tpu_torch.transforms.transform2d import (
    normalize_biort, normalize_qshift)
from dtcwt_tpu_torch.utils import compute_view

__all__ = ["Transform3d"]

# the octant order of the 28 subbands, reused by the sharded transform
_OCTANTS = pack3d._OCTANTS


def _repeat_edges(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """Append *n* copies of the first / last sample at each end of *axis*."""
    first = x.narrow(axis, 0, 1)
    last = x.narrow(axis, x.shape[axis] - 1, 1)
    return torch.cat([first] * n + [x] + [last] * n, dim=axis)


def _trim_last(v: torch.Tensor) -> torch.Tensor:
    """Drop the trailing sample of D, H and W (even-length level-1 filters
    emit one more sample than they read)."""
    return v[..., :-1, :-1, :-1]


def _lowpass_only(x: torch.Tensor, h, axes) -> torch.Tensor:
    """The single-branch tree of ``discard_level_1``: the odd filter *h*
    along each of *axes* in turn, at the compute precision (bfloat16 is
    widened once and stored once at the end)."""
    out = compute_view(x)
    for ax in axes:
        out = single.filter_axis(out, h, ax)
    return out.to(x.dtype)


class Transform3d(nn.Module):
    """An n-level 3-D DTCWT with 28 directional subbands per level,
    parameterised by *biort* (level 1) and *qshift* (levels >= 2) wavelets:
    named families or explicit coefficient tuples.

    *ext_mode* is 4 or 8: the input must be a multiple of 2 (mode 4) or 4
    (mode 8) along D, H and W, and before each level >= 2 an axis that is
    not a multiple of *ext_mode* is padded by repeating its edge samples 1
    (mode 4) or 2 (mode 8) times.

    *device* is where the transform runs: every input and pyramid leaf is
    moved there.  The default, ``"cuda"``, runs the CUDA kernels (and raises
    where there is no card); ``device="cpu"`` runs the plain versions."""

    def __init__(self, biort=DEFAULT_BIORT, qshift=DEFAULT_QSHIFT,
                 ext_mode: int = 4, device="cuda"):
        super().__init__()
        self.biort = normalize_biort(biort)
        self.qshift = normalize_qshift(qshift)
        if ext_mode not in (4, 8):
            raise ValueError("ext_mode must be one of 4 or 8")
        self.ext_mode = ext_mode
        self.device = torch.device(device)

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def forward(self, X, nlevels: int = 3, include_scale: bool = False,
                discard_level_1: bool = False, layout: str = "interleaved"):
        """Forward transform of a ``[..., D, H, W]`` real volume into a
        :class:`Pyramid` (complex ``[..., D', H', W', 28]`` subbands) or,
        with ``layout='planes'``, a :class:`PlanePyramid` of ``kind='3d'``
        (band-major ``[..., 28, D', H', W']`` planes).  With
        *discard_level_1* the first level is ``None``.  bfloat16 input is
        stored as bfloat16 only in the plane layout."""
        X = torch.as_tensor(X, device=self.device)
        if X.ndim < 3:
            raise ValueError("Transform3d.forward needs at least a 3-D input")
        if layout not in ("interleaved", "planes"):
            raise ValueError("layout must be 'interleaved' or 'planes'")
        div = 2 if self.ext_mode == 4 else 4
        if any(X.shape[d] % div for d in (-3, -2, -1)):
            raise ValueError(
                "Input shape should be a multiple of %d in each direction "
                "when ext_mode == %d" % (div, self.ext_mode))
        planes = layout == "planes"
        h0o, h1o = self.biort[0], self.biort[2]
        if discard_level_1 and nlevels > 0 and h0o.size % 2 == 0:
            raise ValueError("discard_level_1 requires odd-length level-1"
                             " filters")
        if not X.is_floating_point():
            X = X.to(torch.get_default_dtype())
        if X.dtype == torch.bfloat16 and not planes:
            # there is no bfloat16 complex dtype for the interleaved layout
            X = X.float()
        X = X.contiguous()

        Yl, Yh, Yscale = X, [], []
        for level in range(nlevels):
            if level == 0 and discard_level_1:
                # reference axis order: W, H, D
                Yl = _lowpass_only(Yl, h0o, (-1, -2, -3))
                hp = (None, None) if planes else None
            elif level == 0:
                Yl, hp = self._level1_fwd(Yl, planes)
            else:
                Yl, hp = self._level2_fwd(Yl, planes)
            Yh.append(hp)
            if include_scale:
                Yscale.append(Yl)
        scales = tuple(Yscale) if include_scale else None
        if planes:
            return PlanePyramid(Yl, tuple(r for r, _ in Yh),
                                tuple(i for _, i in Yh), scales, kind="3d")
        return Pyramid(Yl, tuple(Yh), scales)

    def _level1_fwd(self, X, planes):
        h0o, h1o = self.biort[0], self.biort[2]
        if h0o.size % 2 and h1o.size % 2:
            return pack3d.fwd_level1_pack(X, h0o, h1o, planes)
        # even-length filters: the separable tree on the dual kernels; the
        # highpass octants drop the extra trailing sample, the lowpass
        # keeps it
        octs = pack3d.analysis_octants(
            compute_view(X), lambda v, ax: dual.filter2_axis(v, h0o, h1o,
                                                             ax))
        lll = octs.pop((0, 0, 0))
        octs = {o: _trim_last(v) for o, v in octs.items()}
        return lll.to(X.dtype), pack3d.pack_octants(octs, planes, X.dtype)

    def _level2_fwd(self, X, planes):
        q = self.qshift
        rep = 1 if self.ext_mode == 4 else 2
        for ax in (-3, -2, -1):
            if X.shape[ax] % self.ext_mode:
                X = _repeat_edges(X, ax, rep)
        return pack3d.fwd_level2_pack(X.contiguous(), (q[1], q[0]),
                                      (q[5], q[4]), planes)

    # ------------------------------------------------------------------
    # inverse
    # ------------------------------------------------------------------
    def inverse(self, pyramid) -> torch.Tensor:
        """Inverse transform of a :class:`Pyramid` or 3-D
        :class:`PlanePyramid`.  A ``None`` first level (``discard_level_1``)
        is treated as zero."""
        on = lambda a: None if a is None else torch.as_tensor(
            a, device=self.device).contiguous()
        Yl = on(pyramid.lowpass)
        if isinstance(pyramid, PlanePyramid):
            levels = [None if r is None else (on(r), on(i)) for r, i in
                      zip(pyramid.highpasses_re, pyramid.highpasses_im)]
            spatial = lambda lvl: tuple(levels[lvl][0].shape[-3:])
            # the kernels read the subbands at the lowpass's dtype
            levels = [None if lv is None else tuple(a.to(Yl.dtype) for a in lv)
                      for lv in levels]
        else:
            levels = [on(h) for h in pyramid.highpasses]
            spatial = lambda lvl: tuple(levels[lvl].shape[-4:-1])
            known = [h for h in levels if h is not None]
            if known:
                Yl = Yl.to(known[0].real.dtype)
        band = lambda lvl: (levels[lvl] if isinstance(levels[lvl], tuple)
                            else (levels[lvl], None))
        q = self.qshift
        crop = 1 if self.ext_mode == 4 else 2
        nlevels = len(levels)
        for level in range(nlevels - 1, 0, -1):
            curr = spatial(level)
            prev = (spatial(level - 1) if levels[level - 1] is not None
                    else tuple(2 * s for s in curr))
            Yl = pack3d.inv_level2_pack(Yl, *band(level), (q[3], q[2]),
                                        (q[7], q[6]))
            for d, ax in enumerate((-3, -2, -1)):
                if 2 * curr[d] != prev[d]:
                    Yl = Yl.narrow(ax, crop, Yl.shape[ax] - 2 * crop)
            Yl = Yl.contiguous()
        if nlevels >= 1:
            g0o, g1o = self.biort[1], self.biort[3]
            if levels[0] is None:
                # reference axis order: H, D, W
                Yl = _lowpass_only(Yl, g0o, (-2, -3, -1))
            elif g0o.size % 2 and g1o.size % 2:
                Yl = pack3d.inv_level1_pack(Yl, *band(0), g0o, g1o)
            else:
                Yl = self._level1_inv_tree(Yl, levels[0])
        return Yl

    def _level1_inv_tree(self, Yl, level0):
        """Even-length level-1 synthesis: the separable tree on the dual
        kernels, with the even-filter trims."""
        g0o, g1o = self.biort[1], self.biort[3]
        sdt = Yl.dtype
        octs = pack3d.unpack_octants(level0)
        octs[(0, 0, 0)] = compute_view(_trim_last(Yl)).contiguous()
        out = pack3d.synthesis(octs, lambda a, b, ax: dual.filter2_sum_axis(
            a.contiguous(), b.contiguous(), g0o, g1o, ax))
        return out[..., 1:, 1:, 1:].to(sdt).contiguous()
