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

On the card, where grad mode is on and an input requires grad, the level
chain runs as one ``linearize.linear_vjp`` Function, as in the 2-D
transform: its backward is the explicit adjoint (``_fwd_adjoint_fn``,
``_inv_adjoint_fn``: the opposite pack3d entries at levels >= 2 and seven
of ``ops/adjoint``'s level-1 adjoints on the dual kernels) where the
filters, dtype and shapes allow, and the plain chain's ``torch.func.vjp``
elsewhere (``discard_level_1``, ``include_scale``, even filters, pads and
crops in the chain, bfloat16).
"""

from __future__ import annotations

import torch
from torch import nn

from dtcwt_tpu_torch.defaults import DEFAULT_BIORT, DEFAULT_QSHIFT
from dtcwt_tpu_torch.ops import adjoint, dual, linearize, pack3d, single
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


def _lowpass_only(x: torch.Tensor, h, axes, plain: bool = False):
    """The single-branch tree of ``discard_level_1``: the odd filter *h*
    along each of *axes* in turn, at the compute precision (bfloat16 is
    widened once and stored once at the end); with *plain* on the plain
    version of the filter entry."""
    filt = linearize.entry(single, "filter_axis", plain)
    out = compute_view(x)
    for ax in axes:
        out = filt(out, h, ax)
    return out.to(x.dtype)


def _levels(pyramid):
    """Each level's subbands as the pack3d entries take them: ``(re, im)``
    planes, ``(complex, None)``, or None for a discarded level."""
    if isinstance(pyramid, PlanePyramid):
        return [None if r is None else (r, i) for r, i in
                zip(pyramid.highpasses_re, pyramid.highpasses_im)]
    return [None if h is None else (h, None) for h in pyramid.highpasses]


def _spatial(level):
    """(D, H, W) of a level's subbands (see :func:`_levels`)."""
    re, im = level
    return tuple(re.shape[-3:] if im is not None else re.shape[-4:-1])


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
        stored as bfloat16 only in the plane layout.  On the card an input
        that requires grad gets its gradient through :mod:`ops.linearize`."""
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
        if discard_level_1 and nlevels > 0 and self.biort[0].size % 2 == 0:
            raise ValueError("discard_level_1 requires odd-length level-1"
                             " filters")
        if not X.is_floating_point():
            X = X.to(torch.get_default_dtype())
        if X.dtype == torch.bfloat16 and not planes:
            # there is no bfloat16 complex dtype for the interleaved layout
            X = X.float()
        X = X.contiguous()

        if nlevels == 0:
            # no level: the pyramid holds the input itself
            return self._forward_levels(X, 0, include_scale, False, planes)
        return linearize.dispatch(
            lambda x, plain: self._forward_levels(
                x, nlevels, include_scale, discard_level_1, planes, plain),
            X,
            lambda: self._fwd_adjoint_fn(X.shape, X.dtype, nlevels,
                                         include_scale, discard_level_1,
                                         planes))

    def _forward_levels(self, X, nlevels: int, include_scale: bool,
                        discard_level_1: bool, planes: bool,
                        plain: bool = False):
        """The level chain of the forward on the prepared volume *X*: the
        level entries, or with *plain* their plain versions."""
        Yl, Yh, Yscale = X, [], []
        for level in range(nlevels):
            if level == 0 and discard_level_1:
                # reference axis order: W, H, D
                Yl = _lowpass_only(Yl, self.biort[0], (-1, -2, -3), plain)
                hp = (None, None) if planes else None
            elif level == 0:
                Yl, hp = self._level1_fwd(Yl, planes, plain)
            else:
                Yl, hp = self._level2_fwd(Yl, planes, plain)
            Yh.append(hp)
            if include_scale:
                Yscale.append(Yl)
        scales = tuple(Yscale) if include_scale else None
        if planes:
            return PlanePyramid(Yl, tuple(r for r, _ in Yh),
                                tuple(i for _, i in Yh), scales, kind="3d")
        return Pyramid(Yl, tuple(Yh), scales)

    def _level1_fwd(self, X, planes, plain: bool = False):
        h0o, h1o = self.biort[0], self.biort[2]
        if h0o.size % 2 and h1o.size % 2:
            return linearize.entry(pack3d, "fwd_level1_pack", plain)(
                X, h0o, h1o, planes)
        # even-length filters: the separable tree on the dual kernels; the
        # highpass octants drop the extra trailing sample, the lowpass
        # keeps it
        split = linearize.entry(dual, "filter2_axis", plain)
        octs = pack3d.analysis_octants(
            compute_view(X), lambda v, ax: split(v, h0o, h1o, ax))
        lll = octs.pop((0, 0, 0))
        octs = {o: _trim_last(v) for o, v in octs.items()}
        return lll.to(X.dtype), pack3d.pack_octants(octs, planes, X.dtype)

    def _level2_fwd(self, X, planes, plain: bool = False):
        q = self.qshift
        rep = 1 if self.ext_mode == 4 else 2
        for ax in (-3, -2, -1):
            if X.shape[ax] % self.ext_mode:
                X = _repeat_edges(X, ax, rep)
        return linearize.entry(pack3d, "fwd_level2_pack", plain)(
            X.contiguous(), (q[1], q[0]), (q[5], q[4]), planes)

    # ------------------------------------------------------------------
    # inverse
    # ------------------------------------------------------------------
    def inverse(self, pyramid) -> torch.Tensor:
        """Inverse transform of a :class:`Pyramid` or 3-D
        :class:`PlanePyramid`.  A ``None`` first level (``discard_level_1``)
        is treated as zero.  On the card a pyramid leaf that requires grad
        gets its gradient through :mod:`ops.linearize`."""
        on = lambda a: None if a is None else torch.as_tensor(
            a, device=self.device).contiguous()
        Yl = on(pyramid.lowpass)
        if isinstance(pyramid, PlanePyramid):
            # the kernels read the subbands at the lowpass's dtype
            cast = lambda a: None if a is None else on(a).to(Yl.dtype)
            pyr = PlanePyramid(Yl, tuple(map(cast, pyramid.highpasses_re)),
                               tuple(map(cast, pyramid.highpasses_im)),
                               kind="3d")
        else:
            Yh = tuple(map(on, pyramid.highpasses))
            known = [h for h in Yh if h is not None]
            if known:
                Yl = Yl.to(known[0].real.dtype)
            pyr = Pyramid(Yl, Yh)
        if not pyr.nlevels:
            return Yl

        return linearize.dispatch(self._inverse_levels, pyr,
                                  lambda: self._inv_adjoint_fn(pyr))

    def _inverse_levels(self, pyramid, plain: bool = False) -> torch.Tensor:
        """The level chain of the inverse on the prepared *pyramid*
        (contiguous leaves, the subbands at the lowpass's precision): the
        level entries, or with *plain* their plain versions."""
        levels = _levels(pyramid)
        q = self.qshift
        crop = 1 if self.ext_mode == 4 else 2
        Yl = pyramid.lowpass
        for level in range(len(levels) - 1, 0, -1):
            curr = _spatial(levels[level])
            prev = (_spatial(levels[level - 1]) if levels[level - 1]
                    is not None else tuple(2 * s for s in curr))
            Yl = linearize.entry(pack3d, "inv_level2_pack", plain)(
                Yl, *levels[level], (q[3], q[2]), (q[7], q[6]))
            for d, ax in enumerate((-3, -2, -1)):
                if 2 * curr[d] != prev[d]:
                    Yl = Yl.narrow(ax, crop, Yl.shape[ax] - 2 * crop)
            Yl = Yl.contiguous()
        g0o, g1o = self.biort[1], self.biort[3]
        if levels[0] is None:
            # reference axis order: H, D, W
            return _lowpass_only(Yl, g0o, (-2, -3, -1), plain)
        if g0o.size % 2 and g1o.size % 2:
            return linearize.entry(pack3d, "inv_level1_pack", plain)(
                Yl, *levels[0], g0o, g1o)
        return self._level1_inv_tree(Yl, levels[0], plain)

    def _level1_inv_tree(self, Yl, level0, plain: bool = False):
        """Even-length level-1 synthesis: the separable tree on the dual
        kernels, with the even-filter trims."""
        g0o, g1o = self.biort[1], self.biort[3]
        merge = linearize.entry(dual, "filter2_sum_axis", plain)
        sdt = Yl.dtype
        octs = pack3d.unpack_octants(level0[0] if level0[1] is None
                                     else level0)
        octs[(0, 0, 0)] = compute_view(_trim_last(Yl)).contiguous()
        out = pack3d.synthesis(octs, lambda a, b, ax: merge(
            a.contiguous(), b.contiguous(), g0o, g1o, ax))
        return out[..., 1:, 1:, 1:].to(sdt).contiguous()

    # ------------------------------------------------------------------
    # explicit adjoints (ops/adjoint.py; the 2-D ones' structure): a qshift
    # level's adjoint is the opposite pack3d entry, cube2c's is c2cube,
    # and level 1's the zero-extension correlation on the dual kernels
    # plus a border fold along each axis.  None outside their envelope:
    # the backward then differentiates the plain chain.
    # ------------------------------------------------------------------
    def _adjoint_shapes_ok(self, spatial, nlevels: int) -> bool:
        """Pad- and crop-free level chain: every level divides exactly."""
        pw = nlevels + (1 if self.ext_mode == 8 else 0)
        return not any(s % (2 ** max(pw, 1)) for s in spatial)

    def _fwd_adjoint_fn(self, shape, dtype, nlevels: int, include_scale: bool,
                        discard_level_1: bool, planes: bool):
        """The forward's adjoint (result gradient -> volume gradient), or
        None outside its envelope (filters, dtype, scales, a discarded
        level 1, a pad in the chain, a side shorter than the fold)."""
        if (include_scale or discard_level_1
                or not adjoint.explicit_route(self.biort, self.qshift, dtype)):
            return None
        h0o, h1o = self.biort[0], self.biort[2]
        spatial = tuple(shape[-3:])
        if (not self._adjoint_shapes_ok(spatial, nlevels)
                or min(spatial) < max(h0o.size, h1o.size) // 2):
            return None

        def adj(cot):
            levels = _levels(cot)
            Yl = cot.lowpass
            for level in range(nlevels - 1, 0, -1):
                Yl = self._level2_fwd_adj(Yl, levels[level])
            return self._level1_fwd_adj(Yl, levels[0])
        return adj

    def _level1_fwd_adj(self, lll_bar, band_bar):
        """Adjoint of the odd-filter level 1 (``fwd_level1_pack``): the
        gradients of its lowpass and of its subbands (``(re, im)`` planes
        or ``(complex, None)``, see :func:`_levels`) to the volume's; the
        sharded transform's replicated level 1 takes it too."""
        h0o, h1o = self.biort[0], self.biort[2]
        re, im = band_bar
        oc = pack3d.unpack_octants(re if im is None else (re, im))
        oc[(0, 0, 0)] = lll_bar
        V = {(j, k): adjoint.filter2_sum_adj_axis(
            oc[(0, j, k)], oc[(1, j, k)], h0o, h1o, -3)
            for j in range(2) for k in range(2)}
        u0, u1 = (adjoint.filter2_sum_adj_axis(V[(0, k)], V[(1, k)], h0o,
                                               h1o, -2) for k in range(2))
        return adjoint.filter2_sum_adj_axis(u0, u1, h0o, h1o, -1)

    def _level2_fwd_adj(self, lll_bar, band_bar):
        """Adjoint of a pad-free qshift level (``fwd_level2_pack``): the
        opposite level kernel, ``inv_level2_pack`` with the synthesis
        pairs."""
        q = self.qshift
        return pack3d.inv_level2_pack(lll_bar, *band_bar, (q[3], q[2]),
                                      (q[7], q[6]))

    def _inv_adjoint_fn(self, pyramid):
        """The inverse's adjoint (volume gradient -> pyramid gradient) of
        the prepared *pyramid*, or None outside its envelope (filters,
        dtype, a discarded level 1, a crop in the chain, a side shorter
        than the fold)."""
        planes = isinstance(pyramid, PlanePyramid)
        dtype = pyramid.lowpass.dtype
        low_dhw = tuple(pyramid.lowpass.shape[-3:])
        levels = _levels(pyramid)
        if (any(lv is None for lv in levels)
                or not adjoint.explicit_route(self.biort, self.qshift,
                                              dtype)):
            return None
        shapes = [_spatial(lv) for lv in levels]
        double = lambda s: tuple(2 * v for v in s)
        nlevels = len(shapes)
        g0o, g1o = self.biort[1], self.biort[3]
        if (any(shapes[lvl - 1] != double(shapes[lvl])
                for lvl in range(1, nlevels))
                or low_dhw != double(shapes[-1])
                or not self._adjoint_shapes_ok(double(shapes[0]), nlevels)
                or 2 * min(shapes[0]) < max(g0o.size, g1o.size) // 2):
            return None
        q = self.qshift
        pair0, pair1 = (q[1], q[0]), (q[5], q[4])

        def adj(xbar):
            u0b, u1b = adjoint.filter2_adj_axis(xbar, g0o, g1o, -1)
            V = {}
            V[(0, 0)], V[(1, 0)] = adjoint.filter2_adj_axis(u0b, g0o, g1o, -2)
            V[(0, 1)], V[(1, 1)] = adjoint.filter2_adj_axis(u1b, g0o, g1o, -2)
            octs = {}
            for (j, k), vb in V.items():
                octs[(0, j, k)], octs[(1, j, k)] = adjoint.filter2_adj_axis(
                    vb, g0o, g1o, -3)
            lll = octs.pop((0, 0, 0))
            Yh = [pack3d.pack_octants(octs, planes, dtype)]
            for _ in range(1, nlevels):
                lll, hp = pack3d.fwd_level2_pack(lll, pair0, pair1, planes)
                Yh.append(hp)
            if planes:
                return PlanePyramid(lll, tuple(r for r, _ in Yh),
                                    tuple(i for _, i in Yh), kind="3d")
            return Pyramid(lll, tuple(Yh))
        return adj
