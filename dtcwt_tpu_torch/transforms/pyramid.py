"""The transform-domain containers of the 1-D, 2-D and 3-D transforms
(``dtcwt_tpu.transforms.pyramid``): plain classes holding tensors."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["Pyramid", "PlanePyramid", "PLANE_BAND_ORDER"]

#: Band order of :class:`PlanePyramid` planes: plane ``p`` holds the subband
#: whose *degree index* (the 15/45/75/105/135/165-degree order of the
#: interleaved layout) is ``PLANE_BAND_ORDER[p]``.  The (p-q, p+q) quad pairs
#: (0,5), (1,4), (2,3) sit adjacent.
PLANE_BAND_ORDER = (0, 5, 1, 4, 2, 3)

# position of degree band d in the plane order (inverse permutation)
_PLANE_POS = tuple(PLANE_BAND_ORDER.index(d) for d in range(6))


class Pyramid:
    """A DTCWT pyramid.

    :ivar lowpass: coarsest-scale real lowpass image ``[..., H, W]``.
    :ivar highpasses: tuple of per-level complex subbands
        ``[..., H_l, W_l, 6]`` in degree order.
    :ivar scales: optional tuple of the intermediate lowpass images (present
        when the transform ran with ``include_scale=True``).
    """

    __slots__ = ("lowpass", "highpasses", "scales")

    def __init__(self, lowpass, highpasses: Tuple,
                 scales: Optional[Tuple] = None):
        self.lowpass = lowpass
        self.highpasses = tuple(highpasses)
        self.scales = None if scales is None else tuple(scales)

    @property
    def nlevels(self) -> int:
        return len(self.highpasses)

    def __repr__(self):
        hp = ", ".join("None" if h is None else str(tuple(h.shape))
                       for h in self.highpasses)
        return "Pyramid(lowpass={}, highpasses=[{}]{})".format(
            tuple(self.lowpass.shape), hp,
            "" if self.scales is None else ", scales=%d" % len(self.scales))


class PlanePyramid:
    """A DTCWT pyramid in the **band-plane layout**: each level holds two
    real tensors, ``highpasses_re`` / ``highpasses_im``.  For the 2-D
    transform (``kind='2d'``) they are band-major ``[..., 6, H_l, W_l]`` in
    :data:`PLANE_BAND_ORDER`, the layout the level kernels write and read
    directly; for the 1-D transform (``kind='1d'``) they are the real and
    imaginary parts of the ``[..., N_l, C]`` subbands, with no band axis;
    for the 3-D transform (``kind='3d'``) they are band-major
    ``[..., 28, D_l, H_l, W_l]`` in the octant band order of the
    interleaved layout.  A ``None`` level (``discard_level_1``) stays
    ``None``.  This is the only layout that stores bfloat16.  Convert with
    :meth:`interleaved` / :meth:`from_interleaved`.
    """

    __slots__ = ("lowpass", "highpasses_re", "highpasses_im", "scales",
                 "kind")

    def __init__(self, lowpass, highpasses_re: Tuple, highpasses_im: Tuple,
                 scales: Optional[Tuple] = None, kind: str = "2d"):
        self.lowpass = lowpass
        self.highpasses_re = tuple(highpasses_re)
        self.highpasses_im = tuple(highpasses_im)
        self.scales = None if scales is None else tuple(scales)
        self.kind = kind

    def interleaved(self) -> Pyramid:
        """The interleaved :class:`Pyramid` (complex band-minor subbands).
        A bfloat16 plane pyramid becomes complex64 / float32."""
        up = lambda a: a.float() if a.dtype == torch.bfloat16 else a

        def pack(re, im):
            if re is None:
                return None
            z = torch.complex(up(re), up(im))
            if self.kind == "1d":
                return z        # no band axis to reorder
            if self.kind == "3d":
                return z.movedim(-4, -1).contiguous()
            return torch.stack([z[..., p, :, :] for p in _PLANE_POS], dim=-1)

        return Pyramid(up(self.lowpass),
                       tuple(pack(re, im) for re, im in
                             zip(self.highpasses_re, self.highpasses_im)),
                       None if self.scales is None
                       else tuple(up(s) for s in self.scales))

    @classmethod
    def from_interleaved(cls, p: Pyramid, kind: str = "2d") -> "PlanePyramid":
        """Split an interleaved pyramid of the 2-D (``kind='2d'``), 1-D
        (``kind='1d'``) or 3-D (``kind='3d'``) transform into planes."""
        def split(h):
            if h is None:
                return None
            if kind == "1d":
                return h
            if kind == "3d":
                return h.movedim(-1, -4)
            return torch.stack([h[..., d] for d in PLANE_BAND_ORDER], dim=-3)

        planes = [split(h) for h in p.highpasses]
        part = lambda z, f: None if z is None else f(z).contiguous()
        return cls(p.lowpass, tuple(part(z, torch.real) for z in planes),
                   tuple(part(z, torch.imag) for z in planes), p.scales,
                   kind=kind)

    @property
    def nlevels(self) -> int:
        return len(self.highpasses_re)

    def __repr__(self):
        hp = ", ".join("None" if h is None else str(tuple(h.shape))
                       for h in self.highpasses_re)
        return "PlanePyramid(lowpass={}, planes=[{}]{})".format(
            tuple(self.lowpass.shape), hp,
            "" if self.scales is None else ", scales=%d" % len(self.scales))
