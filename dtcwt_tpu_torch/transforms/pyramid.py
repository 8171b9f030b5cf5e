"""The transform-domain containers of the 2-D transform
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
        hp = ", ".join(str(tuple(h.shape)) for h in self.highpasses)
        return "Pyramid(lowpass={}, highpasses=[{}]{})".format(
            tuple(self.lowpass.shape), hp,
            "" if self.scales is None else ", scales=%d" % len(self.scales))


class PlanePyramid:
    """A 2-D DTCWT pyramid in the **band-plane layout**: each level holds
    two real band-major tensors ``[..., 6, H_l, W_l]`` (``highpasses_re`` /
    ``highpasses_im``) in :data:`PLANE_BAND_ORDER`.  This is the layout the
    level kernels write and read directly, and the only one that stores
    bfloat16.  Convert with :meth:`interleaved` / :meth:`from_interleaved`.
    """

    __slots__ = ("lowpass", "highpasses_re", "highpasses_im", "scales")
    kind = "2d"     # the JAX package's container also carries 1-D and 3-D

    def __init__(self, lowpass, highpasses_re: Tuple, highpasses_im: Tuple,
                 scales: Optional[Tuple] = None):
        self.lowpass = lowpass
        self.highpasses_re = tuple(highpasses_re)
        self.highpasses_im = tuple(highpasses_im)
        self.scales = None if scales is None else tuple(scales)

    def interleaved(self) -> Pyramid:
        """The interleaved :class:`Pyramid` (complex band-minor subbands).
        A bfloat16 plane pyramid becomes complex64 / float32."""
        up = lambda a: a.float() if a.dtype == torch.bfloat16 else a

        def pack(re, im):
            z = torch.complex(up(re), up(im))
            return torch.stack([z[..., p, :, :] for p in _PLANE_POS], dim=-1)

        return Pyramid(up(self.lowpass),
                       tuple(pack(re, im) for re, im in
                             zip(self.highpasses_re, self.highpasses_im)),
                       None if self.scales is None
                       else tuple(up(s) for s in self.scales))

    @classmethod
    def from_interleaved(cls, p: Pyramid) -> "PlanePyramid":
        """Split an interleaved pyramid into band planes."""
        planes = [torch.stack([h[..., d] for d in PLANE_BAND_ORDER], dim=-3)
                  for h in p.highpasses]
        return cls(p.lowpass, tuple(z.real.contiguous() for z in planes),
                   tuple(z.imag.contiguous() for z in planes), p.scales)

    @property
    def nlevels(self) -> int:
        return len(self.highpasses_re)

    def __repr__(self):
        hp = ", ".join(str(tuple(h.shape)) for h in self.highpasses_re)
        return "PlanePyramid(lowpass={}, planes=[{}]{})".format(
            tuple(self.lowpass.shape), hp,
            "" if self.scales is None else ", scales=%d" % len(self.scales))
