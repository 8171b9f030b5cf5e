"""The host tilings of the kernels built on ``csrc/hwtile.cuh``'s analysis
stages: the sharded path's ``filter_hw22`` / ``dfilt_hw22``
(``csrc/hwana.cuh`` ``hw22_kernel``, wrapped by :mod:`hw`) and the 3-D
analysis levels ``fwd_level1_pack`` / ``fwd_level2_pack``
(``csrc/fpack.cuh`` ``fwd_pack_kernel``, wrapped by :mod:`pack3d`), which
runs hw22's per-slice stages on each slice of a depth branch.

Each kernel takes its tap bound and tile from here and its C entry refuses
any other; ``tests/test_torch_hw_tiling.py`` and
``tests/test_torch_pack3d_tiling.py`` replay them block by block.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dtcwt_tpu_torch.ops.dual import _inv_taps

_TILE = 32                     # csrc/hwtile.cuh HS_TILE
_THREADS = 256                 # PACK_THREADS
_SMEM_MAX = 220 * 1024         # PACK_SMEM_MAX
_RESTAGE = 8 * _THREADS        # csrc/fpack.cuh FWD_RS: [8 warps][32][8]
#: Tap bounds of the analysis instances by streams a stage, every dtype
#: (csrc/taps.cuh hs_bound): filter (P = 1) 5, 7, 9, 19, 31, the largest
#: holding odd filters of 31 taps; dfilt (P = 2) a stream's window in half
#: samples, 10, 14, 16, 18, 32, the largest holding qshift pairs of 32 (two
#: streams of 32 taps at stride 2)
_HW_BOUNDS = {1: (5, 7, 9, 19, 31), 2: (10, 14, 16, 18, 32)}


def _least_bound(plans, P: int, bounds, what: str) -> int:
    """The least of *bounds* that holds the plans (the taps centred on its
    halo, csrc/taps.cuh make_hs_taps, as :func:`dual._inv_taps`
    centres them)."""
    for mt in bounds:
        if _inv_taps(plans, P, mt) is not None:
            return mt
    raise ValueError("the hw %s kernel's largest tap bound, %d, does not "
                     "hold these filters" % (what, bounds[-1]))


def _hw22_tap_bound(plans, P: int) -> int:
    """The least tap bound of the analysis instances that holds the plans:
    filter 5 (legall), 7 (near_sym_a), 9 (antonini), 19 (near_sym_b) or
    31; dfilt a stream's length, 10 (qshift_06, qshift_a), 14 (qshift_b),
    16 (qshift_c), 18 (qshift_d) or 32 (qshift_32)."""
    return _least_bound(plans, P, _HW_BOUNDS[P], "analysis")


class Hw22Geometry(NamedTuple):
    """The tile of an analysis kernel (csrc/hwana.cuh HaGeo): oh x ow
    output samples of each of the four outputs, 256 threads a block, a
    block for each tile of each slice; the tap bound mt and its halo ph
    (window steps); the staged area xr x xc (square) of the one input from
    so samples before the tile's first input row and column (the halo
    P ph rounded up to 4, so that it starts 16 bytes aligned and even),
    its windows starting dl = so - P ph in; xs the staged row stride
    (dfilt's padded to 4 (mod 8) values); ns the samples a window of 4
    outputs reads from dl on (filter mt + 3, dfilt 2 mt + 4) and nw the W
    stage's window in 16-byte vectors; cw the values a staging chunk (f32
    and bf16 4, f64 2) and smem the dynamic shared memory bytes (the
    staged image [xr][xs], the W stage's two [xr][ow], the int row and
    column maps)."""
    oh: int
    ow: int
    mt: int
    ph: int
    so: int
    dl: int
    xr: int
    xc: int
    xs: int
    ns: int
    nw: int
    cw: int
    smem: int

    def tile(self):
        """The ints the C entry takes: oh, ow, mt, xr, xc, smem."""
        return self.oh, self.ow, self.mt, self.xr, self.xc, self.smem


@functools.lru_cache(maxsize=None)
def _hw22_geometry(P: int, mt: int, dtype: torch.dtype) -> Hw22Geometry:
    """The tile of an analysis kernel with *P* streams a stage (1: filter,
    2: dfilt) and tap bound *mt* (:func:`_hw22_tap_bound`) in *dtype*: 32 x
    32 output samples from a staged area of P 32 input samples and so each
    side.  At the main path's bounds in float32 its shared memory (17 KB
    for filter at 7, 47 KB for dfilt at 10) leaves an SM eight and four
    blocks; float64 at the largest bounds fits.  Cached: the sharded
    transform asks for the same tile at every call."""
    acc = 8 if dtype == torch.float64 else 4
    ph = (mt - 1) // 2
    so = (P * ph + 3) // 4 * 4
    dl = so - P * ph
    x = P * _TILE + 2 * so
    xs = x if P == 1 or x % 8 == 4 else x + 4
    vv = 16 // acc
    ns = mt + 3 if P == 1 else 2 * mt + 4
    nw = -(-(dl + ns) // vv) * vv
    smem = acc * (x * xs + 2 * x * _TILE) + 4 * 2 * x
    return Hw22Geometry(_TILE, _TILE, mt, ph, so, dl, x, x, xs, ns, nw, vv,
                        smem)


class FwdPackGeometry(NamedTuple):
    """The tile of a 3-D analysis kernel (csrc/fpack.cuh FpGeo): *hw* the
    geometry of one slice's stages (:func:`_hw22_geometry`: the 32 x 32
    output tile, the tap bound, the staged slice, its windows), rs the
    values of the interleaved layout's restage ([8 warps][32 lanes][8]; 0
    for planes) and smem the dynamic shared memory bytes (hw's and the
    restage)."""
    hw: Hw22Geometry
    rs: int
    smem: int

    def tile(self):
        """The ints the C entry takes: oh, ow, mt, xr, xc, smem."""
        return self.hw.tile()[:5] + (self.smem,)


@functools.lru_cache(maxsize=None)
def _fwd_pack_geometry(P: int, mt: int, dtype: torch.dtype,
                       planes: bool) -> FwdPackGeometry:
    """The tile of a 3-D analysis kernel with *P* streams a stage (1: level
    1, 2: level 2) and tap bound *mt* (:func:`_hw22_tap_bound`) for
    *dtype*'s subbands in the plane or interleaved layout: hw22's slice
    geometry and the restage.  At the main path's bounds in float32
    (near_sym_a 7, qshift_a 10) the shared memory (25 KB and 55 KB
    interleaved) allows an SM eight and four blocks; float64 at the largest
    bounds fits (213 KB).  Cached: a transform asks for the same tile at
    every call."""
    geo = _hw22_geometry(P, mt, dtype)
    rs = 0 if planes else _RESTAGE
    return FwdPackGeometry(geo, rs, geo.smem + (8 if dtype == torch.float64
                                                else 4) * rs)
