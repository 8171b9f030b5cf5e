"""The four level kernels of the 3-D DTCWT: CUDA kernels and their plain
versions.

Replaces the Pallas kernels of ``dtcwt_tpu/ops/pallas_pack3d.py``:

===================  ================================  ======================
entry                one level                         replaces
===================  ================================  ======================
``fwd_level1_pack``  biort analysis + cube2c pack      ``_build_pack_pairs``
``inv_level1_pack``  c2cube unpack + biort synthesis   ``_build_unpack_pairs``
``fwd_level2_pack``  qshift analysis + cube2c pack     ``_build_pack_pairs2``
``inv_level2_pack``  c2cube unpack + qshift synthesis  ``_build_unpack_pairs2``
===================  ================================  ======================

Each level is a separable filter tree over ``[..., D, H, W]`` plus the
octet <-> complex packing of its 7 highpass octants into 28 subbands, in
the octant order :data:`_OCTANTS`.  On a CUDA tensor the depth stage runs
on the dual-stream kernels of :mod:`dual` along axis -3 (first on analysis,
last on synthesis) and a kernel does the (H, W) stages and the (un)pack
per depth-slice pair: the analysis kernel of
``csrc/fpack.cu`` (``csrc/fpack.cuh``), the synthesis kernel of
``csrc/pack3d.cu`` (``csrc/ipack.cuh``); what bounds each and what its
design does about it is in those sources.  The analysis kernels take their
tap bound and tile from :func:`hwtile._hw22_tap_bound` and
:func:`hwtile._fwd_pack_geometry` (hw22's, :mod:`hw`), the synthesis
kernels theirs from :func:`_inv_tap_bound` and :func:`_inv_pack_geometry`,
and each refuses any other; the CPU tests replay both
(``tests/test_torch_pack3d_tiling.py``,
``tests/test_torch_ipack3d_tiling.py``).  The kernels take
level-1 filters of up to 31 taps and qshift filters of up to 32 (analysis)
and 34 (synthesis; the longest published family, qshift_32, has 32); past
that the card runs the entry's plain chain on the long-filter
kernel (:mod:`longfir`: a two-branch launch or a two-input sum a stage),
then the same packing.  On a CPU tensor each
entry runs its ``*_reference`` plain version: the dual forms of :mod:`fb`
along W, H and D, then :func:`packing.cube2c_planes` (or
:func:`packing.cube2c`) per octant, computed at float32 for bfloat16
storage.  Any other device raises.

The subbands are band-major planes ``(re, im)`` of ``[..., 28, D', H', W']``
in the storage dtype (``planes=True``) or one complex band-minor
``[..., D', H', W', 28]`` tensor.  The kernels take every shape the
transform makes (even extents; multiples of 4 at levels >= 2), float32,
bfloat16 (planes only) and float64, and odd-length level-1 filters; the
transform runs even-length level-1 filters as a separable tree on the dual
kernels.  Level >= 2 pairs follow the transform's call order ``(h0b, h0a)``
/ ``(h1b, h1a)`` (analysis) and ``(g0b, g0a)`` / ``(g1b, g1a)`` (synthesis).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from dtcwt_tpu_torch.ops import _build, dual, fb, longfir
from dtcwt_tpu_torch.ops.dual import _inv_taps, _table
from dtcwt_tpu_torch.ops.hwtile import _fwd_pack_geometry, _hw22_tap_bound
from dtcwt_tpu_torch.ops.ilevel2 import ifilt_streams
from dtcwt_tpu_torch.ops.level2 import dfilt_streams
from dtcwt_tpu_torch.ops.packing import (
    c2cube, c2cube_planes, cube2c, cube2c_planes)
from dtcwt_tpu_torch.utils import compute_view

__all__ = ["fwd_level1_pack", "inv_level1_pack", "fwd_level2_pack",
           "inv_level2_pack", "fwd_level1_pack_reference",
           "inv_level1_pack_reference", "fwd_level2_pack_reference",
           "inv_level2_pack_reference", "analysis_octants", "pack_octants",
           "unpack_octants", "synthesis"]

#: Octant order of the 28 highpass subbands of a 3-D level: ``(i, j, k)``
#: = branch (0 lowpass, 1 highpass) along (D, H, W); octant ``n`` holds
#: subbands ``4n .. 4n + 3``.
_OCTANTS = (
    (0, 1, 0),   # HLL
    (1, 0, 0),   # LHL
    (1, 1, 0),   # HHL
    (0, 0, 1),   # LLH
    (0, 1, 1),   # HLH
    (1, 0, 1),   # LHH
    (1, 1, 1),   # HHH
)

_TILE = 32                      # csrc/ipack.cuh IP_TILE
#: Output streams of each analysis kernel's stage plans (csrc/fpack.cu)
_FWD_P = {"fwd_level1_pack": 1, "fwd_level2_pack": 2}


# ---------------------------------------------------------------------------
# the separable tree and the (un)pack, shared by the plain versions and the
# transform's even-filter route
# ---------------------------------------------------------------------------

def analysis_octants(x: torch.Tensor, split):
    """The 8 octant volumes ``{(i, j, k): tensor}`` of one analysis level:
    *split(v, axis)* returns both branches of one stage (a dual form),
    applied along W, then H, then D."""
    octs = {}
    for k, v in enumerate(split(x, -1)):
        for j, vj in enumerate(split(v, -2)):
            octs[(0, j, k)], octs[(1, j, k)] = split(vj, -3)
    return octs


def pack_octants(octs, planes: bool, dtype=None):
    """The 7 highpass octants packed into one 28-band level: ``(re, im)``
    band-major planes cast to *dtype*, or the complex band-minor tensor.
    The seven octants go through one batched ``cube2c``, which keeps the
    host's operation count per level small."""
    y = torch.stack([octs[o] for o in _OCTANTS])    # [7, ..., 2P, 2Q, 2R]
    if planes:
        # [7, ..., 4, P, Q, R] -> [..., 28, P, Q, R]
        re, im = (a.movedim(0, -5).flatten(-5, -4)
                  for a in cube2c_planes(y))
        if dtype is not None:
            re, im = re.to(dtype), im.to(dtype)
        return re.contiguous(), im.contiguous()
    # [7, ..., P, Q, R, 4] -> [..., P, Q, R, 28]
    return cube2c(y).movedim(0, -2).flatten(-2).contiguous()


def unpack_octants(bands):
    """The 7 highpass octant volumes of a 28-band level given as ``(re,
    im)`` planes (computed at float32 for bfloat16) or as the complex
    band-minor tensor, through one batched ``c2cube``."""
    if isinstance(bands, tuple):
        # [..., 28, P, Q, R] -> [7, ..., 4, P, Q, R]
        re, im = (compute_view(a).unflatten(-4, (7, 4)).movedim(-5, 0)
                  for a in bands)
        y = c2cube_planes(re, im)
    else:
        # [..., P, Q, R, 28] -> [7, ..., P, Q, R, 4]
        y = c2cube(bands.unflatten(-1, (7, 4)).movedim(-2, 0))
    return dict(zip(_OCTANTS, y.unbind(0)))


def synthesis(octs, merge):
    """Separable synthesis of the 8 octant volumes: *merge(a, b, axis)* is
    one stage's branch merge (a dual sum form), applied along D, then H,
    then W."""
    V = {(j, k): merge(octs[(0, j, k)], octs[(1, j, k)], -3)
         for j in range(2) for k in range(2)}
    return merge(merge(V[(0, 0)], V[(1, 0)], -2),
                 merge(V[(0, 1)], V[(1, 1)], -2), -1)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _analysis(x: torch.Tensor, split, planes):
    """A plain version's analysis level: the octants of *split* (a dual
    form of :mod:`fb`, or on the card's long route of :mod:`longfir`),
    then the packing."""
    octs = analysis_octants(compute_view(x), split)
    return octs[(0, 0, 0)].to(x.dtype), pack_octants(octs, planes, x.dtype)


def _synthesis(lll: torch.Tensor, re, im, merge):
    """A plain version's synthesis level: the unpacking, then the octants
    merged by *merge* (as :func:`_analysis` takes *split*)."""
    octs = unpack_octants(_band_arg(re, im))
    octs[(0, 0, 0)] = compute_view(lll)
    return synthesis(octs, merge).to(lll.dtype)


def _filter2(ops, h0, h1):
    return lambda v, ax: ops.filter2_axis(v, h0, h1, ax)


def _dfilt2(ops, pair0, pair1):
    return lambda v, ax: ops.dfilt2_axis(v, pair0, pair1, ax)


def _filter2_sum(ops, g0, g1):
    return lambda a, b, ax: ops.filter2_sum_axis(a, b, g0, g1, ax)


def _ifilt2_sum(ops, pair0, pair1):
    return lambda a, b, ax: ops.ifilt2_sum_axis(a, b, pair0, pair1, ax)


def fwd_level1_pack_reference(x: torch.Tensor, h0o, h1o, planes=True):
    """Plain level-1 analysis of ``[..., D, H, W]``: ``(lll [..., D, H, W],
    subbands)``, the subbands ``(re, im) [..., 28, D/2, H/2, W/2]`` or
    complex ``[..., D/2, H/2, W/2, 28]``."""
    return _analysis(x, _filter2(fb, h0o, h1o), planes)


def fwd_level2_pack_reference(x: torch.Tensor, pair0, pair1, planes=True):
    """Plain qshift analysis of ``[..., D, H, W]`` (multiples of 4):
    ``(lll [..., D/2, H/2, W/2], subbands [..., 28, D/4, H/4, W/4])``."""
    return _analysis(x, _dfilt2(fb, pair0, pair1), planes)


def _band_arg(re, im):
    return re if im is None else (re, im)


def inv_level1_pack_reference(lll: torch.Tensor, re, im, g0o, g1o):
    """Plain level-1 synthesis: the lowpass ``[..., D, H, W]`` and the
    subbands, ``(re, im)`` planes ``[..., 28, D/2, H/2, W/2]`` or (with *im*
    None) the complex band-minor *re*, back to ``[..., D, H, W]``."""
    return _synthesis(lll, re, im, _filter2_sum(fb, g0o, g1o))


def inv_level2_pack_reference(lll: torch.Tensor, re, im, pair0, pair1):
    """Plain qshift synthesis: ``[..., D, H, W]`` and subbands
    ``[..., 28, D/2, H/2, W/2]`` back to the uncropped
    ``[..., 2D, 2H, 2W]``."""
    return _synthesis(lll, re, im, _ifilt2_sum(fb, pair0, pair1))


# ---------------------------------------------------------------------------
# checks, host plans and the launch
# ---------------------------------------------------------------------------

def _volume(x: torch.Tensor, name: str, mult: int):
    if x.ndim < 3:
        raise ValueError("%s needs a [..., D, H, W] volume, got %s"
                         % (name, tuple(x.shape)))
    D, H, W = x.shape[-3:]
    if D % mult or H % mult or W % mult or min(D, H, W) < mult:
        raise ValueError("%s needs D, H, W multiples of %d, got %s"
                         % (name, mult, tuple(x.shape)))
    return D, H, W


def _storage(x: torch.Tensor, planes: bool) -> None:
    if x.dtype == torch.bfloat16 and not planes:
        raise TypeError("bfloat16 subbands exist only in the plane layout")


def _odd(h0, h1, name: str):
    """The lengths of two level-1 filters, which must be odd (on both
    devices: their tap bound is the card route's,
    :func:`_build.within_bound`)."""
    lens = [fb._as_taps(h).size for h in (h0, h1)]
    if any(m % 2 == 0 for m in lens):
        raise ValueError("%s takes odd-length level-1 filters, got %d and %d "
                         "taps" % (name, *lens))
    return lens


def _check_bands(lll: torch.Tensor, re, im, name: str):
    """Check the subbands against the lowpass ``[..., D, H, W]``; return
    ``(band_a, band_b, planes)`` for the kernel."""
    lead, (D, H, W) = tuple(lll.shape[:-3]), tuple(lll.shape[-3:])
    sub = (D // 2, H // 2, W // 2)
    if im is not None:
        want = lead + (28,) + sub
        for a in (re, im):
            if tuple(a.shape) != want or a.dtype != lll.dtype:
                raise ValueError("%s: subband planes must be %s %s, got %s %s"
                                 % (name, want, lll.dtype, tuple(a.shape),
                                    a.dtype))
        return re, im, True
    want = lead + sub + (28,)
    ctype = {torch.float32: torch.complex64,
             torch.float64: torch.complex128}.get(lll.dtype)
    if tuple(re.shape) != want or re.dtype != ctype:
        raise ValueError("%s: subbands must be %s %s, got %s %s"
                         % (name, want, ctype, tuple(re.shape), re.dtype))
    return re, None, False


#: Tap bounds of the synthesis kernel's instances by streams a stage (1:
#: level 1, 4: level 2), float32 / bfloat16 and float64 (csrc/ipack.cuh
#: ip_bound)
_INV_BOUNDS = {1: ((9, 21, 33), (33,)), 4: ((5, 7, 9, 17), (17,))}
#: Output streams of each synthesis kernel's stage plans (csrc/pack3d.cu)
_INV_P = {"inv_level1_pack": 1, "inv_level2_pack": 4}


def _inv_tap_bound(plans, P: int, dtype: torch.dtype) -> int:
    """The least tap bound of the synthesis kernel's instances that holds
    the plans: level 1 9 (near_sym_a, antonini, legall), 21 (near_sym_b)
    or 33; level 2 5 (qshift_a), 7 (qshift_b), 9 (qshift_c, qshift_d) or
    17 (qshift_32); float64 only the largest."""
    for mt in _INV_BOUNDS[P][dtype == torch.float64]:
        if _inv_taps(plans, P, mt) is not None:
            return mt
    raise ValueError("the 3-D synthesis kernel's largest tap bound, %d, "
                     "does not hold these filters"
                     % _INV_BOUNDS[P][0][-1])


class InvPackGeometry(NamedTuple):
    """The tile of a synthesis kernel (csrc/pack3d.cu InvTile,
    csrc/ipack.cuh IpGeo): oh x ow output samples of each of the four
    outputs (U_i at depth parity c), 256 threads a block on the grid (B,
    Dn / 2, tile rows, tile columns); the tap bound mt and its halo ph; the
    staged area xr x xc (square) from sample (rs, cs) of the level's input
    (level 1: the tile's first row and column less ph; level 2: half of
    them less 2 ph), xh the parity half of a level-2 staged row (0 at level
    1) and xs the staged row stride; smem the dynamic shared memory bytes
    (four staged images [xr][xs], the W stage's two [xr][ow], the int row
    and column maps); vq: the interleaved subbands read as 16-byte pieces."""
    oh: int
    ow: int
    mt: int
    ph: int
    xr: int
    xc: int
    xh: int
    xs: int
    smem: int
    grid: Tuple[int, int, int, int]
    vq: bool


@functools.lru_cache(maxsize=None)
def _inv_pack_geometry(B: int, Dn: int, Ho: int, Wo: int, P: int, mt: int,
                       dtype: torch.dtype, planes: bool,
                       band_ptr: int = 0) -> InvPackGeometry:
    """The tile of a synthesis kernel with *P* streams a stage (1: level 1,
    4: level 2) and tap bound *mt* (:func:`_inv_tap_bound`) writing ``[B,
    Dn, Ho, Wo]`` twice, for *dtype*'s subbands in the plane or
    interleaved layout at address *band_ptr* (modulo 16: a pyramid may
    hold them at a storage offset, and the 16-byte loads need 16).  The
    tile is 32 x 32 output samples: with the largest tap bound in float64
    its shared memory (164 KB at level 1) still fits, and at the main
    path's bounds in float32 (36 KB at level 1, 16 KB at level 2) the
    registers, not the shared memory, set an SM's blocks.  Cached: a
    transform asks for the same tile at every call."""
    acc = 8 if dtype == torch.float64 else 4
    oh = ow = _TILE
    ph = (mt - 1) // 2
    if P == 1:
        xr, xh = oh + mt - 1, 0
        xs = xr
    else:
        xr = oh // 2 + 2 * mt - 2
        xh = (xr // 2 + 3) // 8 * 8 + 4
        xs = 2 * xh
    smem = acc * (4 * xr * xs + 2 * xr * ow) + 4 * 2 * xr
    return InvPackGeometry(oh, ow, mt, ph, xr, xr, xh, xs, smem,
                           (B, Dn // 2, -(-Ho // oh), -(-Wo // ow)),
                           not planes and band_ptr % 16 == 0)


def _fwd_outputs(B, Dn, Ho, Wo, dtype, planes, dev):
    """The analysis kernel's outputs: (lll [B, Dn, Ho, Wo], re, im) planes
    [B, 28, Dn/2, Ho/2, Wo/2] of *dtype*, or (lll, the complex band-minor
    [B, Dn/2, Ho/2, Wo/2, 28], None)."""
    lll = torch.empty((B, Dn, Ho, Wo), dtype=dtype, device=dev)
    sub = (Dn // 2, Ho // 2, Wo // 2)
    if planes:
        ra = torch.empty((B, 28) + sub, dtype=dtype, device=dev)
        return lll, ra, torch.empty_like(ra)
    ctype = torch.complex128 if dtype == torch.float64 else torch.complex64
    return lll, torch.empty((B,) + sub + (28,), dtype=ctype,
                            device=dev), None


def _inv_outputs(B, Dn, Ho, Wo, dtype, dev):
    """The synthesis kernel's outputs: (U_0, U_1 [B, Dn, Ho, Wo] of the
    compute *dtype*, None)."""
    return (torch.empty((B, Dn, Ho, Wo), dtype=dtype, device=dev),
            torch.empty((B, Dn, Ho, Wo), dtype=dtype, device=dev), None)


def _launch(name, x, bands, plans, out_dtype, planes, Ho, Wo, fwd):
    """Run kernel *name*.  Analysis: *x* is the pair (lo, hi) of branch
    volumes [B, Dn, H, W]; returns (lll, band_a, band_b).  Synthesis: *x*
    is (lll,) and *bands* the (band_a, band_b) inputs; returns (U_0, U_1)."""
    _build.check_no_grad(name, x, bands)
    src = x[0]
    B, Dn, H, W = src.shape
    dev = src.device
    for t in list(x) + [a for a in bands if a is not None]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("%s needs contiguous inputs on %s" % (name, dev))
    code = _build.dtype_code(out_dtype if fwd else src.dtype)
    acc = torch.float64 if code == 2 else torch.float32
    if fwd:
        outs = _fwd_outputs(B, Dn, Ho, Wo, out_dtype, planes, dev)
        ins = (x[0], x[1], None, None)
    else:
        outs = _inv_outputs(B, Dn, Ho, Wo, acc, dev)
        ins = (x[0], None) + tuple(bands)
    ptr = lambda t: None if t is None else (
        torch.view_as_real(t) if t.is_complex() else t).data_ptr()
    taps, lens, offs = _table(plans)
    if fwd:
        P = _FWD_P[name]
        tile = _fwd_pack_geometry(P, _hw22_tap_bound(plans, P), out_dtype,
                                  bool(planes)).tile()
    else:
        P = _INV_P[name]
        geo = _inv_pack_geometry(
            B, Dn, Ho, Wo, P, _inv_tap_bound(plans, P, src.dtype), src.dtype,
            bool(planes), ptr(bands[0]) % 16)
        tile = (geo.oh, geo.ow, geo.mt, geo.xr, geo.xc, geo.smem,
                int(geo.vq))
    fn = getattr(_build.library(), "dtcwt_" + name)
    err = fn(*(ptr(t) for t in ins), *(ptr(t) for t in outs), B, Dn, H, W,
             Ho, Wo, taps.ctypes.data, lens.ctypes.data, offs.ctypes.data,
             code, int(planes), *tile, _build.stream_ptr(dev))
    _build.check(name, err)
    _build.count(name)
    return outs


def _fwd(name, x, depth_split, plans, planes, Ho, Wo):
    """Depth stage on the dual kernels, then the pack kernel; the outputs
    reshaped to x's leading axes."""
    lead = tuple(x.shape[:-3])
    x4 = compute_view(x).reshape((-1,) + tuple(x.shape[-3:])).contiguous()
    lo, hi = depth_split(x4)
    lll, ba, bb = _launch(name, (lo, hi), (), plans, x.dtype, planes, Ho, Wo,
                          True)
    lll = lll.reshape(lead + lll.shape[1:])
    if planes:
        return lll, (ba.reshape(lead + ba.shape[1:]),
                     bb.reshape(lead + bb.shape[1:]))
    return lll, ba.reshape(lead + ba.shape[1:])


def _inv(name, lll, re, im, plans, depth_merge, Ho, Wo):
    """The unpack kernel, then the depth stage on the dual kernels."""
    ba, bb, planes = _check_bands(lll, re, im, name)
    lead = tuple(lll.shape[:-3])
    l4 = lll.reshape((-1,) + tuple(lll.shape[-3:])).contiguous()
    flat = lambda a: None if a is None else a.reshape(
        (l4.shape[0],) + tuple(a.shape[len(lead):])).contiguous()
    ulo, uhi = _launch(name, (l4,), (flat(ba), flat(bb)), plans, None,
                       planes, Ho, Wo, False)[:2]
    y = depth_merge(ulo, uhi).to(lll.dtype)
    return y.reshape(lead + y.shape[1:])


def _filter_plans(h0, h1):
    return [dual._filter_plan(h0), dual._filter_plan(h1)]


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------

def fwd_level1_pack(x: torch.Tensor, h0o, h1o, planes: bool = True):
    """Level-1 analysis with odd-length biort filters; see
    :func:`fwd_level1_pack_reference`.  D, H, W even."""
    D, H, W = _volume(x, "fwd_level1_pack", 2)
    lens = _odd(h0o, h1o, "fwd_level1_pack")
    _storage(x, planes)
    if _build.on_cpu(x, "fwd_level1_pack"):
        return fwd_level1_pack_reference(x, h0o, h1o, planes)
    if not _build.within_bound("fwd_level1_pack", lens):
        return _analysis(x, _filter2(longfir, h0o, h1o), planes)
    return _fwd("fwd_level1_pack", x,
                lambda v: dual.filter2_axis(v, h0o, h1o, -3),
                _filter_plans(h0o, h1o), planes, H, W)


def fwd_level2_pack(x: torch.Tensor, pair0, pair1, planes: bool = True):
    """Qshift analysis; see :func:`fwd_level2_pack_reference`.  D, H, W
    multiples of 4."""
    D, H, W = _volume(x, "fwd_level2_pack", 4)
    pairs = dual._pairs(pair0, pair1)
    _storage(x, planes)
    if _build.on_cpu(x, "fwd_level2_pack"):
        return fwd_level2_pack_reference(x, pair0, pair1, planes)
    if not _build.within_bound("fwd_level2_pack", [p[0].size for p in pairs]):
        return _analysis(x, _dfilt2(longfir, pair0, pair1), planes)
    return _fwd("fwd_level2_pack", x,
                lambda v: dual.dfilt2_axis(v, pair0, pair1, -3),
                [dfilt_streams(*p) for p in pairs], planes, H // 2, W // 2)


def inv_level1_pack(lll: torch.Tensor, re, im, g0o, g1o):
    """Level-1 synthesis with odd-length biort filters; see
    :func:`inv_level1_pack_reference`."""
    D, H, W = _volume(lll, "inv_level1_pack", 2)
    lens = _odd(g0o, g1o, "inv_level1_pack")
    _check_bands(lll, re, im, "inv_level1_pack")
    if _build.on_cpu(lll, "inv_level1_pack"):
        return inv_level1_pack_reference(lll, re, im, g0o, g1o)
    if not _build.within_bound("inv_level1_pack", lens):
        return _synthesis(lll, re, im, _filter2_sum(longfir, g0o, g1o))
    return _inv("inv_level1_pack", lll, re, im, _filter_plans(g0o, g1o),
                lambda a, b: dual.filter2_sum_axis(a, b, g0o, g1o, -3), H, W)


def inv_level2_pack(lll: torch.Tensor, re, im, pair0, pair1):
    """Qshift synthesis; see :func:`inv_level2_pack_reference`."""
    D, H, W = _volume(lll, "inv_level2_pack", 2)
    pairs = dual._pairs(pair0, pair1)
    _check_bands(lll, re, im, "inv_level2_pack")
    if _build.on_cpu(lll, "inv_level2_pack"):
        return inv_level2_pack_reference(lll, re, im, pair0, pair1)
    if not _build.within_bound("inv_level2_pack", [p[0].size for p in pairs]):
        return _synthesis(lll, re, im, _ifilt2_sum(longfir, pair0, pair1))
    return _inv("inv_level2_pack", lll, re, im,
                [ifilt_streams(*p) for p in pairs],
                lambda a, b: dual.ifilt2_sum_axis(a, b, pair0, pair1, -3),
                2 * H, 2 * W)
