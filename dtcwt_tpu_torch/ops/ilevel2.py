"""One qshift (level >= 2) inverse level of the 2-D DTCWT: one CUDA kernel
and its plain version.

Replaces the Pallas kernel ``dtcwt_tpu/ops/pallas_ilevel2.py:inv_level2``.
What bounds it on the H100, and what the design does about it, is in the
kernel's source, ``csrc/ilevel2.cu``: a memory-bound stencil whose blocks
each take 8 (or 4) band rows by 32 band columns (output tiles of 4x
those), build the tile's quad images once per quad in shared memory,
filter their columns from register windows into column images split by
column parity and their rows from 16-byte shared windows, and store in
vectors; no quad image reaches device memory.  :func:`_ilevel2_geometry`
chooses the tiling (band rows a tile, the compile-time tap bound, the quad
loads) and the kernel refuses any other; the CPU tests replay it
(``tests/test_torch_ilevel2_tiling.py``).

:func:`inv_level2` takes its route from the input's device: a CPU tensor
runs :func:`inv_level2_reference`, a CUDA tensor launches the kernel or
raises.  The subbands come either as the interleaved complex
``[..., H/2, W/2, 6]`` tensor or as the plane pair ``(re, im)`` of
``[..., 6, H/2, W/2]`` tensors in PLANE_BAND_ORDER.  Filter arguments follow
the transform's call order ``ifilt(x, g0b, g0a)`` / ``ifilt(x, g1b, g1a)``.
The bandpass families' third pair *g2a*/*g2b* is the kernel's third stream:
the ``hh`` quad image gets ``ifilt(., g2b, g2a)`` on both axes instead of
sharing the second column stage, planned on the host as the main pairs
are; all six filters must share one even length, which sets the tile's
halo.  The kernel takes filters of up to 32 taps; past that the card runs
the plain version's chain on the long-filter kernel
(:mod:`longfir`: three two-input interpolating launches).  The output is
uncropped: the transform crops.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from dtcwt_tpu_torch.ops import _build, fb, longfir
from dtcwt_tpu_torch.ops.fb import ifilt_streams
from dtcwt_tpu_torch.ops.packing import c2q, c2q_planes
from dtcwt_tpu_torch.transforms.pyramid import _PLANE_POS
from dtcwt_tpu_torch.utils import compute_view

__all__ = ["inv_level2", "inv_level2_reference", "ifilt_streams"]


def _quads(yh=None, bands=None):
    """The three c2q quad images (lh, hl, hh) of one level, at the compute
    precision: band pairs (0, 5), (2, 3), (1, 4)."""
    if bands is not None:
        re, im = (compute_view(a) for a in bands)
        bp = lambda d: (re[..., _PLANE_POS[d], :, :],
                        im[..., _PLANE_POS[d], :, :])
        return (c2q_planes(bp(0), bp(5)), c2q_planes(bp(2), bp(3)),
                c2q_planes(bp(1), bp(4)))
    return (c2q(yh[..., 0], yh[..., 5]), c2q(yh[..., 2], yh[..., 3]),
            c2q(yh[..., 1], yh[..., 4]))


def inv_level2_reference(z: torch.Tensor, yh=None, g0a=None, g0b=None,
                         g1a=None, g1b=None, bands=None, g2a=None, g2b=None):
    """Plain PyTorch qshift inverse level: lowpass ``[..., H, W]`` plus the
    level's subbands -> ``[..., 2H, 2W]`` in the lowpass's dtype.
    *g2a*/*g2b* are the bandpass families' third synthesis pair."""
    return _inverse(z, yh, g0a, g0b, g1a, g1b, bands, g2a, g2b, fb)


def _inverse(z, yh, g0a, g0b, g1a, g1b, bands, g2a, g2b, ops):
    """:func:`inv_level2_reference`'s chain with the filters of *ops*:
    :mod:`fb`, or on the card's long route :mod:`longfir`."""
    lh, hl, hh = _quads(yh, bands)
    p0, p1 = (g0b, g0a), (g1b, g1a)
    y1 = ops.ifilt2_sum_axis(compute_view(z), lh, p0, p1, -2)
    if g2b is not None:
        y2 = ops.ifilt_axis(hl, g0b, g0a, -2)
        y2bp = ops.ifilt_axis(hh, g2b, g2a, -2)
        out = (ops.ifilt2_sum_axis(y1, y2, p0, p1, -1)
               + ops.ifilt_axis(y2bp, g2b, g2a, -1))
    else:
        y2 = ops.ifilt2_sum_axis(hl, hh, p0, p1, -2)
        out = ops.ifilt2_sum_axis(y1, y2, p0, p1, -1)
    return out.to(z.dtype)


def _band_args(z: torch.Tensor, yh, bands, name: str):
    """Check the subbands against the lowpass; return the kernel's two band
    pointers' tensors and the planes flag."""
    H, W = z.shape[-2:]
    if bands is not None:
        re, im = bands
        want = tuple(z.shape[:-2]) + (6, H // 2, W // 2)
        for a in (re, im):
            if tuple(a.shape) != want or a.dtype != z.dtype:
                raise ValueError("%s: band planes must be %s %s, got %s %s" % (
                    name, want, z.dtype, tuple(a.shape), a.dtype))
            if not a.is_contiguous() or a.device != z.device:
                raise ValueError("%s: band planes must be contiguous on %s"
                                 % (name, z.device))
        return re, im, 1
    want = tuple(z.shape[:-2]) + (H // 2, W // 2, 6)
    ctype = {torch.float32: torch.complex64,
             torch.float64: torch.complex128}.get(z.dtype)
    if tuple(yh.shape) != want or yh.dtype != ctype:
        raise ValueError("%s: subbands must be %s %s, got %s %s" % (
            name, want, ctype, tuple(yh.shape), yh.dtype))
    if not yh.is_contiguous() or yh.device != z.device:
        raise ValueError("%s: subbands must be contiguous on %s"
                         % (name, z.device))
    return torch.view_as_real(yh), None, 0


_THREADS = 256        # csrc/ilevel2.cu I2_THREADS
_TQ = 32              # I2_TQ: band columns a tile
_V = 4                # I2_V: band columns a row-stage item
_SMS = 132            # streaming multiprocessors of an H100
_SM_SMEM = 233472     # shared memory of an SM; 1 KB of it reserved a block


class Ilevel2Geometry(NamedTuple):
    """The tiling of one ``inv_level2`` launch (``csrc/ilevel2.cu``).

    Block ``(bx, by, b)`` of ``grid`` owns band rows ``[by * qh, by * qh +
    qh)`` and band columns ``[bx * tq, bx * tq + tq)`` of image ``b``
    (output rows and columns 4x those), with 256 threads.  Staging: item
    ``it`` (``< (qh + mt - 1) * xq``, threads taking ``it = tid, tid + 256,
    ...``) is staged quad ``(it // xq, it % xq)``, the quad of band row
    ``by * qh - h2 + it // xq`` and band column ``bx * tq - h2 + it %
    xq``, reflected onto its source quad; it writes the quad's 2 x 2
    pixels of lh, hl and hh (rows or columns swapped where the reflection
    is odd) to shared ``[3][2 (qh + mt - 1)][2 xq]``.  Column stage: item
    ``it`` (``< qh // g * 2 xq``) is staged column ``lc = it % (2 xq)``
    (pixel column ``2 (bx * tq - h2) + lc``) by the tile's band rows ``(it
    // (2 xq)) * g ..`` + g - 1; it loads two parity windows of ``g + mt
    - 1`` rows of each source image (the lowpass from device memory) and
    writes y1, y2 (and y3) to shared ``[streams][4 qh][2][xh]``, output
    row ``4 v + s``, column ``lc`` at parity ``lc % 2``, index ``lc //
    2``.  Row stage: item ``it`` (``< 32 qh``) is tile output row ``it //
    8`` (a warp: one band row) by band columns ``4 (it % 8) ..`` + 3; it
    reads two parity windows of ``mt + 3`` samples (``nw`` loaded, as
    16-byte vectors) of each column image and puts its 16 samples in the
    warp's ``[4][32][4]`` staging space (band column ``4 g + q`` at slot
    ``q ^ (g // 2 % 4)``, in the quad images' space), from which lane ``l``
    stores band column ``bx * tq + l`` of the warp's 4 rows as one 4-sample
    vector each.  *m2*: taps of a stream; *h2*: ``m2 //
    2``, the staged halo in band positions before the tile; *mt*: the tap
    loops' compile-time bound (>= 2 h2 + 1); *smem*: dynamic shared
    memory bytes a block; *vq*: the interleaved subbands read as 16-byte
    pieces."""
    qh: int
    tq: int
    g: int
    m2: int
    h2: int
    mt: int
    xq: int
    xh: int
    nw: int
    smem: int
    grid: Tuple[int, int, int]
    vq: bool


def _tap_bound(r: int, dtype: torch.dtype, streams: int) -> int:
    """csrc/ilevel2.cu i2_tap_bound for a reach of *r* = 2 h2 + 1 taps: 5
    (qshift_a's), 7 (qshift_b's), 9 (qshift_c's and qshift_d's) or 17; the
    third stream 7 (qshift_b_bp's) or 17; float64 (for tests) 17."""
    if dtype == torch.float64:
        return 17
    bounds = (7, 17) if streams == 3 else (5, 7, 9, 17)
    return next(t for t in bounds if r <= t)


def _half(n: int) -> int:
    """csrc/l2tile.cuh l2_half: a parity half of at least *n* values, 16
    (mod 32) wide."""
    return (n + 15) // 32 * 32 + 16


@functools.lru_cache(maxsize=256)
def _ilevel2_geometry(B: int, H: int, W: int, m: int, dtype: torch.dtype,
                      planes: bool, streams: int = 2, band_ptr: int = 0,
                      qh: int = None) -> Ilevel2Geometry:
    """The tiling of ``inv_level2`` on the lowpass ``[B, H, W]`` with
    filters of *m* taps, *streams* column images (3 with the bandpass third
    stream), for *dtype* in the plane or interleaved layout, in tiles of
    *qh* band rows (4 or 8; by default 8, the fastest on the main path's
    shapes, where that leaves an H100 two blocks an SM by shared memory
    and a block for each of its 132 SMs, else 4).  *band_ptr* is the
    address of the subbands (interleaved: as
    real pairs) modulo 16: the caller's pyramid may hold them at a storage
    offset, so the 16-byte quad loads depend on it.  Cached: the wrapper
    asks for the same tiling at every call of a transform."""
    acc = 8 if dtype == torch.float64 else 4
    m2 = m // 2
    h2 = m2 // 2
    mt = _tap_bound(2 * h2 + 1, dtype, streams)
    xq = _TQ + mt - 1
    vn = 16 // acc
    nw = -(-(mt + 3) // vn) * vn
    xh = _half(max(xq, _TQ - _V + nw))
    h, w = H // 2, W // 2

    def smem_of(rows):
        return acc * (3 * 2 * (rows + mt - 1) * 2 * xq
                      + streams * 4 * rows * 2 * xh)
    if qh is None:
        qh = 8 if (2 * (smem_of(8) + 1024) <= _SM_SMEM
                   and -(-w // _TQ) * -(-h // 8) * B >= _SMS) else 4
    return Ilevel2Geometry(
        qh, _TQ, 2 if dtype == torch.float64 else 4, m2, h2, mt, xq, xh, nw,
        smem_of(qh), (-(-w // _TQ), -(-h // qh), B),
        not planes and band_ptr % 16 == 0)


class _Plan(NamedTuple):
    """A filter set's kernel arguments: the streams' taps and offsets as
    host arrays (kept alive here across launches) and their addresses."""
    m: int
    streams: int
    arrays: tuple
    taps: int
    offs: int
    taps2: int
    offs2: int


_PLANS = {}


def _plan(g0b, g0a, g1b, g1a, g2b, g2a) -> _Plan:
    """The kernel arguments of a filter set, planned once per filter set
    (keyed by the filters' values) and cached."""
    f = [None if v is None else np.asarray(v, np.float64)
         for v in (g0b, g0a, g1b, g1a, g2b, g2a)]
    key = tuple(None if v is None else v.tobytes() for v in f)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    f = _build.pair_filters("inv_level2", *f)
    t0, o0 = ifilt_streams(f[0], f[1])
    t1, o1 = ifilt_streams(f[2], f[3])
    taps, offs = _build.taps_arg(t0, t1), _build.ints_arg(o0 + o1)
    taps2 = offs2 = None
    if f[4] is not None:
        t2, o2 = ifilt_streams(f[4], f[5])
        taps2, offs2 = _build.taps_arg(t2), _build.ints_arg(o2)
    plan = _Plan(f[0].size, 2 if taps2 is None else 3,
                 (taps, offs, taps2, offs2), taps.ctypes.data,
                 offs.ctypes.data, _build.ptr(taps2), _build.ptr(offs2))
    if len(_PLANS) >= 64:
        _PLANS.clear()
    _PLANS[key] = plan
    return plan


def inv_level2(z: torch.Tensor, yh=None, g0a=None, g0b=None, g1a=None,
               g1b=None, bands=None, g2a=None, g2b=None):
    """Qshift inverse level; see :func:`inv_level2_reference`."""
    if _build.on_cpu(z, "inv_level2"):
        return inv_level2_reference(z, yh, g0a, g0b, g1a, g1b, bands, g2a,
                                    g2b)
    _build.check_no_grad("inv_level2", z, yh, bands)
    if (g2a is None) != (g2b is None):
        raise ValueError("inv_level2 takes the third pair g2a, g2b together")
    if z.ndim < 2 or z.shape[-2] % 2 or z.shape[-1] % 2:
        raise ValueError("inv_level2 needs [..., H, W] with H, W even, got "
                         "%s" % (tuple(z.shape),))
    if not z.is_contiguous():
        raise ValueError("inv_level2 needs a contiguous lowpass")
    plan = _plan(g0b, g0a, g1b, g1a, g2b, g2a)
    code = _build.dtype_code(z.dtype)
    band_a, band_b, planes = _band_args(z, yh, bands, "inv_level2")
    if not _build.within_bound("inv_level2", [plan.m]):
        return _inverse(z, yh, g0a, g0b, g1a, g1b, bands, g2a, g2b,
                        longfir)
    z3, lead = _build.flatten_batch(z)
    B, H, W = z3.shape
    geo = _ilevel2_geometry(B, H, W, plan.m, z.dtype, bool(planes),
                            plan.streams, band_a.data_ptr() % 16)
    _build.check_smem_bytes("inv_level2", geo.smem)
    out = torch.empty((B, 2 * H, 2 * W), dtype=z.dtype, device=z.device)
    lib = _build.library()
    err = lib.dtcwt_ilevel2(
        z3.data_ptr(), band_a.data_ptr(),
        None if band_b is None else band_b.data_ptr(), out.data_ptr(),
        B, H, W, plan.taps, plan.offs, plan.taps2, plan.offs2, geo.m2, code,
        planes, geo.qh, geo.mt, int(geo.vq), _build.stream_ptr(z.device))
    _build.check("inv_level2", err)
    _build.count("ilevel2")
    return out.reshape(lead + out.shape[1:])
