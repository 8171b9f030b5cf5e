"""One qshift (level >= 2) forward level of the 2-D DTCWT: one CUDA kernel
and its plain version.

Replaces the Pallas kernel ``dtcwt_tpu/ops/pallas_level2.py:fwd_level2``.
What bounds it on the H100, and what the design does about it, is in the
kernel's source, ``csrc/level2.cu``: a memory-bound stencil whose blocks
each take 4, 8 or 16 quad rows by 64 quads, filter their columns from
register windows into shared column images split by column parity and
their rows from 16-byte shared windows, and store in vectors; no
intermediate image reaches device memory.  :func:`_level2_geometry`
chooses the tiling (quad rows a tile, the compile-time tap bound, the
store vectors) and the kernel refuses any other; the CPU tests replay it
(``tests/test_torch_level2_tiling.py``).

:func:`fwd_level2` takes its route from the input's device: a CPU tensor
runs :func:`fwd_level2_reference`, a CUDA tensor launches the kernel or
raises.  Filter arguments follow the transform's call order: the level
applies ``dfilt(x, h0b, h0a)`` and ``dfilt(x, h1b, h1a)``, so branch *a* of
the decimator runs the *b* filter.  The bandpass families' third pair
*h2a*/*h2b* is the kernel's third stream (bands 1 and 4 from
``dfilt(., h2b, h2a)`` on both axes), planned on the host as the main pairs
are; all six filters must share one even length, which sets the tile's
halo.  The kernel takes filters of up to 32 taps; past that the card runs
the plain version's chain on the long-filter kernel
(:mod:`longfir`: a two-branch decimating launch down the columns, two
along the rows).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dtcwt_tpu_torch.ops import _build, fb, longfir
from dtcwt_tpu_torch.ops.fb import dfilt_streams
from dtcwt_tpu_torch.ops.level1 import _pack
from dtcwt_tpu_torch.utils import compute_view

__all__ = ["fwd_level2", "fwd_level2_reference", "dfilt_streams"]


def fwd_level2_reference(x: torch.Tensor, h0a, h0b, h1a, h1b,
                         planes: bool = False, h2a=None, h2b=None):
    """Plain PyTorch qshift forward level of ``[..., R, C]`` (R, C multiples
    of 4): ``(lolo [..., R/2, C/2], subbands)``, the subbands complex
    ``[..., R/4, C/4, 6]`` or ``(re, im)`` planes ``[..., 6, R/4, C/4]``.
    *h2a*/*h2b* are the bandpass families' third filter pair."""
    return _forward(x, h0a, h0b, h1a, h1b, planes, h2a, h2b, fb)


def _forward(x, h0a, h0b, h1a, h1b, planes, h2a, h2b, ops):
    """:func:`fwd_level2_reference`'s chain with the filters of *ops*:
    :mod:`fb`, or on the card's long route :mod:`longfir`."""
    X = compute_view(x)
    p0, p1 = (h0b, h0a), (h1b, h1a)
    lo, hi = ops.dfilt2_axis(X, p0, p1, -2)
    lolo, im23 = ops.dfilt2_axis(lo, p0, p1, -1)
    if h2b is not None:
        im05 = ops.dfilt_axis(hi, h0b, h0a, -1)
        im14 = ops.dfilt_axis(ops.dfilt_axis(X, h2b, h2a, -2), h2b, h2a, -1)
    else:
        im05, im14 = ops.dfilt2_axis(hi, p0, p1, -1)
    return lolo.to(x.dtype), _pack(im05, im23, im14, planes, x.dtype)


_THREADS = 256        # csrc/l2tile.cuh L2_THREADS
_TQ = 64              # L2_TQ: quads a tile row
_TW = 4 * _TQ         # L2_TW: input columns a tile row
_SMS = 132            # streaming multiprocessors of an H100
_SM_SMEM = 233472     # shared memory of an SM; 1 KB of it reserved a block


class Level2Geometry(NamedTuple):
    """The tiling of one ``fwd_level2`` launch (``csrc/level2.cu``).

    Block ``(bx, by, b)`` of ``grid`` owns quad rows ``[by * qh, by * qh +
    qh)`` and quads ``[bx * tq, bx * tq + tq)`` of image ``b`` (input rows
    and columns 4x those).  Column stage: item ``it`` (``it < qh // g *
    xw``, threads taking ``it = tid, tid + threads, ...``) is staged column
    ``lc = it % xw`` (input column ``4 bx tq + 2 - m + lc``, reflected) by
    the tile's quad rows ``(it // xw) * g ..`` + g - 1; it writes both
    branches of each pair to shared ``[pairs][2 qh][2][xh]``, row ``2 i +
    s`` of the decimated image, column ``lc`` at parity ``lc % 2``, index
    ``lc // 2``.  Row stage: item ``it`` (``< qh * 32``) is quad row ``it
    // 32`` (one warp) by quads ``2 (it % 32)`` and ``+ 1`` of the tile;
    in the interleaved layout the warp stages its 64 quads in shared
    memory and stores them as 16-byte pieces.  *m*: taps of every filter;
    *mt*: the tap loops' compile-time bound (>= m); *xw*: staged columns;
    *xh*: the width of a staged row's parity half; *smem*: dynamic shared
    memory bytes a block; *vlo*: 4-wide lowpass stores; *vpl*: 2-wide
    plane stores."""
    qh: int
    tq: int
    g: int
    m: int
    mt: int
    xw: int
    xh: int
    smem: int
    grid: Tuple[int, int, int]
    vlo: bool
    vpl: bool


def _tap_bound(m: int, dtype: torch.dtype, streams: int) -> int:
    """csrc/l2tile.cuh l2_tap_bound: 10 (qshift_a's length), 14 (qshift_b's
    and qshift_b_bp's), 16, 24 or 32 taps; 14, 16 or 32 with the third
    stream; float64 (for tests) 32."""
    if dtype == torch.float64:
        return 32
    if m <= 10 and streams == 2:
        return 10
    for t in (14, 16):
        if m <= t:
            return t
    return 32 if streams == 3 or m > 24 else 24


def _xh(m: int) -> int:
    """csrc/l2tile.cuh l2_xh: a staged row's parity half holds its 128 + m
    values, and is 16 (mod 32) wide."""
    return (128 + m + 15) // 32 * 32 + 16


def _level2_geometry(B: int, R: int, C: int, m: int, dtype: torch.dtype,
                     planes: bool, streams: int = 2,
                     qh: Optional[int] = None) -> Level2Geometry:
    """The tiling of ``fwd_level2`` on ``[B, R, C]`` with filters of *m*
    taps, *streams* column images (3 with the bandpass third stream), for
    outputs of *dtype* in the plane or interleaved layout, in tiles of *qh*
    quad rows (4, 8 or 16; by default the tallest that leaves an H100 two
    blocks an SM by shared memory and a block for each of its 132 SMs,
    else 4: on the main path's shapes, 16 where it fits, the fastest).
    Outputs are fresh allocations, so 16-byte aligned: the vectors depend
    on the row and plane widths alone."""
    acc = 8 if dtype == torch.float64 else 4
    h, w = R // 4, C // 4
    xh = _xh(m)

    def smem_of(rows):
        return acc * (streams * 2 * rows * 2 * xh
                      + (0 if planes else _THREADS * 24))
    if qh is None:
        qh = next((q for q in (16, 8) if 2 * (smem_of(q) + 1024) <=
                   _SM_SMEM and -(-w // _TQ) * -(-h // q) * B >= _SMS), 4)
    smem = smem_of(qh)
    return Level2Geometry(
        qh, _TQ, 2 if dtype == torch.float64 else 4, m,
        _tap_bound(m, dtype, streams), _TW + 2 * m, xh, smem,
        (-(-w // _TQ), -(-h // qh), B), (C // 2) % 4 == 0,
        bool(planes) and w % 2 == 0)


def fwd_level2(x: torch.Tensor, h0a, h0b, h1a, h1b, planes: bool = False,
               h2a=None, h2b=None):
    """Qshift forward level; see :func:`fwd_level2_reference`."""
    if _build.on_cpu(x, "fwd_level2"):
        return fwd_level2_reference(x, h0a, h0b, h1a, h1b, planes, h2a, h2b)
    _build.check_no_grad("fwd_level2", x)
    if (h2a is None) != (h2b is None):
        raise ValueError("fwd_level2 takes the third pair h2a, h2b together")
    if x.ndim < 2 or x.shape[-2] % 4 or x.shape[-1] % 4:
        raise ValueError("fwd_level2 needs [..., R, C] with R, C multiples "
                         "of 4, got %s" % (tuple(x.shape),))
    f = _build.pair_filters("fwd_level2", h0b, h0a, h1b, h1a, h2b, h2a)
    if not x.is_contiguous():
        raise ValueError("fwd_level2 needs a contiguous input")
    code = _build.dtype_code(x.dtype)
    if code == 1 and not planes:
        raise TypeError("bfloat16 subbands exist only in the plane layout")
    if not _build.within_bound("fwd_level2", [f[0].size]):
        return _forward(x, f[1], f[0], f[3], f[2], planes, f[5], f[4],
                        longfir)
    t0, o0 = dfilt_streams(f[0], f[1])
    t1, o1 = dfilt_streams(f[2], f[3])
    t2, o2 = (None, None) if h2a is None else dfilt_streams(f[4], f[5])
    x3, lead = _build.flatten_batch(x)
    B, R, C = x3.shape
    geo = _level2_geometry(B, R, C, t0.shape[1], x.dtype, planes,
                           2 if t2 is None else 3)
    _build.check_smem_bytes("fwd_level2", geo.smem)
    lolo = torch.empty((B, R // 2, C // 2), dtype=x.dtype, device=x.device)
    h, w = R // 4, C // 4
    if planes:
        re = torch.empty((B, 6, h, w), dtype=x.dtype, device=x.device)
        im = torch.empty_like(re)
        out_a, out_b = re, im
    else:
        ctype = torch.complex64 if x.dtype == torch.float32 else \
            torch.complex128
        z = torch.empty((B, h, w, 6), dtype=ctype, device=x.device)
        out_a, out_b = torch.view_as_real(z), None
    taps = _build.taps_arg(t0, t1)
    offs = _build.ints_arg(o0 + o1)
    taps2 = None if t2 is None else _build.taps_arg(t2)
    offs2 = None if t2 is None else _build.ints_arg(o2)
    lib = _build.library()
    err = lib.dtcwt_level2(
        x3.data_ptr(), lolo.data_ptr(), out_a.data_ptr(),
        None if out_b is None else out_b.data_ptr(), B, R, C,
        taps.ctypes.data, offs.ctypes.data, _build.ptr(taps2),
        _build.ptr(offs2), geo.m, code, int(planes), geo.qh, geo.mt,
        int(geo.vlo), int(geo.vpl), _build.stream_ptr(x.device))
    _build.check("fwd_level2", err)
    _build.count("level2")
    lolo = lolo.reshape(lead + lolo.shape[1:])
    if planes:
        return lolo, (re.reshape(lead + re.shape[1:]),
                      im.reshape(lead + im.shape[1:]))
    return lolo, z.reshape(lead + z.shape[1:])
