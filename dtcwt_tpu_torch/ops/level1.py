"""Level-1 forward of the 2-D DTCWT: one CUDA kernel and its plain version.

Replaces the Pallas kernel ``dtcwt_tpu/ops/pallas_level1.py:fwd_level1``.
What bounds it on the H100, and what the design does about it, is in the
kernel's source, ``csrc/level1.cu``: a memory-bound stencil whose blocks
each take a tile of 32 or 64 rows by 128 columns, filter its columns from
register windows into shared memory and its rows from 16-byte shared
windows, and store in vectors; no intermediate image reaches device
memory.  :func:`_level1_geometry` chooses the tiling (rows a tile, the
compile-time tap bound, the store vectors) and the kernel refuses any
other; the CPU tests replay it (``tests/test_torch_level1_tiling.py``).
The bandpass families' third filter *h2o* is the kernel's third stream
(bands 1 and 4 from ``h2o`` on both axes); like ``h0o`` and ``h1o`` it
must have an odd length, and the largest of the three half-lengths sets
the tile's halo.

:func:`fwd_level1` takes its route from the input's device: a CPU tensor
runs :func:`fwd_level1_reference`, a CUDA tensor launches the kernel or
raises.  The kernel takes filters of up to 31 taps; past that the card
runs the plain version's chain on the long-filter kernel
(:mod:`longfir`: a two-branch launch down the columns, two along the
rows).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dtcwt_tpu_torch.ops import _build, fb, longfir
from dtcwt_tpu_torch.ops.packing import q2c, q2c_planes
from dtcwt_tpu_torch.transforms.pyramid import PLANE_BAND_ORDER
from dtcwt_tpu_torch.utils import compute_view

__all__ = ["fwd_level1", "fwd_level1_reference"]


def _pack(im05, im23, im14, planes: bool, dtype):
    """q2c of the three highpass images into the six subbands: complex
    ``[..., h, w, 6]`` in degree order, or ``(re, im)`` planes
    ``[..., 6, h, w]`` in PLANE_BAND_ORDER stored as *dtype*."""
    if planes:
        b05, b23, b14 = q2c_planes(im05), q2c_planes(im23), q2c_planes(im14)
        deg = (b05[0], b14[0], b23[0], b23[1], b14[1], b05[1])
        re = torch.stack([deg[d][0] for d in PLANE_BAND_ORDER], dim=-3)
        im = torch.stack([deg[d][1] for d in PLANE_BAND_ORDER], dim=-3)
        return re.to(dtype), im.to(dtype)
    b05, b23, b14 = q2c(im05), q2c(im23), q2c(im14)
    return torch.stack([b05[0], b14[0], b23[0], b23[1], b14[1], b05[1]],
                       dim=-1)


def fwd_level1_reference(x: torch.Tensor, h0o, h1o, planes: bool = False,
                         h2o=None):
    """Plain PyTorch level-1 forward: ``(lolo [..., R, C], subbands)``, the
    subbands complex ``[..., R/2, C/2, 6]`` or ``(re, im)`` planes
    ``[..., 6, R/2, C/2]``.  *h2o* is the bandpass families' third filter."""
    return _forward(x, h0o, h1o, planes, h2o, fb)


def _forward(x, h0o, h1o, planes, h2o, ops):
    """:func:`fwd_level1_reference`'s chain with the filters of *ops*:
    :mod:`fb`, or on the card's long route :mod:`longfir`."""
    X = compute_view(x)
    lo, hi = ops.filter2_axis(X, h0o, h1o, -2)
    lolo, im23 = ops.filter2_axis(lo, h0o, h1o, -1)
    if h2o is not None:
        im05 = ops.filter_axis(hi, h0o, -1)
        im14 = ops.filter_axis(ops.filter_axis(X, h2o, -2), h2o, -1)
    else:
        im05, im14 = ops.filter2_axis(hi, h0o, h1o, -1)
    return lolo.to(x.dtype), _pack(im05, im23, im14, planes, x.dtype)


_THREADS = 256        # csrc/level1.cu L1_THREADS
_TW = 128             # L1_TW: output columns a tile
_TALL_SMEM = 73728    # 64-row tiles for bfloat16 where three blocks fit
_RV = 16              # L1_RV: output rows a column-stage item
_V = 4                # L1_V: output columns a row-stage item


class Level1Geometry(NamedTuple):
    """The tiling of one ``fwd_level1`` launch (``csrc/level1.cu``).

    Block ``(bx, by, b)`` of ``grid`` owns output rows ``[by * th, by * th
    + th)`` and columns ``[bx * tw, bx * tw + tw)`` of image ``b``.  Column
    stage: item ``it`` (``it < th // rv * (tw + 2p)``, threads taking
    ``it = tid, tid + threads, ...``) is staged column ``lc = it % (tw +
    2p)`` (input column ``bx * tw - p + lc``, reflected) by tile rows ``(it
    // (tw + 2p)) * rv ..`` + rv - 1.  Row stage: item ``it`` (``< th // 2
    * tw // 4``) is quad row ``it // 32`` (one warp) by output columns ``4
    * (it % 32) ..`` + 3 of the tile; in the interleaved layout the warp
    stages its 64 quads in shared memory and stores them as 16-byte
    pieces.  *p*: the halo (largest half-length); *mt*: the tap loops'
    compile-time bound (>= 2p + 1); *xws*: the shared row stride; *smem*:
    dynamic shared memory bytes a block; *vlo*: 4-wide lowpass stores;
    *vpl*: 2-wide plane stores."""
    th: int
    tw: int
    rv: int
    p: int
    mt: int
    xws: int
    smem: int
    grid: Tuple[int, int, int]
    vlo: bool
    vpl: bool


def _level1_geometry(B: int, R: int, C: int, m_max: int, dtype: torch.dtype,
                     planes: bool, streams: int = 2,
                     th: Optional[int] = None) -> Level1Geometry:
    """The tiling of ``fwd_level1`` on ``[B, R, C]`` with filters of at most
    *m_max* taps, *streams* column images (3 with the bandpass third
    stream), for outputs of *dtype* in the plane or interleaved layout, in
    tiles of *th* rows (32 or 64; by default 64 for bfloat16 where three
    blocks still fit an SM, else 32: the faster of the two on an H100 for
    each type).
    Outputs are fresh allocations, so 16-byte aligned: the vectors depend
    on the row and plane widths alone."""
    p = m_max // 2
    mt = next(t for t in (8, 16, 24, 32) if 2 * p + 1 <= t)
    acc = 8 if dtype == torch.float64 else 4
    xws = -(-(_TW + 2 * p) // 4) * 4

    def smem_of(rows):
        return acc * (streams * rows * xws + (0 if planes else _THREADS * 24))
    if th is None:
        th = 64 if (dtype == torch.bfloat16
                    and smem_of(64) <= _TALL_SMEM) else 32
    smem = smem_of(th)
    return Level1Geometry(
        th, _TW, _RV, p, mt, xws, smem, (-(-C // _TW), -(-R // th), B),
        C % _V == 0, bool(planes) and (C // 2) % 2 == 0)


def fwd_level1(x: torch.Tensor, h0o, h1o, planes: bool = False, h2o=None):
    """Level-1 forward of ``[..., R, C]`` (R, C even); see
    :func:`fwd_level1_reference` for the outputs."""
    if _build.on_cpu(x, "fwd_level1"):
        return fwd_level1_reference(x, h0o, h1o, planes, h2o)
    _build.check_no_grad("fwd_level1", x)
    filt = _build.odd_filters("fwd_level1", h0o, h1o, h2o)
    if x.ndim < 2 or x.shape[-2] % 2 or x.shape[-1] % 2:
        raise ValueError("fwd_level1 needs [..., R, C] with R, C even, got %s"
                         % (tuple(x.shape),))
    if not x.is_contiguous():
        raise ValueError("fwd_level1 needs a contiguous input")
    code = _build.dtype_code(x.dtype)
    if code == 1 and not planes:
        raise TypeError("bfloat16 subbands exist only in the plane layout")
    n = [f.size for f in filt if f is not None]
    if not _build.within_bound("fwd_level1", n):
        return _forward(x, *filt[:2], planes, filt[2], longfir)
    x3, lead = _build.flatten_batch(x)
    B, R, C = x3.shape
    geo = _level1_geometry(B, R, C, max(n), x.dtype, planes, len(n))
    _build.check_smem_bytes("fwd_level1", geo.smem)
    lolo = torch.empty_like(x3)
    h, w = R // 2, C // 2
    if planes:
        re = torch.empty((B, 6, h, w), dtype=x.dtype, device=x.device)
        im = torch.empty_like(re)
        out_a, out_b = re, im
    else:
        ctype = torch.complex64 if x.dtype == torch.float32 else \
            torch.complex128
        z = torch.empty((B, h, w, 6), dtype=ctype, device=x.device)
        out_a, out_b = torch.view_as_real(z), None
    taps, _tables = _build.fir_args(filt)
    lib = _build.library()
    err = lib.dtcwt_level1(
        x3.data_ptr(), lolo.data_ptr(), out_a.data_ptr(),
        None if out_b is None else out_b.data_ptr(), B, R, C, *taps, code,
        int(planes), geo.th, geo.mt, int(geo.vlo), int(geo.vpl),
        _build.stream_ptr(x.device))
    _build.check("fwd_level1", err)
    _build.count("level1")
    lolo = lolo.reshape(lead + (R, C))
    if planes:
        return lolo, (re.reshape(lead + re.shape[1:]),
                      im.reshape(lead + im.shape[1:]))
    return lolo, z.reshape(lead + z.shape[1:])
