"""Level-1 inverse of the 2-D DTCWT: one CUDA kernel and its plain version.

Replaces the Pallas kernel ``dtcwt_tpu/ops/pallas_ilevel1.py:inv_level1``.
What bounds it on the H100, and what the design does about it, is in the
kernel's source, ``csrc/ilevel1.cu``: a memory-bound stencil whose blocks
each take a tile of 16 rows (float64: 8) by 128 columns, build the
tile's quad images once per quad in shared memory, filter their columns
from register windows and their rows from 16-byte shared windows, and
store in vectors; no quad image reaches device memory.
:func:`_ilevel1_geometry` chooses the tiling (rows a tile, the
compile-time tap bound, the quad loads, the store vectors) and the kernel
refuses any other; the CPU tests replay it
(``tests/test_torch_ilevel1_tiling.py``).

:func:`inv_level1` takes its route from the input's device: a CPU tensor
runs :func:`inv_level1_reference`, a CUDA tensor launches the kernel or
raises.  The subbands come as in :func:`ilevel2.inv_level2`.  The bandpass
families' third filter *g2o* is the kernel's third stream: the ``hh`` quad
image gets ``g2o`` on both axes instead of sharing the second column stage;
like ``g0o`` and ``g1o`` it must have an odd length, and the largest of the
three half-lengths sets the tile's halo.  The kernel takes filters of up
to 31 taps; past that the card runs the plain version's chain on
the long-filter kernel (:mod:`longfir`: three two-input launches).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dtcwt_tpu_torch.ops import _build, fb, longfir
from dtcwt_tpu_torch.ops.ilevel2 import _band_args, _quads
from dtcwt_tpu_torch.utils import compute_view

__all__ = ["inv_level1", "inv_level1_reference"]


def inv_level1_reference(z: torch.Tensor, yh=None, g0o=None, g1o=None,
                         bands=None, g2o=None):
    """Plain PyTorch level-1 inverse: lowpass ``[..., H, W]`` plus the
    level-1 subbands -> the image ``[..., H, W]`` in the lowpass's dtype.
    *g2o* is the bandpass families' third synthesis filter."""
    return _inverse(z, yh, g0o, g1o, bands, g2o, fb)


def _inverse(z, yh, g0o, g1o, bands, g2o, ops):
    """:func:`inv_level1_reference`'s chain with the filters of *ops*:
    :mod:`fb`, or on the card's long route :mod:`longfir`."""
    lh, hl, hh = _quads(yh, bands)
    y1 = ops.filter2_sum_axis(compute_view(z), lh, g0o, g1o, -2)
    if g2o is not None:
        y2 = ops.filter_axis(hl, g0o, -2)
        y2bp = ops.filter_axis(hh, g2o, -2)
        out = (ops.filter2_sum_axis(y1, y2, g0o, g1o, -1)
               + ops.filter_axis(y2bp, g2o, -1))
    else:
        y2 = ops.filter2_sum_axis(hl, hh, g0o, g1o, -2)
        out = ops.filter2_sum_axis(y1, y2, g0o, g1o, -1)
    return out.to(z.dtype)


_TW = 128             # csrc/l1tile.cuh L1_TW: output columns a tile
_V = 4                # L1_V: output columns a row-stage item


class Ilevel1Geometry(NamedTuple):
    """The tiling of one ``inv_level1`` launch (``csrc/ilevel1.cu``).

    Block ``(bx, by, b)`` of ``grid`` owns output rows ``[by * th, by * th
    + th)`` and columns ``[bx * tw, bx * tw + tw)`` of image ``b``, with
    256 threads.  Staging: item ``it`` (``< (th/2 + e) * (tw/2 + e)``,
    threads taking ``it = tid, tid + 256, ...``) is staged quad ``(it //
    (tw/2 + e), it % (tw/2 + e))``, the quad of pixel rows and columns
    ``by * th - e + 2 sr ..`` and ``bx * tw - e + 2 sc ..``, reflected onto
    its source quad; it writes the quad's 2 x 2 pixels of lh, hl and hh
    (rows or columns swapped where the reflection is odd) to shared
    ``[3][th + 2e][xc]``.  Column stage: item ``it`` (``< th // rv * (tw +
    2p)``) is staged column ``lc = it % (tw + 2p)`` by tile rows ``(it //
    (tw + 2p)) * rv ..`` + rv - 1, the lowpass read from device memory,
    the quad images from shared memory; it writes y1, y2 (and y3) to
    shared ``[streams][th][xws]``.  Row stage: item ``it`` (``< th * tw //
    4``) is tile row ``it // 32`` (one warp) by output columns ``4 * (it
    % 32) ..`` + 3.  *p*: the halo (largest half-length); *e*: the quad
    images' halo (even, >= p); *mt*: the tap loops' compile-time bound;
    *smem*: dynamic shared memory bytes a block; *vq*: the interleaved
    subbands read as 16-byte pieces; *vo*: output stores 4 or 2 wide."""
    th: int
    tw: int
    rv: int
    p: int
    e: int
    mt: int
    xc: int
    xws: int
    smem: int
    grid: Tuple[int, int, int]
    vq: bool
    vo: int


def _ilevel1_geometry(B: int, H: int, W: int, m_max: int,
                      dtype: torch.dtype, planes: bool, streams: int = 2,
                      band_ptr: int = 0, out_ptr: int = 0
                      ) -> Ilevel1Geometry:
    """The tiling of ``inv_level1`` on ``[B, H, W]`` with filters of at most
    *m_max* taps and *streams* column images (3 with the bandpass third
    stream), for *dtype* in the plane or interleaved layout, in tiles of
    one column-stage item's rows (16, float64 8).  *band_ptr* and *out_ptr*
    are the addresses of the subbands (interleaved: as real pairs) and the
    output: the caller's pyramid may hold the subbands at a storage offset,
    so the 16-byte quad loads depend on the address as well as the
    layout."""
    f64 = dtype == torch.float64
    p = m_max // 2
    mm = 2 * p + 1
    if f64:
        mt = 32                              # one bound: f64 is for tests
    elif streams == 3:
        mt = 24 if mm <= 24 else 32          # the bandpass family's 19 taps
    else:
        mt = next(t for t in (8, 16, 24, 32) if mm <= t)
    acc, rv = (8, 8) if f64 else (4, 16)
    th = rv
    e = (p + 1) // 2 * 2
    xc = _TW + 2 * e
    xws = -(-(_TW + 2 * p) // 4) * 4
    smem = acc * (3 * (th + 2 * e) * xc + streams * th * xws)
    item = torch.finfo(dtype).bits // 8
    vo = 4 if W % _V == 0 and out_ptr % (_V * item) == 0 else 2
    return Ilevel1Geometry(
        th, _TW, rv, p, e, mt, xc, xws, smem, (-(-W // _TW), -(-H // th), B),
        not planes and band_ptr % 16 == 0, vo)


def inv_level1(z: torch.Tensor, yh=None, g0o=None, g1o=None, bands=None,
               g2o=None):
    """Level-1 inverse; see :func:`inv_level1_reference`."""
    if _build.on_cpu(z, "inv_level1"):
        return inv_level1_reference(z, yh, g0o, g1o, bands, g2o)
    _build.check_no_grad("inv_level1", z, yh, bands)
    filt = _build.odd_filters("inv_level1", g0o, g1o, g2o)
    if z.ndim < 2 or z.shape[-2] % 2 or z.shape[-1] % 2:
        raise ValueError("inv_level1 needs [..., H, W] with H, W even, got "
                         "%s" % (tuple(z.shape),))
    if not z.is_contiguous():
        raise ValueError("inv_level1 needs a contiguous lowpass")
    code = _build.dtype_code(z.dtype)
    band_a, band_b, planes = _band_args(z, yh, bands, "inv_level1")
    n = [f.size for f in filt if f is not None]
    if not _build.within_bound("inv_level1", n):
        return _inverse(z, yh, *filt[:2], bands, filt[2], longfir)
    z3, lead = _build.flatten_batch(z)
    B, H, W = z3.shape
    out = torch.empty_like(z3)
    geo = _ilevel1_geometry(B, H, W, max(n), z.dtype, planes, len(n),
                            band_a.data_ptr(), out.data_ptr())
    _build.check_smem_bytes("inv_level1", geo.smem)
    taps, _tables = _build.fir_args(filt)
    lib = _build.library()
    err = lib.dtcwt_ilevel1(
        z3.data_ptr(), band_a.data_ptr(),
        None if band_b is None else band_b.data_ptr(), out.data_ptr(),
        B, H, W, *taps, code, planes, geo.th, geo.mt, int(geo.vq), geo.vo,
        _build.stream_ptr(z.device))
    _build.check("inv_level1", err)
    _build.count("ilevel1")
    return out.reshape(lead + out.shape[1:])
