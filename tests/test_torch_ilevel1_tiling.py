"""The tiling of the ``inv_level1`` kernel (``csrc/ilevel1.cu``), replayed on
the CPU in numpy at float64.

The kernel cannot run here, so this replays, block by block, what
``ops/ilevel1.py:_ilevel1_geometry`` tells it to do: which quads each
staging item reads (after reflection, with the parity swap of an odd
fold) and which shared cells it writes, which lowpass samples and shared
cells each column-stage item reads and writes, which shared windows the
row stage reads, and which output elements each row-stage item stores, at
which flat offsets and with which vector widths.  Every output element
must be written exactly once and equal :func:`inv_level1_reference`; every
shared cell a stage reads must have been written, and no cell twice.
Edit the replay together with the kernel.
"""

import numpy as np
import pytest
import torch

from dtcwt_tpu_torch.ops import _build, ilevel1
from dtcwt_tpu_torch.transforms.pyramid import PLANE_BAND_ORDER

_S = np.sqrt(0.5)


def _fold(j, n):
    """reflect() of csrc/common.cuh (fold() reduces to it): symmetric
    reflection with repeated ends, folded as often as needed."""
    t = np.mod(j, 2 * n)
    return np.where(t < n, t, 2 * n - 1 - t)


def _centred(filters, p):
    """The kernel's I1Taps: reversed taps centred on the halo p, and the
    range of k each filter covers (zero outside it)."""
    tp = np.zeros((3, 2 * p + 1))
    rng = []
    for s, h in enumerate(filters):
        m = h.size
        tp[s, p - m // 2:p - m // 2 + m] = h[::-1]
        rng.append(range(p - m // 2, p + m // 2 + 1))
    return tp, rng


def _c2q(r0, i0, r1, i1):
    """common.cuh c2q at the four parities: [pr][pc]."""
    return ((r0 * _S + r1 * _S, i0 * _S + i1 * _S),
            (i0 * _S - i1 * _S, r1 * _S - r0 * _S))


def _replay(z, bands, filters, geo, planes, item, band_ptr, out_ptr):
    """Run the kernel's index arithmetic; return the output [B, H, W] and
    assert every write lands once.  *bands*: the flat interleaved subbands
    as real pairs ([B, h, w, 6, 2]) or the (re, im) planes [B, 6, h, w];
    *item*: the output's bytes an element."""
    B, H, W = z.shape
    h, w = H // 2, W // 2
    th, tw, rv, p, e, xc, xws = (geo.th, geo.tw, geo.rv, geo.p, geo.e,
                                 geo.xc, geo.xws)
    ns = len(filters)
    mm = 2 * p + 1
    acc = 8 if geo.rv == 8 else 4
    assert geo.grid == (-(-W // tw), -(-H // th), B) and th % rv == 0
    assert tw == 128
    assert e % 2 == 0 and p <= e < p + 2 and xc == tw + 2 * e
    assert xws % 4 == 0 and xws >= tw + 2 * p and mm <= geo.mt
    assert geo.smem == acc * (3 * (th + 2 * e) * xc + ns * th * xws)
    assert geo.vq == (not planes and band_ptr % 16 == 0)
    tp, rng = _centred(filters, p)
    out = np.zeros(B * H * W)
    nout = np.zeros(B * H * W, np.int64)
    zf = z.reshape(B, H * W)
    pos = [PLANE_BAND_ORDER.index(d) for d in range(6)]

    def fir(v, s, n):
        return sum(tp[s, k] * v[:, k:k + n] for k in rng[s])

    for b in range(B):
        for by in range(geo.grid[1]):
            for bx in range(geo.grid[0]):
                r0, c0 = by * th, bx * tw
                # staging: one quad an item
                qs = np.full((3, th + 2 * e, xc), np.nan)
                qc = tw // 2 + e
                it = np.arange((th // 2 + e) * qc)
                sr, sc = it // qc, it % qc
                tr = _fold(2 * (r0 // 2 - e // 2 + sr), H)
                tc = _fold(2 * (c0 // 2 - e // 2 + sc), W)
                fr, fc, qi, qj = tr & 1, tc & 1, tr >> 1, tc >> 1
                if planes:
                    off = (b * 6 * h + qi) * w + qj
                    re = [bands[0][off + pos[d] * h * w] for d in range(6)]
                    im = [bands[1][off + pos[d] * h * w] for d in range(6)]
                else:
                    q = ((b * h + qi) * w + qj) * 12
                    if geo.vq:     # three (f64: six) 16-byte pieces
                        assert ((band_ptr + q * acc) % 16 == 0).all()
                    re = [bands[q + 2 * d] for d in range(6)]
                    im = [bands[q + 2 * d + 1] for d in range(6)]
                for img, (d0, d1) in enumerate(((0, 5), (2, 3), (1, 4))):
                    a = _c2q(re[d0], im[d0], re[d1], im[d1])
                    for dr in range(2):
                        for dc in range(2):
                            src = np.choose((dr ^ fr) * 2 + (dc ^ fc),
                                            [a[0][0], a[0][1], a[1][0],
                                             a[1][1]])
                            rows, cols = 2 * sr + dr, 2 * sc + dc
                            assert np.isnan(qs[img, rows, cols]).all()
                            qs[img, rows, cols] = src
                assert not np.isnan(qs).any()  # every cell staged
                # column stage: lowpass from device memory, quads from smem
                st = np.full((ns, th, xws), np.nan)
                xw = tw + 2 * p
                it = np.arange(th // rv * xw)
                g, lc = it // xw, it % xw
                gc = _fold(c0 - p + lc, W)
                rows = (r0 + g * rv - p)[:, None] + np.arange(rv + mm - 1)
                if r0 - p >= 0 and r0 + th + p <= H:   # rows_in: no reflect
                    assert rows.min() >= 0 and rows.max() < H
                else:
                    rows = _fold(rows, H)
                zs = zf[b][rows * W + gc[:, None]]
                qr = (g * rv + e - p)[:, None] + np.arange(rv + mm - 1)
                qcol = (lc + e - p)[:, None]
                assert qr.max() < th + 2 * e and qcol.max() < xc
                win = [qs[img][qr, qcol] for img in range(3)]
                y = [fir(zs, 0, rv) + fir(win[0], 1, rv)]
                if ns == 3:
                    y += [fir(win[1], 0, rv), fir(win[2], 2, rv)]
                else:
                    y += [fir(win[1], 0, rv) + fir(win[2], 1, rv)]
                dst = (g * rv)[:, None] + np.arange(rv)
                for s in range(ns):
                    assert np.isnan(st[s][dst, lc[:, None]]).all()
                    st[s][dst, lc[:, None]] = y[s]
                # row stage; a warp (tile row) is skipped only below H
                it = np.arange(th * (tw // 4))
                rr, gg = it >> 5, it & 31
                r, c = r0 + rr, c0 + 4 * gg
                keep = r < H
                rr, r, c, gg = rr[keep], r[keep], c[keep], gg[keep]
                if not r.size:
                    continue
                win = 4 * gg[:, None] + np.arange(4 + mm - 1)
                assert win.max() < xws
                o = 0
                for s in range(ns):
                    ws = st[s][rr[:, None], win]
                    assert not np.isnan(ws).any()
                    o = o + fir(ws, s, 4)
                nc = np.clip(W - c, 0, 4)
                base = (b * H + r) * W + c
                vec = (geo.vo == 4) & (nc == 4)
                assert ((out_ptr + base[vec] * item) % (4 * item) == 0).all()
                for v in range(4):
                    m = v < nc
                    if v % 2 == 0:     # pairs where not a 4-wide store
                        pm = m & ~vec
                        assert ((out_ptr + (base[pm] + v) * item)
                                % (2 * item) == 0).all()
                    np.add.at(nout, base[m] + v, 1)
                    out[base[m] + v] = o[m, v]
    assert (nout == 1).all(), "output elements written %s times" % set(nout)
    return out.reshape(B, H, W)


def _filters(lengths, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(m) for m in lengths]


# (B, H, W): an image shorter than the 19- and 31-tap reach (folds more
# than once), rows of 4098 (33 column tiles, vo = 2), tiles crossed both
# ways, a batch
_SHAPES = [(1, 4, 6), (1, 2, 4098), (1, 130, 200), (3, 36, 52)]
# odd p (3, 9, 15), the bandpass triple, a 1-tap filter beside 31 taps
_LENGTHS = [(7, 5), (19, 13), (19, 13, 19), (1, 31)]
# (dtype, planes, band_ptr % 16, out_ptr % 32): f32 interleaved with
# 16-byte quads, then at an 8-byte band and output offset (an element of
# storage offset); bf16 planes; f64 in both layouts
_KINDS = [(torch.float32, False, 0, 0),
          (torch.float32, False, 8, 8),
          (torch.bfloat16, True, 0, 0),
          (torch.float64, False, 0, 0),
          (torch.float64, True, 0, 0)]


@pytest.mark.parametrize("lengths", _LENGTHS)
@pytest.mark.parametrize("shape", _SHAPES)
def test_ilevel1_tiling_replay(shape, lengths):
    """Each block's reads and writes, at every shape and filter set, for the
    f32 interleaved (aligned and offset subbands and output), bf16 planes
    and f64 geometries, against the plain version at
    float64; the lowpass is read at a storage offset."""
    B, H, W = shape
    rng = np.random.RandomState(sum(shape) + len(lengths))
    zbuf = rng.rand(B * H * W + 1)
    z = zbuf[1:].reshape(B, H, W)            # a misaligned lowpass
    yh = rng.rand(B, H // 2, W // 2, 6) + 1j * rng.rand(B, H // 2, W // 2, 6)
    re = np.stack([yh[..., d].real for d in PLANE_BAND_ORDER], axis=1)
    im = np.stack([yh[..., d].imag for d in PLANE_BAND_ORDER], axis=1)
    filt = _filters(lengths, len(lengths) * 100 + lengths[-1])
    g2o = filt[2] if len(filt) == 3 else None
    zt = torch.from_numpy(z)
    want = ilevel1.inv_level1_reference(zt, torch.from_numpy(yh), filt[0],
                                        filt[1], g2o=g2o).numpy()
    want_pl = ilevel1.inv_level1_reference(
        zt, None, filt[0], filt[1],
        bands=(torch.from_numpy(re), torch.from_numpy(im)), g2o=g2o).numpy()
    np.testing.assert_allclose(want_pl, want, rtol=0, atol=1e-12)
    inter = np.stack([yh.real, yh.imag], axis=-1).reshape(-1)
    planes_flat = (re.reshape(-1), im.reshape(-1))
    for dtype, planes, boff, ooff in _KINDS:
        item = torch.finfo(dtype).bits // 8
        geo = ilevel1._ilevel1_geometry(B, H, W, max(lengths), dtype, planes,
                                        len(lengths), 4096 + boff,
                                        4096 + ooff)
        got = _replay(z, planes_flat if planes else inter, filt, geo,
                      planes, item, 4096 + boff, 4096 + ooff)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_ilevel1_geometry_main_path():
    """The 4096^2 main path's tilings: tile, tap bound and shared memory for
    near_sym_a (7/5 taps), antonini (9/7), near_sym_b (19/13),
    near_sym_b_bp (19/13/19) and the longest filters (31 taps, third
    stream, f64) within a block's limit; interior blocks; the quad and
    store vector rules."""
    N = 4096
    cases = [  # (m_max, streams, dtype, planes) -> (th, mt, e, smem)
        ((7, 2, torch.float32, False), (16, 8, 4, 4 * (3 * 24 * 136
                                                       + 2 * 16 * 136))),
        ((7, 2, torch.bfloat16, True), (16, 8, 4, 4 * (3 * 24 * 136
                                                       + 2 * 16 * 136))),
        ((9, 2, torch.float32, True), (16, 16, 4, 4 * (3 * 24 * 136
                                                       + 2 * 16 * 136))),
        ((19, 2, torch.float32, False), (16, 24, 10, 4 * (3 * 36 * 148
                                                          + 2 * 16 * 148))),
        ((19, 3, torch.float32, False), (16, 24, 10, 4 * (3 * 36 * 148
                                                          + 3 * 16 * 148))),
        ((7, 3, torch.bfloat16, True), (16, 24, 4, 4 * (3 * 24 * 136
                                                         + 3 * 16 * 136))),
        ((31, 3, torch.float32, False), (16, 32, 16, 4 * (3 * 48 * 160
                                                          + 3 * 16 * 160))),
        ((7, 2, torch.float64, True), (8, 32, 4, 8 * (3 * 16 * 136
                                                      + 2 * 8 * 136))),
        ((31, 3, torch.float64, False), (8, 32, 16, 8 * (3 * 40 * 160
                                                         + 3 * 8 * 160))),
    ]
    for (m, ns, dtype, planes), (th, mt, e, smem) in cases:
        geo = ilevel1._ilevel1_geometry(1, N, N, m, dtype, planes, ns)
        assert (geo.th, geo.tw, geo.mt, geo.e, geo.smem) == (
            th, 128, mt, e, smem), (m, ns, dtype)
        assert geo.xc == 128 + 2 * e and geo.xws == -(-(128 + 2 * geo.p)
                                                      // 4) * 4
        assert geo.rv == (8 if dtype == torch.float64 else 16)
        assert geo.grid == (N // 128, N // th, 1)
        assert geo.smem <= _build.SMEM_LIMIT
        assert geo.vq == (not planes) and geo.vo == 4
        interior = sum(1 for by in range(geo.grid[1])
                       if by * th - geo.p >= 0
                       and by * th + th + geo.p <= N)
        assert interior == geo.grid[1] - 2 * -(-geo.p // th)  # edge rows
    # 16-byte quads only for aligned interleaved subbands; 4-wide stores
    # only for rows of a multiple of 4 at an aligned output
    for W, bptr, optr, vq, vo in ((4096, 0, 0, True, 4), (4098, 0, 0, True, 2),
                                  (200, 8, 0, False, 4), (6, 0, 0, True, 2),
                                  (4096, 0, 8, True, 2)):
        geo = ilevel1._ilevel1_geometry(1, 4, W, 7, torch.float32, False,
                                        2, bptr, optr)
        assert (geo.vq, geo.vo) == (vq, vo), W
    assert not ilevel1._ilevel1_geometry(1, 4, 8, 7, torch.float32,
                                         True).vq
