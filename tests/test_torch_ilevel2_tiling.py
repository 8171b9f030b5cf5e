"""The tiling of the ``inv_level2`` kernel (``csrc/ilevel2.cu``), replayed on
the CPU in numpy at float64.

The kernel cannot run here, so this replays, block by block, what
``ops/ilevel2.py:_ilevel2_geometry`` tells it to do: which band positions
each staging item reads (after reflection, with the parity swap of an odd
fold) and which shared cells of the quad images it writes, which lowpass
samples and quad-image cells each column-stage item loads into its two
parity windows and which cells of the parity-split column images it
writes, which 16-byte windows the row stage reads, and which output
elements each row-stage item stores, at which flat offsets.  Every output
element must be written exactly once and equal
:func:`inv_level2_reference`; every shared cell a stage reads must have
been written, and no cell twice.  Edit the replay together with the
kernel.
"""

import numpy as np
import pytest
import torch

from dtcwt_tpu_torch.coeffs import qshift
from dtcwt_tpu_torch.ops import _build, ilevel2
from dtcwt_tpu_torch.transforms.pyramid import PLANE_BAND_ORDER

_S = np.sqrt(0.5)


def _fold(j, n):
    """reflect() of csrc/common.cuh (fold() reduces to it): symmetric
    reflection with repeated ends, folded as often as needed."""
    t = np.mod(j, 2 * n)
    return np.where(t < n, t, 2 * n - 1 - t)


def _c2q(r0, i0, r1, i1):
    """common.cuh c2q at the four parities: [pr][pc]."""
    return ((r0 * _S + r1 * _S, i0 * _S + i1 * _S),
            (i0 * _S - i1 * _S, r1 * _S - r0 * _S))


def _stream_taps(hb, ha, mt):
    """The kernel's I2Taps of the pair ifilt(., hb, ha): taps by output
    stream, shifted by d_s // 2 (d_s = offs[s] + 2 (m2 // 2)) and zero past
    them up to the tap bound *mt*, and the swap sw (stream s reads parity
    (s & 1) ^ sw)."""
    taps, offs = ilevel2.ifilt_streams(hb, ha)
    m2 = taps.shape[1]
    d = [o + 2 * (m2 // 2) for o in offs]
    sw = d[0] & 1
    assert all(0 <= x <= 3 and (x & 1) == ((s & 1) ^ sw)
               for s, x in enumerate(d))
    t = np.zeros((4, mt))
    for s in range(4):
        t[s, d[s] >> 1:(d[s] >> 1) + m2] = taps[s]
    assert not t[:, 2 * (m2 // 2) + 1:].any()     # the reach 2 h2 + 1
    return t, sw


def _fir(t, n, nw):
    """The stream matrices of a tap loop over n window positions: out[:,
    4 v + s] = wa @ ma[4 v + s] + wb @ mb[4 v + s], wa for even streams, wb
    for odd ones, taps t[s][k] on window sample v + k."""
    ma, mb = np.zeros((4 * n, nw)), np.zeros((4 * n, nw))
    for v in range(n):
        for s in range(4):
            (mb if s & 1 else ma)[4 * v + s, v:v + t.shape[1]] = t[s]
    return ma, mb


def _replay(z, bands, pairs, geo, planes, band_ptr):
    """Run the kernel's index arithmetic on the lowpass *z* [B, H, W] and
    *bands* (the flat interleaved subbands as real pairs, or the (re, im)
    planes flat) with the stream taps *pairs* (2, or 3 with the third
    stream); return the output [B, 2H, 2W] and assert every write lands
    once."""
    B, H, W = z.shape
    h, w = H // 2, W // 2
    qh, tq, G, h2, mt, xq, xh, nw = (geo.qh, geo.tq, geo.g, geo.h2, geo.mt,
                                     geo.xq, geo.xh, geo.nw)
    npair = len(pairs)
    acc = 8 if G == 2 else 4
    assert qh in (4, 8) and qh % G == 0 and tq == 32
    assert 2 * h2 + 1 <= mt and xq == tq + mt - 1
    assert xh % 32 == 16 and xh >= xq and xh >= tq - 4 + nw
    assert nw % (16 // acc) == 0 and nw >= mt + 3
    assert geo.grid == (-(-w // tq), -(-h // qh), B)
    xc = 2 * xq
    nr = qh + mt - 1
    assert geo.smem == acc * (3 * 2 * nr * xc + npair * 4 * qh * 2 * xh)
    assert geo.vq == (not planes and band_ptr % 16 == 0)
    out = np.zeros(B * 4 * H * W)
    nout = np.zeros(out.size, np.int64)
    pos = [PLANE_BAND_ORDER.index(d) for d in range(6)]
    nwc = G + mt - 1
    colm = [_fir(t, G, nwc) for t, _ in pairs]
    rowm = [_fir(t, 4, nw) for t, _ in pairs]
    for b in range(B):
        zb = z[b]
        for by in range(geo.grid[1]):
            for bx in range(geo.grid[0]):
                i0, j0 = by * qh, bx * tq
                # staging: one quad an item, from 2 h2 pixels before the tile
                qs = np.full((3, 2 * nr, xc), np.nan)
                it = np.arange(nr * xq)
                sr, sc = it // xq, it % xq
                tr = _fold(2 * (i0 - h2 + sr), H)
                tc = _fold(2 * (j0 - h2 + sc), W)
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
                assert not np.isnan(qs).any()   # every cell staged
                # column stage: two parity windows of each source image
                st = np.full((npair, 4 * qh, 2, xh), np.nan)
                it = np.arange(qh // G * xc)
                g, lc = it // xc, it % xc
                gc = _fold(2 * (j0 - h2) + lc, W)
                r0 = 2 * (i0 - h2)
                rs = 2 * G * g
                tw = 2 * np.arange(nwc)
                rows_in = r0 >= 0 and r0 + 2 * qh + 2 * mt - 3 < H

                def zwin(par):
                    rows = r0 + rs[:, None] + par + tw
                    if rows_in:
                        assert rows.min() >= 0 and rows.max() < H
                    else:
                        rows = _fold(rows, H)
                    return zb[rows, gc[:, None]]

                def qwin(img, par):
                    rows = rs[:, None] + par + tw
                    assert rows.max() < 2 * nr
                    return qs[img][rows, lc[:, None]]

                def col(win, p):
                    sw = pairs[p][1]
                    ma, mb = colm[p]
                    return win(sw) @ ma.T + win(1 - sw) @ mb.T
                y = [col(zwin, 0) + col(lambda s: qwin(0, s), 1)]
                hl = col(lambda s: qwin(1, s), 0)
                hh = col(lambda s: qwin(2, s), 2 if npair == 3 else 1)
                y += [hl, hh] if npair == 3 else [hl + hh]
                rows = 4 * G * g[:, None] + np.arange(4 * G)
                for p in range(npair):
                    dst = st[p][rows, lc[:, None] & 1, lc[:, None] >> 1]
                    assert np.isnan(dst).all()      # written once
                    st[p][rows, lc[:, None] & 1, lc[:, None] >> 1] = y[p]
                # row stage, an item a thread (32 qh <= 256); a warp (4
                # output rows) is skipped only below h
                it = np.arange(32 * qh)
                assert it.size <= 256
                _rows(it[i0 + (it >> 5) < h], st, pairs, rowm, geo, w,
                      (b * 2 * H + 4 * i0) * 2 * W, 2 * W, j0,
                      3 * 2 * nr * xc, out, nout)
    assert (nout == 1).all(), "output elements written %s times" % set(nout)
    return out.reshape(B, 2 * H, 2 * W)


def _rows(it, st, pairs, rowm, geo, w, base, row, j0, space, out, nout):
    """The row stage: items *it* (each warp's 32 items are 4
    output rows by 8 groups of 4 band columns) filter their rows, stage
    their samples in their warp's [4][32][4] space (band column 4 g + q at
    slot q ^ (g // 2 % 4)), and lane l stores band column j0 + l of the
    warp's 4 rows, one 4-sample vector a row, at *base* + *row* x (tile
    row) + 4 x (band column)."""
    if not it.size:
        return
    mt, nw, xh, tq = geo.mt, geo.nw, geo.xh, geo.tq
    rr, gg = it >> 3, it & 7
    win = 4 * gg[:, None] + np.arange(nw)   # 16-byte vectors
    assert win.max() < xh and (win[:, 0] % 4 == 0).all()
    o = 0
    for p, (_, sw) in enumerate(pairs):
        wa = st[p][rr[:, None], sw, win]
        wb = st[p][rr[:, None], 1 - sw, win]
        # the tap loops have no guard: every sample they use was written
        assert not np.isnan(wa[:, :mt + 3]).any()
        assert not np.isnan(wb[:, :mt + 3]).any()
        ra, rb = rowm[p]
        o = o + np.nan_to_num(wa) @ ra.T + np.nan_to_num(wb) @ rb.T
    warp = it >> 5
    assert (warp.max() + 1) * 4 * tq * 4 <= space   # in the quad images'
    ws = np.full((8, 4, tq, 4), np.nan)
    for q in range(4):
        slot = 4 * gg + (q ^ (gg >> 1 & 3))
        assert np.isnan(ws[warp, rr & 3, slot]).all()
        ws[warp, rr & 3, slot] = o[:, 4 * q:4 * q + 4]
    lane = np.arange(tq)
    sel = j0 + lane < w
    slot = (4 * (lane >> 2) + ((lane & 3) ^ (lane >> 3 & 3)))[sel]
    for wp in np.unique(warp):
        rw = rr[warp == wp].min()
        assert rw % 4 == 0 and (rr[warp == wp] < rw + 4).all()
        vals = ws[wp][:, slot]               # [4 rows][lanes][4]
        assert not np.isnan(vals).any()
        for r in range(4):
            off = base + (rw + r) * row + 4 * (j0 + lane[sel])
            assert (off % 4 == 0).all()      # one 4-sample vector
            for s in range(4):
                np.add.at(nout, off + s, 1)
                out[off + s] = vals[r, :, s]


# (B, H, W) lowpass shapes: an image shorter than every filter (qshift_32's
# reach folds more than once), tiles crossed both ways, rows of one band
# column (too short for a row item), tall and wide images, a batch
_SHAPES = [(1, 4, 6), (2, 20, 28), (1, 66, 130), (1, 1030, 6), (1, 6, 1030),
           (3, 38, 134)]
# qshift_a (tap bound 5), qshift_c (m/2 even), qshift_d (9), qshift_32
# (17), qshift_b_bp (the third stream)
_FAMILIES = ["qshift_a", "qshift_c", "qshift_d", "qshift_32", "qshift_b_bp"]
# (dtype, planes, band_ptr % 16): f32 interleaved with 16-byte quads and
# at an 8-byte band offset (an element of storage offset), bf16 planes,
# f64 in both layouts
_KINDS = [(torch.float32, False, 0), (torch.float32, False, 8),
          (torch.bfloat16, True, 0), (torch.float64, False, 0),
          (torch.float64, True, 0)]


def _check(shape, fam, kinds, qh=None):
    q = qshift(fam)
    g = dict(g0a=q[2], g0b=q[3], g1a=q[6], g1b=q[7])
    fp = [(q[3], q[2]), (q[7], q[6])]
    if len(q) == 12:
        g.update(g2a=q[10], g2b=q[11])
        fp.append((q[11], q[10]))
    B, H, W = shape
    rng = np.random.RandomState(sum(shape) + len(fam))
    z = rng.rand(B, H, W)
    yh = rng.rand(B, H // 2, W // 2, 6) + 1j * rng.rand(B, H // 2, W // 2, 6)
    re = np.stack([yh[..., d].real for d in PLANE_BAND_ORDER], axis=1)
    im = np.stack([yh[..., d].imag for d in PLANE_BAND_ORDER], axis=1)
    zt = torch.from_numpy(z)
    want = ilevel2.inv_level2_reference(zt, torch.from_numpy(yh),
                                        **g).numpy()
    want_pl = ilevel2.inv_level2_reference(
        zt, bands=(torch.from_numpy(re), torch.from_numpy(im)), **g).numpy()
    np.testing.assert_allclose(want_pl, want, rtol=0, atol=1e-12)
    inter = np.stack([yh.real, yh.imag], axis=-1).reshape(-1)
    planes_flat = (re.reshape(-1), im.reshape(-1))
    for dtype, planes, boff in kinds:
        geo = ilevel2._ilevel2_geometry(B, H, W, q[2].size, dtype, planes,
                                        len(fp), boff, qh=qh)
        pairs = [_stream_taps(hb, ha, geo.mt) for hb, ha in fp]
        got = _replay(z, planes_flat if planes else inter, pairs, geo,
                      planes, boff)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("fam", _FAMILIES)
@pytest.mark.parametrize("shape", _SHAPES)
def test_ilevel2_tiling_replay(shape, fam):
    """Each block's reads and writes, at every shape and family, for the
    f32 interleaved (aligned and offset subbands), bf16 planes and f64
    geometries, against the plain version at float64."""
    _check(shape, fam, _KINDS)


@pytest.mark.parametrize("qh", [4, 8])
@pytest.mark.parametrize("fam", ["qshift_a", "qshift_b_bp"])
def test_ilevel2_tiling_replay_tile_heights(fam, qh):
    """Every tile height the kernel takes, on a batch whose tiles cross the
    image's edges both ways and whose last band rows leave a tile part
    empty."""
    _check((2, 74, 134), fam, [(torch.float32, False, 0),
                               (torch.float32, True, 0)], qh=qh)


def test_ilevel2_geometry_main_path():
    """The main path's tilings, lowpass 1024^2 and 2048^2: tap bounds,
    tile heights (8 where two blocks fit an SM by shared memory, else 4),
    shared memory and interior blocks (no row reflection) for qshift_a (5
    taps a stream), qshift_b (7), qshift_b_bp (7, three pairs), qshift_c
    and qshift_d (9) and qshift_32 (17), float32 / bfloat16 and float64;
    the quad loads' rule."""
    cases = [  # (m, streams, dtype, planes) -> (mt, qh)
        ((10, 2, torch.float32, False), (5, 8)),
        ((10, 2, torch.bfloat16, True), (5, 8)),
        ((14, 2, torch.float32, True), (7, 8)),
        ((14, 3, torch.float32, False), (7, 8)),
        ((16, 2, torch.float32, False), (9, 8)),
        ((18, 2, torch.float32, True), (9, 8)),
        ((32, 2, torch.float32, False), (17, 8)),
        ((14, 3, torch.float64, True), (17, 4)),
    ]
    for N in (1024, 2048):
        for (m, ns, dtype, planes), (mt, qh) in cases:
            geo = ilevel2._ilevel2_geometry(1, N, N, m, dtype, planes, ns)
            acc = 8 if dtype == torch.float64 else 4
            assert (geo.mt, geo.qh, geo.tq, geo.xq, geo.xh) == (
                mt, qh, 32, 31 + mt, 48), (m, ns, dtype)
            assert geo.g == (2 if dtype == torch.float64 else 4)
            assert geo.grid == (N // 64, N // (2 * qh), 1)
            assert geo.smem == acc * (3 * 2 * (qh + mt - 1) * 2 * geo.xq
                                      + ns * 4 * qh * 2 * geo.xh)
            assert geo.smem <= _build.SMEM_LIMIT
            # two blocks an SM by shared memory, in f32 and bf16
            assert (2 * (geo.smem + 1024) <= 233472) == (acc == 4)
            assert geo.vq == (not planes)
            rows = 2 * qh
            interior = sum(1 for by in range(geo.grid[1])
                           if by * rows - 2 * geo.h2 >= 0
                           and by * rows - 2 * geo.h2 + rows + 2 * mt - 3
                           < N)
            # the first block, and the last ones whose windows reach past
            # the image: one in f32, four in f64 (tiles of 4 band rows)
            bottom = -(-(rows + 2 * mt - 2 - 2 * geo.h2) // rows) - 1
            assert bottom == (1 if acc == 4 else 4)
            assert interior == geo.grid[1] - 1 - bottom
    # small images take shorter tiles, to give every SM a block
    assert [ilevel2._ilevel2_geometry(1, n, n, 10, torch.float32, True).qh
            for n in (1024, 512, 256)] == [8, 8, 4]
    # 16-byte quads only for interleaved subbands at a 16-byte address
    for planes, bptr, vq in ((False, 0, True), (False, 8, False),
                             (True, 0, False)):
        geo = ilevel2._ilevel2_geometry(1, 8, 8, 10, torch.float32, planes,
                                        2, bptr)
        assert geo.vq == vq
