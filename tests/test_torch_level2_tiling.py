"""The tiling of the ``fwd_level2`` kernel (``csrc/level2.cu``), replayed on
the CPU in numpy at float64.

The kernel cannot run here, so this replays, block by block, what
``ops/level2.py:_level2_geometry`` tells it to do: which input samples each
column-stage item loads (after reflection), which shared-memory cells of
the parity-split column images it writes and the row stage reads, and
which output elements each row-stage item stores, at which flat offsets
and with which vector widths.  Every lowpass and subband element must be
written exactly once and equal :func:`fwd_level2_reference`; every shared
cell the row stage reads must have been written.  Edit the replay together
with the kernel.
"""

import numpy as np
import pytest
import torch

from dtcwt_tpu_torch.coeffs import qshift
from dtcwt_tpu_torch.ops import _build, level2
from dtcwt_tpu_torch.transforms.pyramid import PLANE_BAND_ORDER

_S = np.sqrt(0.5)


def _fold(j, n):
    """reflect() of csrc/common.cuh (the kernel's one-fold test reduces to
    it): symmetric reflection with repeated ends, folded as often as
    needed."""
    t = np.mod(j, 2 * n)
    return np.where(t < n, t, 2 * n - 1 - t)


def _branches(hb, ha):
    """The kernel's L2Taps of the pair dfilt(., hb, ha): taps [branch a,
    branch b][k] and the swap flag (1 where branch b gives output 2i)."""
    taps, offs = level2.dfilt_streams(hb, ha)
    m = taps.shape[1]
    sw = int(offs[0] != 2 - m)
    assert offs[sw] == 2 - m and offs[1 - sw] == 3 - m
    return np.stack([taps[sw], taps[1 - sw]]), sw


def _q2c(a, b, c, d):
    return (a - d) * _S, (b + c) * _S, (a + d) * _S, (b - c) * _S


def _replay(x, pairs, geo, planes, acc):
    """Run the kernel's index arithmetic on *x* [B, R, C] with the branch
    taps *pairs* (2, or 3 with the third stream); return the outputs
    (lolo, and the interleaved [B, h, w, 6] complex or the planes) and
    assert every write lands once."""
    B, R, C = x.shape
    h, w, Cl = R // 4, C // 4, C // 2
    qh, tq, G, m, mt, xw, xh = (geo.qh, geo.tq, geo.g, geo.m, geo.mt,
                                geo.xw, geo.xh)
    npair = len(pairs)
    assert qh in (4, 8, 16) and qh % G == 0 and m <= mt and m % 2 == 0
    assert xw == 4 * tq + 2 * m and xh % 32 == 16 and 2 * xh >= xw
    assert geo.grid == (-(-w // tq), -(-h // qh), B)
    assert geo.smem == acc * (npair * 2 * qh * 2 * xh
                              + (0 if planes else 256 * 24))
    vn = 16 // acc            # a 16-byte vector's values
    loaded = -(-(m + 2) // vn) * vn           # a window's vectors
    assert 4 * (tq // 2 - 1) + loaded <= xh   # last lane's window fits
    lolo = np.zeros(B * (R // 2) * Cl)
    nlo = np.zeros(lolo.size, np.int64)
    nb = B * h * w * 12 if not planes else B * 6 * h * w
    za, zb = np.zeros(nb), np.zeros(nb)
    na = np.zeros(nb, np.int64)
    xf = x.reshape(B, R * C)
    for b in range(B):
        for by in range(geo.grid[1]):
            for bx in range(geo.grid[0]):
                i0, j0 = by * qh, bx * tq
                r0, c0 = 4 * i0, 4 * j0
                st = np.full((npair, 2 * qh, 2, xh), np.nan)
                # column stage
                it = np.arange(qh // G * xw)
                g, lc = it // xw, it % xw
                gc = _fold(c0 + 2 - m + lc, C)
                rs = r0 + 4 * G * g + 2 - m
                rows = rs[:, None] + np.arange(4 * G + 2 * m - 4)[None, :]
                if r0 + 2 - m >= 0 and r0 + 4 * qh + m - 3 < R:  # rows_in
                    assert rows.min() >= 0 and rows.max() < R
                else:
                    rows = _fold(rows, R)
                smp = xf[b][rows * C + gc[:, None]]
                for p, (tb, sw) in enumerate(pairs):
                    for v in range(G):
                        ya = sum(tb[0, k] * smp[:, 4 * v + 2 * k]
                                 for k in range(m))
                        yb = sum(tb[1, k] * smp[:, 4 * v + 1 + 2 * k]
                                 for k in range(m))
                        for val, row in ((ya, 2 * (G * g + v) + sw),
                                         (yb, 2 * (G * g + v) + 1 - sw)):
                            dst = st[p, row, lc % 2, lc // 2]
                            assert np.isnan(dst).all()      # written once
                            st[p, row, lc % 2, lc // 2] = val
                # row stage; a warp (quad row) is skipped only below h
                it = np.arange(qh * 32)
                qi, gg = it >> 5, it & 31
                i, j = i0 + qi, j0 + 2 * gg
                keep = i < h
                qi, gg, i, j = qi[keep], gg[keep], i[keep], j[keep]
                if not i.size:
                    continue
                # the tap loops have no guard: every sample a window's
                # vectors load is a written (finite) cell
                win = 4 * gg[:, None] + np.arange(loaded)

                def filt(img, pf, row):
                    e = st[img, row[:, None], 0, win]
                    o = st[img, row[:, None], 1, win]
                    assert not (np.isnan(e).any() or np.isnan(o).any())
                    tb, sw = pairs[pf]
                    y = np.zeros((row.size, 4))
                    for q in range(2):
                        y[:, 2 * q + sw] = sum(tb[0, k] * e[:, 2 * q + k]
                                               for k in range(m))
                        y[:, 2 * q + 1 - sw] = sum(
                            tb[1, k] * o[:, 2 * q + k] for k in range(m))
                    return y
                nc = np.clip(Cl - 2 * j, 0, 4)
                y05, y23, y14 = (np.zeros((2, i.size, 4)) for _ in range(3))
                for s in range(2):
                    row = 2 * qi + s
                    ll = filt(0, 0, row)
                    y23[s] = filt(0, 1, row)
                    y05[s] = filt(1, 0, row)
                    y14[s] = filt(2, 2, row) if npair == 3 else filt(1, 1,
                                                                     row)
                    off = (b * (R // 2) + 2 * i + s) * Cl + 2 * j
                    vec = geo.vlo & (nc == 4)
                    assert (off[vec] % 4 == 0).all()
                    for v in range(4):
                        sel = v < nc
                        np.add.at(nlo, off[sel] + v, 1)
                        lolo[off[sel] + v] = ll[sel, v]
                band = np.zeros((2, 2, 6, i.size))     # quad, re/im, degree
                for q in range(2):
                    u = 2 * q
                    for img, (d0, d1) in ((y05, (0, 5)), (y23, (2, 3)),
                                          (y14, (1, 4))):
                        r0_, i0_, r1_, i1_ = _q2c(
                            img[0, :, u], img[0, :, u + 1], img[1, :, u],
                            img[1, :, u + 1])
                        band[q, 0, d0], band[q, 1, d0] = r0_, i0_
                        band[q, 0, d1], band[q, 1, d1] = r1_, i1_
                if planes:
                    nq = nc // 2
                    for d in range(6):
                        off = ((b * 6 + PLANE_BAND_ORDER.index(d)) * h
                               + i) * w + j
                        vec = geo.vpl & (nq == 2)
                        assert (off[vec] % 2 == 0).all()
                        for q in range(2):
                            sel = q < nq
                            np.add.at(na, off[sel] + q, 1)
                            za[off[sel] + q] = band[q, 0, d, sel]
                            zb[off[sel] + q] = band[q, 1, d, sel]
                    continue
                # interleaved: each warp stages zs[24 g + t] = value t % 12
                # of quad t // 12 (re, im alternating), then lane g stores
                # pieces e * 32 + g of vn values where inside its 64 quads
                quads = min(w - j0, tq)
                nw = i.size // 32                    # whole warps
                assert (gg.reshape(nw, 32) == np.arange(32)).all()
                t = np.arange(24)
                zs = np.zeros((nw, 768))
                zs[:, 24 * np.arange(32)[:, None] + t] = band[
                    t // 12, t % 12 % 2, t % 12 // 2, :].T.reshape(nw, 32, 24)
                base = ((b * h + i[::32]) * w + j0) * 12
                assert (base % vn == 0).all()
                src = (np.arange(24 // vn)[:, None] * 32 + np.arange(32)) * vn
                src = (src[..., None] + np.arange(vn)).reshape(-1)
                src = src[src < quads * 12]
                assert (j0 + src // 12 < w).all()    # quads inside the row
                dst = (base[:, None] + src).reshape(-1)
                np.add.at(na, dst, 1)
                za[dst] = zs[:, src].reshape(-1)
    assert (nlo == 1).all(), "lowpass elements written %s times" % set(nlo)
    assert (na == 1).all(), "subband elements written %s times" % set(na)
    lolo = lolo.reshape(B, R // 2, Cl)
    if planes:
        return lolo, (za.reshape(B, 6, h, w), zb.reshape(B, 6, h, w))
    z = za.reshape(B, h, w, 6, 2)
    return lolo, z[..., 0] + 1j * z[..., 1]


# shapes that cross tile edges both ways, tall and wide images, rows too
# short or odd for the vectors (C / 2 not a multiple of 4, C / 4 odd),
# images shorter than the filter, a batch
_SHAPES = [(1, 8, 12), (2, 40, 56), (1, 132, 260), (1, 1032, 8),
           (1, 8, 1032), (3, 40, 56)]
_FAMILIES = ["qshift_a", "qshift_d", "qshift_32", "qshift_b_bp"]
_KINDS = [(torch.float32, False), (torch.bfloat16, True),
          (torch.float64, False), (torch.float64, True)]


def _check(x, fam, kinds, qh=None):
    q = qshift(fam)
    f = (q[0], q[1], q[4], q[5])
    bp = {"h2a": q[8], "h2b": q[9]} if len(q) == 12 else {}
    pairs = [_branches(q[1], q[0]), _branches(q[5], q[4])]
    if bp:
        pairs.append(_branches(q[9], q[8]))
    B, R, C = x.shape
    for dtype, planes in kinds:
        geo = level2._level2_geometry(B, R, C, q[0].size, dtype, planes,
                                      len(pairs), qh=qh)
        acc = 8 if dtype == torch.float64 else 4
        lo, bands = _replay(x, pairs, geo, planes, acc)
        ref = level2.fwd_level2_reference(torch.from_numpy(x), *f, planes,
                                          **bp)
        np.testing.assert_allclose(lo, ref[0].numpy(), rtol=0, atol=1e-12)
        if planes:
            for got, exp in zip(bands, ref[1]):
                np.testing.assert_allclose(got, exp.numpy(), rtol=0,
                                           atol=1e-12)
        else:
            np.testing.assert_allclose(bands, ref[1].numpy(), rtol=0,
                                       atol=1e-12)


@pytest.mark.parametrize("fam", _FAMILIES)
@pytest.mark.parametrize("shape", _SHAPES)
def test_level2_tiling_replay(shape, fam):
    """Each block's reads and writes, at every shape and family (m = 10,
    18, 32 and the third stream at 14), for the float32 interleaved,
    bfloat16 planes and float64 geometries, against the plain version at
    float64."""
    x = np.random.RandomState(sum(shape)).rand(*shape)
    _check(x, fam, _KINDS)


@pytest.mark.parametrize("qh", [4, 8, 16])
@pytest.mark.parametrize("fam", ["qshift_a", "qshift_b_bp"])
def test_level2_tiling_replay_tile_heights(fam, qh):
    """Every tile height the kernel takes, on a batch whose tiles cross the
    image's edges both ways and whose last quad rows leave a tile part
    empty."""
    x = np.random.RandomState(qh).rand(2, 76, 264)
    _check(x, fam, [(torch.float32, False), (torch.float32, True)], qh=qh)


def test_level2_geometry_main_path():
    """The main path's tilings at 4096^2 and 2048^2: tap bounds, tile
    heights (the tallest leaving two blocks an SM by shared memory),
    shared memory, interior blocks (no row reflection) and the vectors, for
    qshift_a (10 taps), qshift_b_bp (14, three pairs), qshift_d (18) and
    qshift_32, float32 / bfloat16 and float64."""
    z = 256 * 24             # the interleaved layout's staging, elements
    cases = [  # (m, streams, dtype, planes) -> (mt, xh, qh)
        ((10, 2, torch.float32, False), (10, 144, 16)),
        ((10, 2, torch.bfloat16, True), (10, 144, 16)),
        ((14, 2, torch.float32, True), (14, 144, 16)),
        ((14, 3, torch.float32, False), (14, 144, 8)),
        ((14, 3, torch.bfloat16, True), (14, 144, 16)),
        ((18, 2, torch.float32, True), (24, 176, 16)),
        ((18, 3, torch.float32, True), (32, 176, 8)),
        ((32, 2, torch.float32, False), (32, 176, 16)),
        ((10, 2, torch.float64, True), (32, 144, 8)),
    ]
    for N in (4096, 2048):
        for (m, ns, dtype, planes), (mt, xh, qh) in cases:
            geo = level2._level2_geometry(1, N, N, m, dtype, planes, ns)
            acc = 8 if dtype == torch.float64 else 4
            assert (geo.mt, geo.xh, geo.qh, geo.tq, geo.xw) == (
                mt, xh, qh, 64, 256 + 2 * m)
            assert geo.g == (2 if dtype == torch.float64 else 4)
            assert geo.grid == (N // 256, N // (4 * qh), 1)
            assert geo.grid[0] * geo.grid[1] >= 132
            assert geo.smem == acc * (ns * 4 * qh * xh
                                      + (0 if planes else z))
            assert 2 * (geo.smem + 1024) <= 233472 < 2 * (
                acc * (ns * 8 * qh * xh + (0 if planes else z)) + 1024) \
                or qh == 16
            assert geo.vlo and geo.vpl == planes
            rows = 4 * qh
            interior = sum(1 for by in range(geo.grid[1])
                           if by * rows + 2 - m >= 0
                           and by * rows + rows + m - 3 < N)
            assert interior == geo.grid[1] - 2      # only the first and last
    # small images take shorter tiles, to give every SM a block
    assert [level2._level2_geometry(1, n, n, 10, torch.float32, True).qh
            for n in (2048, 1024, 512)] == [16, 4, 4]
    for C, vlo, vpl in ((12, False, False), (260, False, False),
                        (264, True, True), (8, True, True),
                        (1036, False, False), (1040, True, True)):
        geo = level2._level2_geometry(1, 8, C, 10, torch.float32, True)
        assert (geo.vlo, geo.vpl) == (vlo, vpl), C
