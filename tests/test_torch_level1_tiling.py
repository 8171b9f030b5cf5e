"""The tiling of the ``fwd_level1`` kernel (``csrc/level1.cu``), replayed on
the CPU in numpy at float64.

The kernel cannot run here, so this replays, block by block, what
``ops/level1.py:_level1_geometry`` tells it to do: which input samples each
column-stage item loads (after reflection), which shared-memory cells it
writes and the row stage reads, and which output elements each row-stage
item stores, at which flat offsets and with which vector widths.  Every
lowpass and subband element must be written exactly once and equal
:func:`fwd_level1_reference`; every shared cell the row stage reads must
have been written.  Edit the replay together with the kernel.
"""

import numpy as np
import pytest
import torch

from dtcwt_tpu_torch.ops import _build, level1
from dtcwt_tpu_torch.transforms.pyramid import PLANE_BAND_ORDER

_S = np.sqrt(0.5)


def _fold(j, n):
    """reflect() of csrc/common.cuh (the kernel's one-fold test reduces to
    it): symmetric reflection with repeated ends, folded as often as
    needed."""
    t = np.mod(j, 2 * n)
    return np.where(t < n, t, 2 * n - 1 - t)


def _centred(filters, p, mt):
    """The kernel's L1Taps: reversed taps centred on the halo p (zero
    outside each filter's range, which the replay sums over)."""
    tp = np.zeros((3, mt))
    rng = []
    for s, h in enumerate(filters):
        m = h.size
        tp[s, p - m // 2:p - m // 2 + m] = h[::-1]
        rng.append(range(p - m // 2, p + m // 2 + 1))
    return tp, rng


def _q2c(a, b, c, d):
    return (a - d) * _S, (b + c) * _S, (a + d) * _S, (b - c) * _S


def _replay(x, filters, geo, planes, acc):
    """Run the kernel's index arithmetic on *x* [B, R, C]; return the
    outputs (lolo, and the interleaved [B, h, w, 6] complex or the planes)
    and assert every write lands once."""
    B, R, C = x.shape
    h, w = R // 2, C // 2
    th, tw, rv, p, mt, xws = geo.th, geo.tw, geo.rv, geo.p, geo.mt, geo.xws
    assert geo.grid == (-(-C // tw), -(-R // th), B)
    ns = len(filters)
    mm = 2 * p + 1
    assert mm <= mt and xws % 4 == 0 and xws >= tw + 2 * p
    assert geo.smem == acc * (ns * th * xws + (0 if planes else 256 * 24))
    vn = 16 // acc            # interleaved pieces: 16 bytes
    tp, rng = _centred(filters, p, mt)
    lolo = np.zeros(B * R * C)
    nlo = np.zeros(B * R * C, np.int64)
    nb = B * h * w * 12 if not planes else B * 6 * h * w
    za, zb = np.zeros(nb), np.zeros(nb)
    na = np.zeros(nb, np.int64)
    xw = tw + 2 * p
    xf = x.reshape(B, R * C)
    for b in range(B):
        for by in range(geo.grid[1]):
            for bx in range(geo.grid[0]):
                r0, c0 = by * th, bx * tw
                st = np.full((ns, th, xws), np.nan)
                # column stage
                it = np.arange(th // rv * xw)
                g, lc = it // xw, it % xw
                gc = _fold(c0 - p + lc, C)
                rs = r0 + g * rv - p
                rows = rs[:, None] + np.arange(rv + mm - 1)[None, :]
                if r0 - p >= 0 and r0 + th + p <= R:   # rows_in: no reflect
                    assert rows.min() >= 0 and rows.max() < R
                else:
                    rows = _fold(rows, R)
                smp = xf[b][rows * C + gc[:, None]]
                for s in range(ns):
                    col = np.zeros((it.size, rv))
                    for k in rng[s]:
                        col += tp[s, k] * smp[:, k:k + rv]
                    dst = st[s][(g * rv)[:, None] + np.arange(rv), lc[:, None]]
                    assert np.isnan(dst).all()         # written once
                    st[s][(g * rv)[:, None] + np.arange(rv),
                          lc[:, None]] = col
                # row stage; a warp (quad row) is skipped only below R
                it = np.arange(th // 2 * (tw // 4))
                qi, gg = it >> 5, it & 31
                r, c = r0 + 2 * qi, c0 + 4 * gg
                keep = r < R
                qi, gg, r, c = qi[keep], gg[keep], r[keep], c[keep]
                if not r.size:
                    continue
                win = 4 * gg[:, None] + np.arange(4 + mm - 1)
                assert win.max() < xws
                y = np.zeros((4, 2, r.size, 4))
                for dr in range(2):
                    wins = [st[s][(2 * qi + dr)[:, None], win]
                            for s in range(ns)]
                    assert not any(np.isnan(v).any() for v in wins)

                    def fir(v, s):
                        return sum(tp[s, k] * v[:, k:k + 4] for k in rng[s])
                    y[0, dr] = fir(wins[0], 0)
                    y[2, dr] = fir(wins[0], 1)
                    y[1, dr] = fir(wins[1], 0)
                    y[3, dr] = fir(wins[2], 2) if ns == 3 else fir(wins[1], 1)
                nc = np.clip(C - c, 0, 4)
                for dr in range(2):
                    off = (b * R + r + dr) * C + c
                    vec = geo.vlo & (nc == 4)
                    assert (off[vec] % 4 == 0).all()
                    for v in range(4):
                        m = v < nc
                        np.add.at(nlo, off[m] + v, 1)
                        lolo[off[m] + v] = y[0, dr, m, v]
                i = r // 2
                band = np.zeros((2, 2, 6, r.size))     # quad, re/im, degree
                for q in range(2):
                    u = 2 * q
                    for img, (d0, d1) in ((1, (0, 5)), (2, (2, 3)),
                                          (3, (1, 4))):
                        r0_, i0_, r1_, i1_ = _q2c(
                            y[img, 0, :, u], y[img, 0, :, u + 1],
                            y[img, 1, :, u], y[img, 1, :, u + 1])
                        band[q, 0, d0], band[q, 1, d0] = r0_, i0_
                        band[q, 0, d1], band[q, 1, d1] = r1_, i1_
                if planes:
                    j, nq = c // 2, nc // 2
                    for d in range(6):
                        off = ((b * 6 + PLANE_BAND_ORDER.index(d)) * h
                               + i) * w + j
                        vec = geo.vpl & (nq == 2)
                        assert (off[vec] % 2 == 0).all()
                        for q in range(2):
                            m = q < nq
                            np.add.at(na, off[m] + q, 1)
                            za[off[m] + q] = band[q, 0, d, m]
                            zb[off[m] + q] = band[q, 1, d, m]
                    continue
                # interleaved: each warp stages zs[24 g + t] = value t % 12
                # of quad t // 12 (re, im alternating), then lane g stores
                # pieces e * 32 + g of vn values where inside its 64 quads
                quads = min(w - c0 // 2, 64)
                nw = r.size // 32                    # whole warps
                assert (gg.reshape(nw, 32) == np.arange(32)).all()
                t = np.arange(24)
                zs = np.zeros((nw, 768))
                zs[:, 24 * np.arange(32)[:, None] + t] = band[
                    t // 12, t % 12 % 2, t % 12 // 2, :].T.reshape(nw, 32, 24)
                base = ((b * h + i[::32]) * w + c0 // 2) * 12
                assert (base % vn == 0).all()
                src = (np.arange(24 // vn)[:, None] * 32 + np.arange(32)) * vn
                src = (src[..., None] + np.arange(vn)).reshape(-1)
                src = src[src < quads * 12]
                # stored values come from lanes inside the row
                assert (c0 + 4 * (src // 24) < C).all()
                dst = (base[:, None] + src).reshape(-1)
                np.add.at(na, dst, 1)
                za[dst] = zs[:, src].reshape(-1)
    assert (nlo == 1).all(), "lowpass elements written %s times" % set(nlo)
    assert (na == 1).all(), "subband elements written %s times" % set(na)
    lolo = lolo.reshape(B, R, C)
    if planes:
        return lolo, (za.reshape(B, 6, h, w), zb.reshape(B, 6, h, w))
    z = za.reshape(B, h, w, 6, 2)
    return lolo, z[..., 0] + 1j * z[..., 1]


def _filters(lengths, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(m) for m in lengths]


_SHAPES = [(1, 4, 6), (1, 36, 52), (1, 130, 200), (1, 518, 390),
           (1, 2, 4098), (3, 130, 200)]
_LENGTHS = [(1, 1), (5, 7), (7, 5), (13, 19), (31, 5), (13, 19, 19),
            (1, 7, 31), (21, 3)]
_KINDS = [(torch.float32, False), (torch.bfloat16, True),
          (torch.float64, False), (torch.float64, True)]


@pytest.mark.parametrize("lengths", _LENGTHS)
@pytest.mark.parametrize("shape", _SHAPES)
def test_level1_tiling_replay(shape, lengths):
    """Each block's reads and writes, at every shape and filter set, for the
    float32 interleaved, bfloat16 planes and float64 geometries, against
    the plain version at float64."""
    x = np.random.RandomState(sum(shape)).rand(*shape)
    filt = _filters(lengths, len(lengths) * 100 + lengths[-1])
    h2o = filt[2] if len(filt) == 3 else None
    want = level1.fwd_level1_reference(torch.from_numpy(x), filt[0], filt[1],
                                       False, h2o)
    want_pl = level1.fwd_level1_reference(torch.from_numpy(x), filt[0],
                                          filt[1], True, h2o)
    B, R, C = shape
    for dtype, planes in _KINDS:
        if (shape[1] * shape[2] > 100000 and dtype == torch.float64
                and planes):
            continue          # the f64 geometry is already replayed once
        geo = level1._level1_geometry(B, R, C, max(lengths), dtype, planes,
                                      len(lengths))
        acc = 8 if dtype == torch.float64 else 4
        lo, bands = _replay(x, filt, geo, planes, acc)
        ref = want_pl if planes else want
        np.testing.assert_allclose(lo, ref[0].numpy(), rtol=0, atol=1e-12)
        if planes:
            for got, exp in zip(bands, ref[1]):
                np.testing.assert_allclose(got, exp.numpy(), rtol=0,
                                           atol=1e-12)
        else:
            np.testing.assert_allclose(bands, ref[1].numpy(), rtol=0,
                                       atol=1e-12)


def test_level1_geometry_main_path():
    """The 4096^2 main path's tilings: footprint, interior blocks (no row
    reflection) and shared memory, for near_sym_a (5/7 taps), near_sym_b
    (13/19) and near_sym_b_bp (13/19/19), float32 / bfloat16 and float64."""
    N = 4096
    z = 256 * 24             # the interleaved layout's staging, elements
    cases = [  # (m_max, streams, dtype, planes) -> (th, mt, smem)
        ((7, 2, torch.float32, False), (32, 8, 4 * (2 * 32 * 136 + z))),
        ((7, 2, torch.float32, True), (32, 8, 4 * 2 * 32 * 136)),
        ((7, 2, torch.bfloat16, True), (64, 8, 4 * 2 * 64 * 136)),
        ((7, 2, torch.float64, True), (32, 8, 8 * 2 * 32 * 136)),
        ((13, 2, torch.float32, True), (32, 16, 4 * 2 * 32 * 140)),
        ((19, 2, torch.float32, False), (32, 24, 4 * (2 * 32 * 148 + z))),
        ((19, 2, torch.bfloat16, True), (32, 24, 4 * 2 * 32 * 148)),
        ((19, 3, torch.float32, False), (32, 24, 4 * (3 * 32 * 148 + z))),
        ((31, 3, torch.float64, False), (32, 32, 8 * (3 * 32 * 160 + z))),
    ]
    for (m, ns, dtype, planes), (th, mt, smem) in cases:
        geo = level1._level1_geometry(1, N, N, m, dtype, planes, ns)
        assert (geo.th, geo.tw, geo.rv, geo.mt, geo.smem) == (
            th, 128, 16, mt, smem)
        acc = 8 if dtype == torch.float64 else 4
        for rows in (32, 64):     # the tile heights the kernel takes
            alt = level1._level1_geometry(1, N, N, m, dtype, planes, ns,
                                          th=rows)
            assert alt.grid == (N // 128, N // rows, 1)
            assert alt.smem == smem + acc * ns * (rows - th) * geo.xws
        assert geo.grid == (N // 128, N // th, 1)
        assert geo.vlo and geo.vpl == planes
        assert geo.smem <= _build.SMEM_LIMIT
        assert 3 * geo.smem <= _build.SMEM_LIMIT or ns == 3 or \
            dtype == torch.float64
        interior = sum(1 for by in range(geo.grid[1])
                       if by * th - geo.p >= 0
                       and by * th + th + geo.p <= N)
        assert interior == geo.grid[1] - 2      # only the first and last
        # input read per output pixel, under a 16 x 64 tile's
        amp = (128 + 2 * geo.p) * (th + 2 * geo.p) / (128 * th)
        assert amp < (64 + 2 * geo.p) * (16 + 2 * geo.p) / (64 * 16)
    # vectors off where rows or planes are too short or odd
    for C, vlo, vpl in ((6, False, False), (202, False, False),
                        (518, False, False), (4098, False, False),
                        (4100, True, True), (200, True, True)):
        geo = level1._level1_geometry(1, 4, C, 7, torch.float32, True)
        assert (geo.vlo, geo.vpl) == (vlo, vpl), C
