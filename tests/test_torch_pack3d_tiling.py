"""The tiling of the 3-D analysis kernels ``fwd_level1_pack`` and
``fwd_level2_pack`` (``csrc/fpack.cuh`` ``fwd_pack_kernel``), replayed on the
CPU in numpy at float64.

The kernel cannot run here, so this replays, block by block, what
``ops/hwtile.py``'s ``_hw22_tap_bound`` and ``_fwd_pack_geometry`` tell it
to do, in the kernel's order, for each block (a depth-slice pair's depth
branch and a 32 x 32 output tile): the row and column maps folded once per
block; then for each of the branch's two slices in turn the cells each
staging item copies into the one staged slice (16-byte chunks where the
map runs on in order, else a cell at a time), the W stage's register
windows (4 outputs of a staged row from one window shifted by dl, feeding
both W branches; level 2's parities split, taps by parity, the swap
placing each parity's sum) and the W-stage images it writes, the second
slice's copies overwriting the staged slice before the first slice's H
stage, and the H stage's windows down a column (4 output rows of a
thread's column, feeding both H branches); after the second slice, the
exchange of a lane pair (``__shfl_xor_sync``) that gives each lane the 8
corners of its band location, and each lane's stores: the LLL as
2-vectors, the subband planes one value a lane, the interleaved subbands
through each warp's [32][8] restage with its XOR swizzle, whose 16-byte
phases must hit distinct banks.
Every staged, W-stage or restaged cell read must have been written, every
output element written exactly once, and the outputs must equal the plain
version (:func:`fwd_level1_pack_reference`,
:func:`fwd_level2_pack_reference`) within 1e-12.  Edit the replay together
with the kernel.
"""

import numpy as np
import pytest
import torch

from dtcwt_tpu_torch.coeffs import biort, qshift
from dtcwt_tpu_torch.ops import _build, fb, hwtile, pack3d
from dtcwt_tpu_torch.ops.level2 import dfilt_streams

_THREADS = 256
_TILE = 32


def _reflect(j, n):
    """reflect() of csrc/common.cuh: symmetric reflection with repeated
    ends, folded as often as needed."""
    t = np.mod(j, 2 * n)
    return np.where(t < n, t, 2 * n - 1 - t)


def _fold(j, n):
    """fold() of csrc/common.cuh: the index itself inside the axis, one
    reflection where that lands inside, else reflect()."""
    f = np.where(j < 0, -1 - j, 2 * n - 1 - j)
    return np.where((j >= 0) & (j < n), j,
                    np.where((f >= 0) & (f < n), f, _reflect(j, n)))


class _Img:
    """A shared image filled with NaN whose writes are counted: a cell
    read before it is written reads NaN, which fails the read."""

    def __init__(self, n):
        self.v = np.full(n, np.nan)
        self.n = np.zeros(n, np.int64)

    def put(self, idx, val):
        idx = np.asarray(idx).reshape(-1)
        np.add.at(self.n, idx, 1)
        self.v[idx] = np.asarray(val).reshape(-1)

    def get(self, idx):
        val = self.v[idx]
        assert not np.isnan(val).any(), "a cell read before it was written"
        return val


def _slot(l, v, np_):
    """fwd_slot(): piece v of row l in a warp's restage."""
    return v ^ ((l // (8 // np_)) & (np_ - 1))


def _oct_n(i, j, k):
    """oct_n() of csrc/fpack.cuh: the band order of octant (i, j, k)."""
    return 3 + 2 * i + j if k else 2 * i + j - 1


def _distinct_phases(cells, acc):
    """The 16-byte accesses of a warp instruction (cells [32], the first
    value of each) in phases of 8 lanes: each phase on distinct banks."""
    groups = (np.asarray(cells) * acc // 16) % 8
    return all(len(set(g)) == 8 for g in groups.reshape(4, 8))


def _replay(lo, hi, plans, P, geo, planes, dtype):
    """Run the kernel's index arithmetic on the branch volumes *lo*, *hi*
    [B, Dn, H, W]; return (lll [B, Dn, Ho, Wo], the subbands: the (re, im)
    planes [2, B, 28, Dn/2, Ho/2, Wo/2] or the interleaved real pairs
    [B, Dn/2, Ho/2, Wo/2, 28, 2]) and assert every write lands once."""
    B, Dn, H, W = lo.shape
    Ho, Wo = H // P, W // P
    g = geo.hw
    mt, ph, so, dl = g.mt, g.ph, g.so, g.dl
    X, xs_, ns, nw, cw = g.xr, g.xs, g.ns, g.nw, g.cw
    acc = 8 if dtype == torch.float64 else 4
    vv = 16 // acc              # values a 16-byte vector
    np_ = 8 // vv               # 16-byte pieces of an octant
    # the tile the C side accepts (launch_tiles, FpGeo): hw22's slice and
    # the restage
    assert (g.oh, g.ow) == (_TILE, _TILE) and g.xc == X
    assert ph == (mt - 1) // 2 and so % 4 == 0 and so == dl + P * ph
    assert 0 <= dl < 4 and X == P * _TILE + 2 * so and X % 4 == 0
    assert xs_ % 4 == 0 and (P == 1 and xs_ == X or P == 2 and xs_ % 8 == 4)
    assert ns == (mt + 3 if P == 1 else 2 * mt + 4) and nw % vv == 0
    assert dl + ns <= nw < dl + ns + vv and 4 * P * 7 + nw <= X
    assert cw == vv and X % cw == 0
    assert geo.rs == (0 if planes else 8 * _THREADS)
    assert geo.smem == acc * (X * xs_ + 2 * X * _TILE + geo.rs) + 8 * X
    assert geo.smem <= 220 * 1024 and geo.smem <= _build.SMEM_LIMIT
    assert geo.tile() == (32, 32, mt, X, X, geo.smem)
    T, sw = hwtile._inv_taps(plans, P, mt)
    if P == 2:
        # taps by parity: stream s reads the parity s ^ sw
        T = np.stack([T[k][[sw[k], 1 - sw[k]]] for k in range(2)])
    Dh, Hb, Wb = Dn // 2, Ho // 2, Wo // 2
    n_th, n_tw = -(-Ho // _TILE), -(-Wo // _TILE)
    lll = np.zeros(B * Dn * Ho * Wo)
    nl = np.zeros(lll.size, np.int64)
    nbands = B * 28 * Dh * Hb * Wb
    bands = np.zeros((2, nbands)) if planes else np.zeros(2 * nbands)
    nb = np.zeros(bands.shape, np.int64)
    tid = np.arange(_THREADS)
    rg, lane = tid >> 5, tid & 31
    col, e = lane, lane & 1
    vec = W % cw == 0           # rows and inputs aligned to a chunk

    def fir(w, T_b):
        """4 outputs of one branch from windows w [items, >= ns] that
        start at the windows' shift dl."""
        a = np.zeros((w.shape[0], 4))
        for m in range(mt):
            if P == 1:
                a += T_b[0, m] * w[:, m:m + 4]
            else:
                for p in range(2):
                    for gg in range(2):
                        a[:, 2 * gg + p] += (T_b[p, m]
                                             * w[:, 4 * gg + p + 2 * m])
        return a

    def place(a, s):
        """Parity p holds stream p ^ s: output 2 gg + (p ^ s)."""
        return a[:, [1, 0, 3, 2]] if P == 2 and s else a

    def stage(xs, img, rmap, cmap):
        """hs_stage of one slice into the staged image *xs*, row-major:
        chunks of cw cells where the map runs on in order from an aligned
        sample, else a cell at a time; every cell written once."""
        xs.n[:] = 0
        if vec:
            it = np.arange(X * (X // cw))
            r, c = np.divmod(it, X // cw)
            c = c * cw
            run = ((cmap[c + cw - 1] == cmap[c] + cw - 1)
                   & (cmap[c] % cw == 0))
            assert ((r * xs_ + c) % cw == 0).all()
            r = np.repeat(r, cw)
            c = (c[:, None] + np.arange(cw)).reshape(-1)
            src = np.where(np.repeat(run, cw),
                           np.repeat(cmap[c[::cw]], cw)
                           + np.tile(np.arange(cw), run.size), cmap[c])
        else:
            r, c = np.divmod(np.arange(X * X), X)
            src = cmap[c]
        xs.put(r * xs_ + c, img[rmap[r], src])
        assert (xs.n[xs.n > 0] == 1).all()

    def wstage(xs):
        """ha_wstage: item (r, q), outputs 4 q .. 4 q + 3 of staged row r
        from one window of nw values feeding both W branches."""
        it = np.arange(X * 8)
        if P == 1:
            q, r = it & 7, it >> 3
        else:
            q = (it & 3) | (it >> 1 & 4)
            r = (it >> 4) * 2 + (it >> 2 & 1)
        assert sorted(zip(r, q)) == [(a, b) for a in range(X)
                                     for b in range(8)]
        start = r * xs_ + 4 * P * q
        assert (start % vv == 0).all()
        w = xs.get(start[:, None] + np.arange(nw))
        vw = [_Img(X * _TILE) for _ in range(2)]
        for k in range(2):
            a = place(fir(w[:, dl:], T[k]), sw[k] if P == 2 else 0)
            o = r * _TILE + 4 * q
            assert (o % vv == 0).all()
            vw[k].put(o[:, None] + np.arange(4), a)
            assert (vw[k].n == 1).all()
        return vw

    def hstage(vw):
        """ha_hcol for each W branch k: thread (rg, col), output rows
        4 rg + v of column col of u[j][k], a window down the column (lanes
        on consecutive columns) feeding both j: [k][j][thread][v]."""
        out = np.zeros((2, 2, _THREADS, 4))
        for k in range(2):
            idx = (4 * P * rg[:, None] + dl + np.arange(ns)) * _TILE + \
                col[:, None]
            assert (np.diff(idx.reshape(8, 32, ns), axis=1) == 1).all()
            w = vw[k].get(idx)
            for j in range(2):
                out[k, j] = place(fir(w, T[j]), sw[j] if P == 2 else 0)
        return out

    # a block for each (b, u, depth branch i, tile), the blocks' order
    # (blockIdx: tile column fastest, then tile row, branch, u, b)
    blocks = [(b, u, i, th, tw) for b in range(B) for u in range(Dh)
              for i in range(2) for th in range(n_th) for tw in range(n_tw)]
    for b, u, i, th, tw in blocks:
        o0r, o0c = th * _TILE, tw * _TILE
        rs, cs = P * o0r - so, P * o0c - so
        assert rs % 4 == 0 and cs % 4 == 0   # aligned, even
        rmap = _fold(rs + np.arange(X), H)
        cmap = _fold(cs + np.arange(X), W)
        assert (rmap == _reflect(rs + np.arange(X), H)).all()
        assert (cmap == _reflect(cs + np.arange(X), W)).all()
        # the branch's slices 2 u and 2 u + 1
        br = (lo, hi)[i][b, 2 * u:2 * u + 2]
        # this lane's band location and its validity
        p = o0r // 2 + 2 * rg + e
        q = o0c // 2 + (lane >> 1)
        inn = (p < Hb) & (q < Wb)
        xs = _Img(X * xs_)
        stage(xs, br[0], rmap, cmap)
        vw = wstage(xs)
        # slice 1's copies land during slice 0's H stage, which reads the
        # W-stage images only
        stage(xs, br[1], rmap, cmap)
        a0 = hstage(vw)
        a1 = hstage(wstage(xs))
        for k in range(2):
            for j in range(2):
                _octant(i, j, k, a0[k, j], a1[k, j], b, u, o0r, o0c, p, q,
                        inn, Dn, Ho, Wo, planes, acc, vv, np_, lll, nl,
                        bands, nb)
    assert (nl == 1).all(), "LLL elements written %s times" % set(nl)
    assert (nb == 1).all(), "subband elements written %s times" % set(
        nb.reshape(-1))
    lll = lll.reshape(B, Dn, Ho, Wo)
    if planes:
        return lll, bands.reshape(2, B, 28, Dh, Hb, Wb)
    return lll, bands.reshape(B, Dh, Hb, Wb, 28, 2)


def _octant(i, j, k, x0, x1, b, u, o0r, o0c, p, q, inn, Dn, Ho, Wo, planes,
            acc, vv, np_, lll, nl, bands, nb):
    """Octant (i, j, k) from depth parity 0's sums *x0* and parity 1's
    *x1* [thread][v]: the lane pairs' exchange, then the LLL's 2-vectors,
    the planes or the restage and its pieces."""
    tid = np.arange(_THREADS)
    rg, lane, e = tid >> 5, tid & 31, tid & 1
    Dh, Hb, Wb = Dn // 2, Ho // 2, Wo // 2
    # corners [c][hp] at column parity 0 (w0) and 1 (w1): the lane's own
    # column, and its partner's (lane ^ 1) through the shuffle
    w0 = np.zeros((2, 2, _THREADS))
    w1 = np.zeros((2, 2, _THREADS))
    for c, x in enumerate((x0, x1)):
        for hp in range(2):
            top, bot = x[:, hp], x[:, 2 + hp]
            own = np.where(e == 1, bot, top)
            sent = np.where(e == 1, top, bot)
            other = sent[tid ^ 1]
            w0[c, hp] = np.where(e == 1, other, own)
            w1[c, hp] = np.where(e == 1, own, other)
    if (i, j, k) == (0, 0, 0):
        for c in range(2):
            for hp in range(2):
                off = ((b * Dn + 2 * u + c) * Ho + 2 * p + hp) * Wo + 2 * q
                assert (off % 2 == 0).all()            # a 2-vector
                for wp, w in enumerate((w0, w1)):
                    np.add.at(nl, off[inn] + wp, 1)
                    lll[off[inn] + wp] = w[c, hp][inn]
        return
    n = _oct_n(i, j, k)
    assert pack3d._OCTANTS[n] == (i, j, k)
    cA, cB, cC, cD = w0[0, 0], w0[0, 1], w0[1, 0], w0[1, 1]
    cE, cF, cG, cH = w1[0, 0], w1[0, 1], w1[1, 0], w1[1, 1]
    re = [(cA - cG - cD - cF) / 2, (cA - cG + cD + cF) / 2,
          (cA + cG + cD - cF) / 2, (cA + cG - cD + cF) / 2]
    im = [(cB - cH + cC + cE) / 2, (-cB + cH + cC + cE) / 2,
          (cB + cH - cC + cE) / 2, (-cB - cH - cC + cE) / 2]
    if planes:
        for m in range(4):
            off = (((b * 28 + 4 * n + m) * Dh + u) * Hb + p) * Wb + q
            # a warp's store: 16 consecutive band locations of two rows
            o = off.reshape(8, 32)
            assert (np.diff(o[:, 0::2], axis=1) == 1).all()
            assert (np.diff(o[:, 1::2], axis=1) == 1).all()
            for a, v in ((0, re[m]), (1, im[m])):
                np.add.at(nb[a], off[inn], 1)
                bands[a, off[inn]] = v[inn]
        return
    z = np.stack([v for m in range(4) for v in (re[m], im[m])], -1)
    # every lane restages its location's 8 values in row `lane` of its
    # warp's [32][8] (warp rg at 256 rg), 16-byte phases on distinct banks
    ws = _Img(8 * 32 * 8)
    for v in range(np_):
        cell = 8 * lane + vv * _slot(lane, v, np_)
        assert _distinct_phases(cell[:32], acc)
        for t in range(vv):
            ws.put(256 * rg + cell + t, z[:, v * vv + t])
    assert (ws.n == 1).all()
    # then each lane stores np_ pieces: piece kk = 32 v + lane, row
    # kk // np_ (that lane's location), part kk % np_
    for v in range(np_):
        kk = 32 * v + lane
        r, part = kk // np_, kk % np_
        cell = 8 * r + vv * _slot(r, part, np_)
        assert _distinct_phases(cell[:32], acc)
        lp = o0r // 2 + 2 * rg + (r & 1)
        lq = o0c // 2 + (r >> 1)
        ok = (lp < Hb) & (lq < Wb)
        off = (((b * Dh + u) * Hb + lp) * Wb + lq) * 56 + 8 * n + vv * part
        assert (off % vv == 0).all()                  # a 16-byte piece
        for t in range(vv):
            np.add.at(nb, off[ok] + t, 1)
            bands[off[ok] + t] = ws.get((256 * rg + cell + t)[ok])


def _case(level, fam):
    """(filters in the call order, plans, P, reference entry, depth
    stage); "long" a random pair of the longest lengths the kernel takes
    (odd filters of 31 taps, qshift pairs of 32)."""
    rs = np.random.RandomState(5)
    if level == 1:
        if fam == "long":
            f = (rs.randn(31), rs.randn(31))
        else:
            bo = biort(fam)
            f = (bo[0], bo[2])
        return (f, pack3d._filter_plans(*f), 1,
                pack3d.fwd_level1_pack_reference,
                lambda x: fb.filter2_axis(x, *f, -3))
    if fam == "long":
        f = ((rs.randn(32), rs.randn(32)), (rs.randn(32), rs.randn(32)))
    else:
        qs = qshift(fam)
        f = ((qs[1], qs[0]), (qs[5], qs[4]))
    return (f, [dfilt_streams(*p) for p in f], 2,
            pack3d.fwd_level2_pack_reference,
            lambda x: fb.dfilt2_axis(x, *f, -3))


# (dtype, planes): the f32 interleaved, f32 / bf16 planes (one geometry)
# and f64 geometries
_KINDS = [(torch.float32, False), (torch.float32, True),
          (torch.float64, False), (torch.float64, True)]
# [B, D, H, W] volumes a level reads: tiles crossed both ways with the last
# one partial, band rows ending inside a warp's run (W / 2 = 22, 34), rows
# not a multiple of the staging chunk (W = 10), H and W shorter than the
# longer filters, a batch
_SHAPES = {1: [(1, 2, 36, 44), (2, 4, 6, 10), (1, 2, 66, 68)],
           2: [(1, 4, 8, 12), (1, 4, 72, 136), (2, 4, 36, 20)]}
# each tap bound of both levels' instance sets, and the mt it takes
_FAMS = {(1, "legall"): 5, (1, "near_sym_a"): 7, (1, "antonini"): 9,
         (1, "near_sym_b"): 19, (1, "long"): 31, (2, "qshift_a"): 10,
         (2, "qshift_b"): 14, (2, "qshift_c"): 16, (2, "qshift_d"): 18,
         (2, "qshift_32"): 32}


@pytest.mark.parametrize("shape_no", range(3))
@pytest.mark.parametrize("level,fam", sorted(_FAMS))
def test_fwd_pack_tiling_replay(level, fam, shape_no):
    """Each block's reads and writes for the f32 (interleaved and planes)
    and f64 geometries at the family's tap bound, against the plain version
    at float64."""
    shape = _SHAPES[level][shape_no]
    f, plans, P, ref, depth = _case(level, fam)
    mt = hwtile._hw22_tap_bound(plans, P)
    assert mt == _FAMS[(level, fam)]
    x = torch.from_numpy(np.random.RandomState(sum(shape) + level).rand(
        *shape))
    lo, hi = (v.numpy() for v in depth(x))
    for dtype, planes in _KINDS:
        want_lll, want = ref(x, *f, planes=planes)
        geo = hwtile._fwd_pack_geometry(P, mt, dtype, planes)
        lll, bands = _replay(lo, hi, plans, P, geo, planes, dtype)
        np.testing.assert_allclose(lll, want_lll.numpy(), rtol=0,
                                   atol=1e-12)
        if planes:
            for a in range(2):
                np.testing.assert_allclose(bands[a], want[a].numpy(), rtol=0,
                                           atol=1e-12)
        else:
            np.testing.assert_allclose(
                bands, torch.view_as_real(want).numpy(), rtol=0, atol=1e-12)


def test_fwd_pack_geometry_main_path():
    """The main path's tiles (256^3 at 3 levels: level 1 near_sym_a on
    256^2 slices, level 2 qshift_a on 128^2 and 64^2 outputs): hw22's slice
    geometry at the tap bound (7, 10) and the restage, whose shared memory
    leaves an SM eight blocks of level 1 and four of level 2 in float32
    (the first design's tile: five and two); the registers set four of
    each (PERF.md).  A block for each depth branch of each depth-slice pair
    and tile.  Every instance fits, float64 at the largest bounds too."""
    sm = 233472                    # an H100 SM; 1 KB of it a block's
    for level, fam, mt, smem, blocks in ((1, "near_sym_a", 7, 25152, 8),
                                         (2, "qshift_a", 10, 56192, 4)):
        _, plans, P, _, _ = _case(level, fam)
        assert hwtile._hw22_tap_bound(plans, P) == mt
        inter = hwtile._fwd_pack_geometry(P, mt, torch.float32, False)
        pl = hwtile._fwd_pack_geometry(P, mt, torch.float32, True)
        assert (inter.rs, inter.smem) == (2048, smem)
        assert (pl.rs, pl.smem) == (0, smem - 8192)
        assert inter.hw == pl.hw == hwtile._hw22_geometry(P, mt,
                                                          torch.float32)
        assert min(2048 // _THREADS, sm // (inter.smem + 1024)) == blocks
        assert inter.tile() == (32, 32, mt, inter.hw.xr, inter.hw.xr, smem)
    # blocks a launch: the B Dn / 2 depth-slice pairs' two depth branches,
    # each over the 32 x 32 output tiles
    for Dn, Ho, blocks in ((256, 256, 256 * 8 * 8), (128, 128, 128 * 4 * 4),
                           (64, 64, 64 * 2 * 2)):
        assert Dn // 2 * 2 * (-(-Ho // _TILE)) ** 2 == blocks
    for P in (1, 2):
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            for planes in (False, True):
                geo = hwtile._fwd_pack_geometry(
                    P, hwtile._HW_BOUNDS[P][-1], dtype, planes)
                assert geo.smem <= 220 * 1024
    geo = hwtile._fwd_pack_geometry(2, 32, torch.float64, False)
    assert geo.smem == 218112      # 213 KB: hw22's 197 and the restage


def test_fwd_pack_octant_order():
    """oct_n() of csrc/fpack.cuh against the transform's octant order, and
    the taps the wrapper plans at each level's bound against the plain
    plans' (every tap in place, zeros elsewhere)."""
    for n, (i, j, k) in enumerate(pack3d._OCTANTS):
        assert _oct_n(i, j, k) == n
    for (level, fam), mt in _FAMS.items():
        _, plans, P, _, _ = _case(level, fam)
        T, _ = hwtile._inv_taps(plans, P, mt)
        for bi, (taps, _) in enumerate(plans):
            np.testing.assert_array_equal(np.sort(T[bi][T[bi] != 0]),
                                          np.sort(taps[taps != 0]))
        smaller = [bd for bd in hwtile._HW_BOUNDS[P] if bd < mt]
        assert all(hwtile._inv_taps(plans, P, bd) is None for bd in smaller)
