"""The tiling of the 3-D synthesis kernels ``inv_level1_pack`` and
``inv_level2_pack`` (``csrc/ipack.cuh`` ``inv_pack_kernel``), replayed on
the CPU in numpy at float64.

The kernel cannot run here, so this replays, block by block, what
``ops/pack3d.py:_inv_pack_geometry`` tells it to do: the row and column
maps folded once per block; in each of the four rounds (i, j), which band
locations each staging item reads (through the maps, with the parity swap
where the reflected index is odd) and which staged cells it writes as
pairs (level 1 row-major, level 2 split by column parity), the LLL slice
pair a sample an item; the W stage's register windows (level 1: 4
outputs from MT + 3 samples; level 2: 8 outputs from two parity windows
of MT + 1) and where it writes its images (level 2 split by row parity);
the H stage's windows down a column; and which output elements each lane
stores.  Every staged cell must be written at most once a round, every
cell a stage reads must have been written in that round, every output
element written exactly once, and the outputs must equal the plain
version (:func:`inv_level1_pack_reference`,
:func:`inv_level2_pack_reference`).  Edit the replay together with the
kernel.
"""

import numpy as np
import pytest
import torch

from dtcwt_tpu_torch.coeffs import biort, qshift
from dtcwt_tpu_torch.ops import _build, fb, pack3d
from dtcwt_tpu_torch.ops.ilevel2 import ifilt_streams

_THREADS = 256
_TILE = 32


def _reflect(j, n):
    """reflect() of csrc/common.cuh."""
    t = np.mod(j, 2 * n)
    return np.where(t < n, t, 2 * n - 1 - t)


def _fold(j, n):
    """fold() of csrc/common.cuh."""
    f = np.where(j < 0, -1 - j, 2 * n - 1 - j)
    return np.where((j >= 0) & (j < n), j,
                    np.where((f >= 0) & (f < n), f, _reflect(j, n)))


def _c2cube8(z):
    """c2cube8() of csrc/ipack.cuh: z [..., 8] -> q [..., c, hp, wp]."""
    pr, pi, qr, qi, rr, ri, sr, si = np.moveaxis(z, -1, 0)
    q = np.empty(z.shape[:-1] + (2, 2, 2))
    q[..., 0, 0, 0] = (pr + qr + rr + sr) / 2
    q[..., 1, 0, 0] = (pi + qi - ri - si) / 2
    q[..., 0, 0, 1] = (pi + qi + ri + si) / 2
    q[..., 1, 0, 1] = (-pr - qr + rr + sr) / 2
    q[..., 0, 1, 0] = (pi - qi + ri - si) / 2
    q[..., 1, 1, 0] = (-pr + qr + rr - sr) / 2
    q[..., 0, 1, 1] = (-pr + qr - rr + sr) / 2
    q[..., 1, 1, 1] = (-pi + qi + ri - si) / 2
    return q


class _Img:
    """A shared image filled with NaN whose writes are counted: a cell
    read before it is written reads NaN, which the outputs show."""

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


def _replay(lll, bands, planes, plans, P, geo):
    """Run the kernel's index arithmetic on the lowpass *lll* [B, Dn, H, W]
    and the subbands (planes (re, im) [B, 28, Dn/2, H/2, W/2] or the
    interleaved real pairs [B, Dn/2, H/2, W/2, 28, 2]); return (U_0, U_1)
    [B, Dn, Ho, Wo] and assert every write lands once."""
    B, Dn, H, W = lll.shape
    Ho, Wo = (H, W) if P == 1 else (2 * H, 2 * W)
    mt, ph, X, xh, xs_ = geo.mt, geo.ph, geo.xr, geo.xh, geo.xs
    # the tile the C side accepts (run_inv_pack, inv_pack_mt, IpGeo)
    assert (geo.oh, geo.ow) == (_TILE, _TILE) and geo.xc == X
    assert X == (_TILE + mt - 1 if P == 1 else _TILE // 2 + 2 * mt - 2)
    assert X % 2 == 0 and ph == (mt - 1) // 2
    if P == 1:
        assert (xh, xs_) == (0, X)
        assert xs_ % 4 == 0                  # 16-byte rows of 4 floats
    else:
        assert xh >= X // 2 and xh % 8 == 4 and xs_ == 2 * xh
    assert geo.grid == (B, Dn // 2, -(-Ho // _TILE), -(-Wo // _TILE))
    T, sw = pack3d._inv_taps(plans, P, mt)
    nbc = X // 2
    nb = nbc * nbc
    xn = X * xs_
    out = np.zeros((2, B, Dn, Ho, Wo))
    nout = np.zeros(out.shape, np.int64)
    tid = np.arange(_THREADS)
    rg, col = tid >> 5, tid & 31

    def cell(r, c):
        """ip_cell(): staged cell (r, c) of one image."""
        if P == 1:
            return r * xs_ + c
        return r * xs_ + (c & 1) * xh + (c >> 1)

    def octant(b, u, y, x, n):
        """load_octant(): the 8 values of octant n at locations (y, x)."""
        if planes:
            re, im = bands
            z = np.stack([a[b, 4 * n + m, u, y, x] for m in range(4)
                          for a in (re, im)], -1)
        else:
            z = bands[b, u, y, x, 4 * n:4 * n + 4].reshape(y.shape + (8,))
        return z

    for b in range(B):
        for u in range(Dn // 2):
            for th in range(geo.grid[2]):
                for tw in range(geo.grid[3]):
                    o0r, o0c = th * _TILE, tw * _TILE
                    rs = o0r - ph if P == 1 else o0r // 2 - 2 * ph
                    cs = o0c - ph if P == 1 else o0c // 2 - 2 * ph
                    assert rs % 2 == 0 and cs % 2 == 0
                    rmap = _fold(rs + np.arange(X), H)
                    cmap = _fold(cs + np.arange(X), W)
                    assert (rmap == _reflect(rs + np.arange(X), H)).all()
                    assert (cmap == _reflect(cs + np.arange(X), W)).all()
                    for i in range(2):
                        acc = np.zeros((2, 4, _THREADS))  # [c][v][thread]
                        for J in range(2):
                            n0, n1 = 2 * i + J - 1, 3 + 2 * i + J
                            xs = [[_Img(xn) for c in range(2)]
                                  for k in range(2)]
                            if n0 < 0:
                                # the LLL pair, a sample an item
                                it = np.arange(2 * X * X)
                                c, rem = np.divmod(it, X * X)
                                r, cc = np.divmod(rem, X)
                                for c_ in range(2):
                                    s = c == c_
                                    xs[0][c_].put(
                                        cell(r[s], cc[s]),
                                        lll[b, 2 * u + c_, rmap[r[s]],
                                            cmap[cc[s]]])
                            # the band locations, an item each
                            it = np.arange(nb)
                            tb, tcb = np.divmod(it, nbc)
                            tr, tc = rmap[2 * tb], cmap[2 * tcb]
                            fr, fc = tr & 1, tc & 1
                            for k, n in ((0, n0), (1, n1)):
                                if n < 0:
                                    continue
                                q = _c2cube8(octant(b, u, tr >> 1, tc >> 1,
                                                    n))
                                for c_ in range(2):
                                    for hp in range(2):
                                        src = q[np.arange(nb), c_, hp ^ fr]
                                        a0 = src[np.arange(nb), fc]
                                        a1 = src[np.arange(nb), fc ^ 1]
                                        r = 2 * tb + hp
                                        if P == 1:
                                            base = r * xs_ + 2 * tcb
                                            # a pair: 8-byte aligned
                                            assert (base % 2 == 0).all()
                                            xs[k][c_].put(base, a0)
                                            xs[k][c_].put(base + 1, a1)
                                        else:
                                            xs[k][c_].put(r * xs_ + tcb, a0)
                                            xs[k][c_].put(
                                                r * xs_ + xh + tcb, a1)
                            for k in range(2):
                                for c_ in range(2):
                                    assert (xs[k][c_].n <= 1).all()
                            # W stage
                            vs = [_Img(X * _TILE) for c in range(2)]
                            if P == 1:
                                nw = mt + 3
                                it = np.arange(2 * X * 8)
                                q4, rr = it & 7, it >> 3
                                c, r = np.divmod(rr, X)
                                for c_ in range(2):
                                    s = c == c_
                                    a = np.zeros((s.sum(), 4))
                                    for k in range(2):
                                        start = r[s] * xs_ + 4 * q4[s]
                                        assert (start % 4 == 0).all()
                                        assert (4 * q4[s] + nw <= xs_).all()
                                        w = xs[k][c_].get(
                                            start[:, None] + np.arange(nw))
                                        for m in range(mt):
                                            a += T[k, 0, m] * w[:, m:m + 4]
                                    o = (r[s] * _TILE + 4 * q4[s])[:, None] \
                                        + np.arange(4)
                                    vs[c_].put(o, a)
                            else:
                                nw = mt + 1
                                it = np.arange(2 * X * 4)
                                q4, rr = it & 3, it >> 2
                                c, r = np.divmod(rr, X)
                                for c_ in range(2):
                                    s = c == c_
                                    a = np.zeros((s.sum(), 8))
                                    for k in range(2):
                                        row = r[s] * xs_ + 2 * q4[s]
                                        assert (2 * q4[s] + nw <= xh).all()
                                        win = [xs[k][c_].get(
                                            (row + p * xh)[:, None]
                                            + np.arange(nw))
                                            for p in (sw[k], 1 - sw[k])]
                                        for m in range(mt):
                                            for s4 in range(4):
                                                w = win[s4 & 1]
                                                for v in range(2):
                                                    a[:, 4 * v + s4] += \
                                                        T[k, s4, m] * \
                                                        w[:, v + m]
                                    o = (((r[s] & 1) * (X // 2)
                                          + (r[s] >> 1)) * _TILE
                                         + 8 * q4[s])[:, None] + np.arange(8)
                                    vs[c_].put(o, a)
                            for c_ in range(2):
                                assert (vs[c_].n <= 1).all()
                            # H stage: thread (rg, col), rows 4 rg + v
                            for c_ in range(2):
                                if P == 1:
                                    w = vs[c_].get(
                                        (4 * rg[:, None] + np.arange(mt + 3))
                                        * _TILE + col[:, None])
                                    for m in range(mt):
                                        acc[c_] += T[J, 0, m] * \
                                            w[:, m:m + 4].T
                                else:
                                    win = [vs[c_].get(
                                        (p * (X // 2) + rg[:, None]
                                         + np.arange(mt)) * _TILE
                                        + col[:, None])
                                        for p in (sw[J], 1 - sw[J])]
                                    for m in range(mt):
                                        for s4 in range(4):
                                            acc[c_, s4] += T[J, s4, m] * \
                                                win[s4 & 1][:, m]
                        # the stores: rows 4 rg + v of column col
                        for c_ in range(2):
                            for v in range(4):
                                gor, goc = o0r + 4 * rg + v, o0c + col
                                ok = (gor < Ho) & (goc < Wo)
                                np.add.at(nout[i, b, 2 * u + c_],
                                          (gor[ok], goc[ok]), 1)
                                out[i, b, 2 * u + c_, gor[ok], goc[ok]] = \
                                    acc[c_, v, ok]
    assert (nout == 1).all(), "outputs written %s times" % set(
        nout.reshape(-1))
    return out


def _case(level, fam):
    """(filters in the call order, plans, P, reference entry, the depth
    merge of the plain version)."""
    if level == 1:
        b = biort(fam)
        f = (b[1], b[3])
        return (f, pack3d._filter_plans(*f), 1,
                lambda a, c, ax: fb.filter2_sum_axis(a, c, *f, ax))
    q = qshift(fam)
    f = ((q[3], q[2]), (q[7], q[6]))
    return (f, [ifilt_streams(*p) for p in f], 4,
            lambda a, c, ax: fb.ifilt2_sum_axis(a, c, *f, ax))


def _stage_plain(lll, bands, merge):
    """U_0, U_1 of the plain version: the kernel's outputs before the
    depth stage."""
    octs = pack3d.unpack_octants(bands)
    octs[(0, 0, 0)] = lll
    return np.stack([merge(merge(octs[(i, 0, 0)], octs[(i, 0, 1)], -1),
                           merge(octs[(i, 1, 0)], octs[(i, 1, 1)], -1),
                           -2).numpy() for i in range(2)])


# [B, D, H, W] lowpass volumes a level reads: the card tests' shapes
# (level 2: half of each output volume), H or W shorter than the longest
# filters, and tiles partial in both H and W (level 1: 36 x 44 and 66 x
# 68 outputs; level 2: 36 x 68 and 72 x 40)
_SHAPES = {1: [(2, 4, 6, 10), (1, 6, 36, 44), (1, 2, 520, 6),
               (1, 2, 66, 68)],
           2: [(1, 2, 4, 6), (2, 4, 18, 10), (1, 2, 258, 4), (1, 2, 18, 34),
               (1, 2, 36, 20)]}
# (dtype, planes) geometries: f32 interleaved and planes (one tap bound
# set), f64 interleaved (the largest bound)
_KINDS = [(torch.float32, False), (torch.float32, True),
          (torch.float64, False)]


@pytest.mark.parametrize("level,fam", [
    (1, "near_sym_a"), (1, "near_sym_b"), (1, "antonini"),
    (2, "qshift_a"), (2, "qshift_d"), (2, "qshift_32")])
def test_inv_pack_tiling_replay(level, fam):
    """Each block's reads and writes for the f32 (interleaved and planes)
    and f64 geometries over every shape, against the plain version at
    float64."""
    f, plans, P, merge = _case(level, fam)
    for no, shape in enumerate(_SHAPES[level]):
        B, D, H, W = shape
        rs = np.random.RandomState(no + 10 * level)
        lll = torch.from_numpy(rs.rand(*shape))
        re = torch.from_numpy(rs.rand(B, 28, D // 2, H // 2, W // 2))
        im = torch.from_numpy(rs.rand(B, 28, D // 2, H // 2, W // 2))
        z = torch.complex(re, im).movedim(-4, -1).contiguous()
        want = _stage_plain(lll, (re, im), merge)
        Ho, Wo = (H, W) if P == 1 else (2 * H, 2 * W)
        for dtype, planes in _KINDS:
            mt = pack3d._inv_tap_bound(plans, P, dtype)
            geo = pack3d._inv_pack_geometry(B, D, Ho, Wo, P, mt, dtype,
                                            planes, 0)
            bands = (re.numpy(), im.numpy()) if planes else \
                torch.view_as_real(z).numpy()
            got = _replay(lll.numpy(), bands, planes, plans, P, geo)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                       err_msg="%s %s %s" % (shape, dtype,
                                                            planes))


def test_inv_pack_tap_bounds():
    """The least bound of each family's instance set (csrc/ipack.cuh
    ip_bound), the taps centred on its halo: every tap in place, zeros
    elsewhere, and the level-2 streams' parities one swap of (0, 1, 0,
    1); a filter too long for every bound is refused."""
    want = {"near_sym_a": 9, "antonini": 9, "legall": 9, "near_sym_b": 21,
            "qshift_a": 5, "qshift_b": 7, "qshift_c": 9, "qshift_d": 9,
            "qshift_32": 17}
    for fam, mt in want.items():
        level = 2 if fam.startswith("qshift") else 1
        _, plans, P, _ = _case(level, fam)
        assert pack3d._inv_tap_bound(plans, P, torch.float32) == mt, fam
        assert pack3d._inv_tap_bound(plans, P, torch.float64) == (
            33 if P == 1 else 17)
        T, sw = pack3d._inv_taps(plans, P, mt)
        for b, (taps, offs) in enumerate(plans):
            np.testing.assert_array_equal(np.sort(T[b][T[b] != 0]),
                                          np.sort(taps[taps != 0]))
        if P == 4:
            assert all(s in (0, 1) for s in sw)
        # a smaller bound does not hold the plans
        smaller = [m for m in pack3d._INV_BOUNDS[P][0] if m < mt]
        assert all(pack3d._inv_taps(plans, P, m) is None for m in smaller)
    long = np.ones(36) / 36
    plans = [ifilt_streams(long, long[::-1])] * 2
    with pytest.raises(ValueError, match="largest tap bound, 17"):
        pack3d._inv_tap_bound(plans, 4, torch.float32)


def test_inv_pack_geometry_main_path():
    """The main path's tiles (256^3 at 3 levels: level 1 on 256^2 slices,
    level 2 writing 256^2 and 128^2): 32 x 32 output samples, and shared
    memory that would leave an SM six blocks of level 1 (near_sym_a) and
    its eight (the 2048 threads' limit) of level 2 (qshift_a) in float32:
    the registers set the count.  The largest bound in float64 fits."""
    sm = 233472                    # an H100 SM; 1 KB of it a block's
    _, plans, _, _ = _case(1, "near_sym_a")
    mt = pack3d._inv_tap_bound(plans, 1, torch.float32)
    geo = pack3d._inv_pack_geometry(1, 256, 256, 256, 1, mt, torch.float32,
                                    False, 0)
    assert (geo.oh, geo.ow, geo.mt, geo.xr, geo.xs, geo.smem) == (
        32, 32, 9, 40, 40, 36160)
    assert geo.grid == (1, 128, 8, 8) and geo.vq
    assert sm // (geo.smem + 1024) == 6
    _, plans, _, _ = _case(2, "qshift_a")
    for Ho, grid in ((256, (1, 64, 8, 8)), (128, (1, 32, 4, 4))):
        for planes in (False, True):
            geo = pack3d._inv_pack_geometry(1, Ho // 2, Ho, Ho, 4, 5,
                                            torch.float32, planes, 8)
            assert (geo.mt, geo.xr, geo.xh, geo.xs, geo.smem) == (
                5, 24, 12, 24, 15552)
            assert geo.grid == grid and not geo.vq   # 8 mod 16: no vectors
            assert min(8, sm // (geo.smem + 1024)) == 8
    for P, mt in ((1, 33), (4, 17)):
        geo = pack3d._inv_pack_geometry(1, 2, 64, 64, P, mt, torch.float64,
                                        True, 0)
        assert geo.smem <= 220 * 1024 and geo.smem <= _build.SMEM_LIMIT
