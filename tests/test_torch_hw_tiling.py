"""The tilings of the two kernels of the sharded 3-D path's (H, W) stage
pairs, replayed on the CPU in numpy at float64: the synthesis
``filter_sum_hw22`` and ``ifilt_sum_hw22`` (``csrc/hwsum.cuh``
``sum_hw22_kernel``) and the analysis ``filter_hw22`` and ``dfilt_hw22``
(``csrc/hwana.cuh`` ``hw22_kernel``).

The kernels cannot run here, so this replays, block by block, what
``ops/hw.py:_sum_hw22_geometry`` and ``_sum_tap_bound`` tell the synthesis
to do: the row and column maps folded once per block; in each staging
round, the cells each staging item writes in the staged images (filter
row-major, ifilt split by column parity) from the four inputs through the
maps; the W stage's register windows (filter: 4 outputs from MT + 3
samples; ifilt: 8 outputs from two parity windows of MT + 1, in the order
the stream swap sets) and where it writes its images (ifilt split by row
parity); the H stage's windows down a column; and which output elements
each lane stores.  Likewise what ``_hw22_geometry`` and
``_hw22_tap_bound`` tell the analysis to do: the maps, the chunked
staging of the one input (row-major, 16 bytes aligned), the W stage's
items (dfilt's two rows by four items a 16-byte phase, their window loads
on 32 distinct banks in float32) and windows feeding both W branches
(dfilt's parities split in registers, taps by parity, the swap placing
each parity's sum), the H stage's windows down a column feeding both H
branches, and each lane's stores to the four outputs.  Every staged cell
must be written at most once a round, every cell a stage reads must have
been written, every output element written exactly once, a warp's stores
must fall on consecutive columns, and the outputs must equal the plain
versions (:func:`hw.filter_sum_hw22_reference`,
:func:`hw.ifilt_sum_hw22_reference`, :func:`hw.filter_hw22_reference`,
:func:`hw.dfilt_hw22_reference`) within 1e-12.  Edit the replay together
with the kernel.  The file takes about 15 s in one process (the analysis
kernel's 11 tests about 6 s).
"""

import numpy as np
import pytest
import torch

from dtcwt_tpu_torch.coeffs import biort, qshift
from dtcwt_tpu_torch.ops import _build, hw
from dtcwt_tpu_torch.ops.ilevel2 import ifilt_streams
from dtcwt_tpu_torch.ops.level2 import dfilt_streams

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


def _replay(vs, plans, P, geo, dtype, vec):
    """Run the kernel's index arithmetic on the four inputs *vs* [N, H, W]
    (*vec*: rows and inputs aligned to a chunk, so that the filter's
    staging copies chunks); return y [N, Ho, Wo] and assert every write
    lands once."""
    N, H, W = vs[0].shape
    Ho, Wo = (H, W) if P == 1 else (2 * H, 2 * W)
    mt, ph, so, dl = geo.mt, geo.ph, geo.so, geo.dl
    X, xh, xs_, cw = geo.xr, geo.xh, geo.xs, geo.cw
    acc = 8 if dtype == torch.float64 else 4
    vv = 16 // acc              # values a 16-byte vector
    # the tile the C side accepts (launch_tiles, HsGeo)
    assert (geo.oh, geo.ow) == (_TILE, _TILE) and geo.xc == X
    assert ph == (mt - 1) // 2
    if P == 1:
        # the staged area starts 16 bytes aligned where the tile does
        assert so == (ph + 3) // 4 * 4 and dl == so - ph and so % 4 == 0
        assert X == _TILE + 2 * so and (xh, xs_) == (0, X)
        assert cw == vv and X % cw == 0
    else:
        assert (so, dl, cw) == (2 * ph, 0, 0)
        assert X == _TILE // 2 + 2 * mt - 2
        assert xh >= X // 2 and xh % 8 == 4 and xs_ == 2 * xh
    assert X % 2 == 0
    n_th, n_tw = -(-Ho // _TILE), -(-Wo // _TILE)
    xn = X * xs_
    nx = 4 // geo.rounds
    assert geo.smem == acc * (nx * xn + 2 * X * _TILE) + 8 * X
    assert geo.smem <= 220 * 1024
    assert geo.rounds == (1 if acc * (4 * xn + 2 * X * _TILE) + 8 * X
                          <= 220 * 1024 else 2)
    T, sw = hw._inv_taps(plans, P, mt)
    y = np.zeros((N, Ho, Wo))
    ny = np.zeros(y.shape, np.int64)
    tid = np.arange(_THREADS)
    rg, col = tid >> 5, tid & 31

    def cell(r, c):
        """hs_cell()."""
        if P == 1:
            return r * xs_ + c
        return r * xs_ + (c & 1) * xh + (c >> 1)

    for n in range(N):
        for th in range(n_th):
            for tw in range(n_tw):
                o0r, o0c = th * _TILE, tw * _TILE
                rs = (o0r if P == 1 else o0r // 2) - so
                cs = (o0c if P == 1 else o0c // 2) - so
                assert rs % 2 == 0 and cs % 2 == 0
                rmap = _fold(rs + np.arange(X), H)
                cmap = _fold(cs + np.arange(X), W)
                assert (rmap == _reflect(rs + np.arange(X), H)).all()
                assert (cmap == _reflect(cs + np.arange(X), W)).all()
                vw = [_Img(X * _TILE) for _ in range(2)]
                for rnd in range(geo.rounds):
                    # staging: a cell an item, image i from input
                    # rnd * nx + i (v[j][k] at 2 j + k)
                    xs = [_Img(xn) for _ in range(nx)]
                    if P == 1 and vec:
                        # a chunk of cw cells an item: one vector where the
                        # map runs on in order (from an aligned sample),
                        # else a cell at a time
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
                                       + np.tile(np.arange(cw), run.size),
                                       cmap[c])
                    else:
                        it = np.arange(X * X)
                        r, c = np.divmod(it, X)
                        src = cmap[c]
                    for i in range(nx):
                        xs[i].put(cell(r, c),
                                  vs[rnd * nx + i][n, rmap[r], src])
                        assert (xs[i].n <= 1).all()
                    # W stage of H branches j0 + jj, images 2 jj + k
                    j0, nj = rnd * nx // 2, nx // 2
                    if P == 1:
                        nw = -(-(dl + mt + 3) // vv) * vv
                        it = np.arange(nj * X * 8)
                        q4, rr = it & 7, it >> 3
                        jj, r = np.divmod(rr, X)
                        for jv in range(nj):
                            s = jj == jv
                            a = np.zeros((s.sum(), 4))
                            for k in range(2):
                                start = r[s] * xs_ + 4 * q4[s]
                                assert (start % vv == 0).all()
                                assert (4 * q4[s] + nw <= xs_).all()
                                w = xs[2 * jv + k].get(
                                    start[:, None] + np.arange(nw))
                                for m in range(mt):
                                    a += T[k, 0, m] * w[:, dl + m:dl + m + 4]
                            o = r[s] * _TILE + 4 * q4[s]
                            assert (o % vv == 0).all()
                            vw[j0 + jv].put(o[:, None] + np.arange(4), a)
                    else:
                        nw = mt + 1
                        it = np.arange(nj * X * 4)
                        q4, rr = it & 3, it >> 2
                        jj, r = np.divmod(rr, X)
                        for jv in range(nj):
                            s = jj == jv
                            a = np.zeros((s.sum(), 8))
                            for k in range(2):
                                row = r[s] * xs_ + 2 * q4[s]
                                assert (row % 2 == 0).all()  # pair loads
                                assert (2 * q4[s] + nw <= xh).all()
                                win = [xs[2 * jv + k].get(
                                    (row + p * xh)[:, None] + np.arange(nw))
                                    for p in (sw[k], 1 - sw[k])]
                                for m in range(mt):
                                    for s4 in range(4):
                                        w = win[s4 & 1]
                                        for v in range(2):
                                            a[:, 4 * v + s4] += \
                                                T[k, s4, m] * w[:, v + m]
                            o = (((r[s] & 1) * (X // 2) + (r[s] >> 1))
                                 * _TILE + 8 * q4[s])
                            assert (o % vv == 0).all()
                            vw[j0 + jv].put(o[:, None] + np.arange(8), a)
                    for j in range(2):
                        assert (vw[j].n <= 1).all()
                # H stage: thread (rg, col), rows 4 rg + v
                a = np.zeros((4, _THREADS))
                for j in range(2):
                    if P == 1:
                        w = vw[j].get((4 * rg[:, None] + dl
                                       + np.arange(mt + 3)) * _TILE
                                      + col[:, None])
                        for m in range(mt):
                            a += T[j, 0, m] * w[:, m:m + 4].T
                    else:
                        win = [vw[j].get((p * (X // 2) + rg[:, None]
                                          + np.arange(mt)) * _TILE
                                         + col[:, None])
                               for p in (sw[j], 1 - sw[j])]
                        for m in range(mt):
                            for s4 in range(4):
                                a[s4] += T[j, s4, m] * win[s4 & 1][:, m]
                # the stores: rows 4 rg + v of column col, a warp's lanes
                # on consecutive columns
                for v in range(4):
                    gor, goc = o0r + 4 * rg + v, o0c + col
                    off = gor * Wo + goc
                    assert (np.diff(off.reshape(8, 32), axis=1) == 1).all()
                    ok = (gor < Ho) & (goc < Wo)
                    np.add.at(ny[n], (gor[ok], goc[ok]), 1)
                    y[n, gor[ok], goc[ok]] = a[v, ok]
    assert (ny == 1).all(), "outputs written %s times" % set(ny.reshape(-1))
    return y


def _pad(h, m):
    """*h* zero-padded to *m* taps, centred."""
    h = np.asarray(h, np.float64).reshape(-1)
    p = (m - h.size) // 2
    return np.concatenate([np.zeros(p), h, np.zeros(m - h.size - p)])


def _filters(kind, fam):
    """The entry's filters in its call order: (g0o, g1o) or the pairs
    ((g0b, g0a), (g1b, g1a)); "long" is the longest the kernel takes
    (near_sym_b's zero-padded to 31 taps, qshift_d's to 64), "random" as
    long with every tap random."""
    rs = np.random.RandomState(5)
    if kind == "filter_sum":
        if fam == "random":
            return rs.randn(31), rs.randn(31)
        b = biort("near_sym_b" if fam == "long" else fam)
        f = (b[1], b[3])
        return tuple(_pad(h, 31) for h in f) if fam == "long" else f
    if fam == "random":
        return (rs.randn(64), rs.randn(64)), (rs.randn(64), rs.randn(64))
    q = qshift("qshift_d" if fam == "long" else fam)
    f = ((q[3], q[2]), (q[7], q[6]))
    if fam == "long":
        f = tuple(tuple(_pad(h, 64) for h in p) for p in f)
    return f


def _plans(kind, f):
    return (hw._filter_plans(*f) if kind == "filter_sum" else
            [ifilt_streams(*p) for p in f])


# [..., H, W]: the card tests' shapes (H or W shorter than the filters, off
# any grid) and tiles partial in H and W (36 x 44, 66 x 68)
_SHAPES = [(3, 12, 20), (2, 2, 8, 132), (1, 520, 8), (2, 4, 4), (6, 32, 48),
           (1, 36, 44), (2, 66, 68)]
# the shapes an instance at the largest tap bound replays (its blocks stage
# 64-80 rows)
_SHAPES_LONG = [(1, 520, 8), (2, 4, 4), (1, 36, 44)]


@pytest.mark.parametrize("kind,fam", [
    ("filter_sum", "antonini"), ("filter_sum", "near_sym_a"),
    ("filter_sum", "near_sym_b"), ("filter_sum", "long"),
    ("filter_sum", "random"),
    ("ifilt_sum", "qshift_06"), ("ifilt_sum", "qshift_a"),
    ("ifilt_sum", "qshift_d"), ("ifilt_sum", "qshift_32"),
    ("ifilt_sum", "long"), ("ifilt_sum", "random")])
def test_sum_hw22_tiling_replay(kind, fam):
    """Each block's reads and writes in the float32 and float64 geometries
    (one staging round; ifilt's float64 two) over the shapes, against the
    plain version at float64."""
    f = _filters(kind, fam)
    plans = _plans(kind, f)
    P = 1 if kind == "filter_sum" else 4
    plain = getattr(hw, kind + "_hw22_reference")
    shapes = _SHAPES_LONG if fam in ("long", "random") else _SHAPES
    for no, shape in enumerate(shapes):
        rs = np.random.RandomState(no)
        vs = [rs.rand(*shape) for _ in range(4)]
        want = plain(*[torch.from_numpy(v) for v in vs], *f).numpy()
        H, W = shape[-2:]
        flat = [v.reshape((-1, H, W)) for v in vs]
        N = flat[0].shape[0]
        Ho, Wo = (H, W) if P == 1 else (2 * H, 2 * W)
        # float32 with its inputs aligned (the filter's chunked staging),
        # float64 unaligned (a cell at a time)
        for dtype, vec in ((torch.float32, True), (torch.float64, False)):
            mt = hw._sum_tap_bound(plans, P)
            geo = hw._sum_hw22_geometry(P, mt, dtype)
            got = _replay(flat, plans, P, geo, dtype, vec)
            np.testing.assert_allclose(
                got.reshape(want.shape), want, rtol=0, atol=1e-12,
                err_msg="%s %s" % (shape, dtype))


def test_sum_hw22_tap_bounds():
    """The least bound of each family's instance set (csrc/hwsum.cuh
    hs_bound, every dtype), its taps centred on the halo: every tap in
    place, zeros elsewhere, ifilt's streams of one swap of (0, 1, 0, 1).
    The longest filters taken before the redesign (odd filters of 31
    taps, qshift pairs of 64) take the largest bound; one tap a stream
    more is refused with the ValueError of the plans' table, as before."""
    want = {"legall": 5, "near_sym_a": 7, "antonini": 9, "near_sym_b": 19,
            "qshift_06": 5, "qshift_a": 5, "qshift_b": 7, "qshift_c": 9,
            "qshift_d": 9, "qshift_32": 17, "long": None, "random": None}
    for fam, mt in want.items():
        kinds = (("filter_sum", "ifilt_sum") if mt is None
                 else ("ifilt_sum",) if fam.startswith("qshift")
                 else ("filter_sum",))
        for kind in kinds:
            P = 1 if kind == "filter_sum" else 4
            m = hw._SUM_BOUNDS[P][-1] if mt is None else mt
            f = _filters(kind, fam)
            plans = _plans(kind, f)
            assert hw._sum_tap_bound(plans, P) == m, fam
            flat = [np.asarray(h) for h in f] if P == 1 else \
                [np.asarray(h) for p in f for h in p]
            assert hw._sum_plan(kind + "_hw22", flat).mt == m
            T, sw = hw._inv_taps(plans, P, m)
            for b, (taps, offs) in enumerate(plans):
                np.testing.assert_array_equal(np.sort(T[b][T[b] != 0]),
                                              np.sort(taps[taps != 0]))
            if P == 4:
                assert all(s in (0, 1) for s in sw)
            smaller = [b for b in hw._SUM_BOUNDS[P] if b < m]
            assert all(hw._inv_taps(plans, P, b) is None for b in smaller)
    assert hw._SUM_BOUNDS == {1: (5, 7, 9, 19, 31), 4: (5, 7, 9, 17, 33)}
    # every odd length up to 31 and every even pair length up to 64 is held
    rs = np.random.RandomState(6)
    for m in range(1, 33, 2):
        hw._sum_tap_bound(_plans("filter_sum", (rs.randn(m), rs.randn(m))),
                          1)
    for m in range(2, 66, 2):
        pairs = [(rs.randn(m), rs.randn(m)) for _ in range(2)]
        hw._sum_tap_bound(_plans("ifilt_sum", pairs), 4)
    with pytest.raises(ValueError, match="at most 32 taps per stream"):
        hw._sum_plan("filter_sum_hw22", [np.ones(33), np.ones(33)])
    with pytest.raises(ValueError, match="at most 32 taps per stream"):
        hw._sum_plan("ifilt_sum_hw22", [np.ones(66)] * 4)


def test_sum_hw22_geometry_sharded_shapes():
    """The sharded 256^3 round trip's shards (filter_sum_hw22 [1, 64, 256,
    256] with near_sym_a; ifilt_sum_hw22 [1, 32, 64, 64] and [1, 64, 128,
    128] with qshift_a): 32 x 32 output samples, and shared memory that
    leaves an SM six blocks of filter and the 2048 threads' eight of
    ifilt in float32.  The largest bounds in float64 fit, ifilt in two
    rounds."""
    sm = 233472                    # an H100 SM; 1 KB of it a block's
    b = biort("near_sym_a")
    plan = hw._sum_plan("filter_sum_hw22", [b[1], b[3]])
    geo = hw._sum_hw22_geometry(1, plan.mt, torch.float32)
    assert (geo.oh, geo.ow, geo.mt, geo.so, geo.dl, geo.xr, geo.xs, geo.cw,
            geo.rounds, geo.smem) == (32, 32, 7, 4, 1, 40, 40, 4, 1, 36160)
    assert geo.tile() == (32, 32, 7, 40, 40, 36160)
    assert sm // (geo.smem + 1024) == 6
    q = qshift("qshift_a")
    plan = hw._sum_plan("ifilt_sum_hw22", [q[3], q[2], q[7], q[6]])
    geo = hw._sum_hw22_geometry(4, plan.mt, torch.float32)
    assert (geo.mt, geo.so, geo.xr, geo.xh, geo.xs, geo.cw, geo.rounds,
            geo.smem) == (5, 4, 24, 12, 24, 0, 1, 15552)
    assert min(8, sm // (geo.smem + 1024)) == 8
    for P, rounds in ((1, 1), (4, 2)):
        geo = hw._sum_hw22_geometry(P, hw._SUM_BOUNDS[P][-1], torch.float64)
        assert geo.rounds == rounds
        assert geo.smem <= 220 * 1024 and geo.smem <= _build.SMEM_LIMIT


# ---------------------------------------------------------------------------
# the analysis kernel, hw22_kernel (csrc/hwana.cuh)
# ---------------------------------------------------------------------------

def _replay_hw22(x, plans, P, geo, dtype, vec):
    """Run the analysis kernel's index arithmetic on *x* [N, H, W] (*vec*:
    rows and input aligned to a chunk, so that the staging copies chunks);
    return the four outputs u[2 j + k] [N, Ho, Wo] and assert every write
    lands once."""
    N, H, W = x.shape
    Ho, Wo = H // P, W // P
    mt, ph, so, dl = geo.mt, geo.ph, geo.so, geo.dl
    X, xs_, ns, nw, cw = geo.xr, geo.xs, geo.ns, geo.nw, geo.cw
    acc = 8 if dtype == torch.float64 else 4
    vv = 16 // acc
    # the tile the C side accepts (launch_tiles, HaGeo)
    assert (geo.oh, geo.ow) == (_TILE, _TILE) and geo.xc == X
    assert ph == (mt - 1) // 2 and so % 4 == 0 and so == dl + P * ph
    assert 0 <= dl < 4 and X == P * _TILE + 2 * so and X % 4 == 0
    assert xs_ % 4 == 0 and (P == 1 and xs_ == X or P == 2 and xs_ % 8 == 4)
    assert ns == (mt + 3 if P == 1 else 2 * mt + 4) and nw % vv == 0
    assert dl + ns <= nw < dl + ns + vv and 4 * P * 7 + nw <= X
    assert cw == vv and X % cw == 0
    assert geo.smem == acc * (X * xs_ + 2 * X * _TILE) + 8 * X
    assert geo.smem <= 220 * 1024
    T, sw = hw._inv_taps(plans, P, mt)
    if P == 2:
        # taps by parity: stream s reads the parity s ^ sw
        T = np.stack([T[k][[sw[k], 1 - sw[k]]] for k in range(2)])
    n_th, n_tw = -(-Ho // _TILE), -(-Wo // _TILE)
    u = np.zeros((4, N, Ho, Wo))
    nu = np.zeros(u.shape, np.int64)
    tid = np.arange(_THREADS)
    rg, col = tid >> 5, tid & 31

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

    for n in range(N):
        for th in range(n_th):
            for tw in range(n_tw):
                o0r, o0c = th * _TILE, tw * _TILE
                rs, cs = P * o0r - so, P * o0c - so
                assert rs % 4 == 0 and cs % 4 == 0   # aligned, even
                rmap = _fold(rs + np.arange(X), H)
                cmap = _fold(cs + np.arange(X), W)
                assert (rmap == _reflect(rs + np.arange(X), H)).all()
                assert (cmap == _reflect(cs + np.arange(X), W)).all()
                # staging, row-major: chunks of cw cells where the map runs
                # on in order from an aligned sample, else a cell at a time
                xs = _Img(X * xs_)
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
                                   + np.tile(np.arange(cw), run.size),
                                   cmap[c])
                else:
                    r, c = np.divmod(np.arange(X * X), X)
                    src = cmap[c]
                xs.put(r * xs_ + c, x[n, rmap[r], src])
                assert (xs.n <= 1).all()
                # W stage: item (r, q), outputs 4 q .. 4 q + 3 of staged row
                # r from one window of nw values
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
                if acc == 4:
                    # each 16-byte phase of 8 items: 32 distinct banks
                    banks = (start.reshape(-1, 8)[:, :, None] % 32
                             + np.arange(4)) % 32
                    for e in range(nw // 4):
                        b = (banks + 4 * e) % 32
                        assert all(len(set(v.reshape(-1))) == 32 for v in b)
                w = xs.get(start[:, None] + np.arange(nw))
                vw = [_Img(X * _TILE) for _ in range(2)]
                for k in range(2):
                    a = place(fir(w[:, dl:], T[k]), sw[k] if P == 2 else 0)
                    o = (r * _TILE + 4 * q)
                    assert (o % vv == 0).all()
                    vw[k].put(o[:, None] + np.arange(4), a)
                    assert (vw[k].n == 1).all()
                # H stage and stores: thread (rg, col), output rows 4 rg + v
                # of column col of u[j][k], a window down column col of
                # vw[k] feeding both j
                for k in range(2):
                    w = vw[k].get((4 * P * rg[:, None] + dl + np.arange(ns))
                                  * _TILE + col[:, None])
                    for j in range(2):
                        a = place(fir(w, T[j]), sw[j] if P == 2 else 0)
                        for v in range(4):
                            gor, goc = o0r + 4 * rg + v, o0c + col
                            off = gor * Wo + goc
                            assert (np.diff(off.reshape(8, 32), axis=1)
                                    == 1).all()
                            ok = (gor < Ho) & (goc < Wo)
                            np.add.at(nu[2 * j + k, n], (gor[ok], goc[ok]), 1)
                            u[2 * j + k, n, gor[ok], goc[ok]] = a[ok, v]
    assert (nu == 1).all(), "outputs written %s times" % set(nu.reshape(-1))
    return u


def _hw22_filters(kind, fam):
    """The analysis entry's filters in its call order: (h0o, h1o) or the
    pairs ((h0b, h0a), (h1b, h1a)); "long" the longest the kernel takes
    with every tap random (odd filters of 31 taps, qshift pairs of 32)."""
    rs = np.random.RandomState(7)
    if kind == "filter":
        if fam == "long":
            return rs.randn(31), rs.randn(31)
        b = biort(fam)
        return b[0], b[2]
    if fam == "long":
        return (rs.randn(32), rs.randn(32)), (rs.randn(32), rs.randn(32))
    q = qshift(fam)
    return (q[1], q[0]), (q[5], q[4])


def _hw22_plans(kind, f):
    return (hw._filter_plans(*f) if kind == "filter" else
            [dfilt_streams(*p) for p in f])


# [..., H, W]: the card tests' shapes (H or W shorter than the filters, off
# any grid; multiples of 4 for dfilt) and tiles partial in H and W
_HW22_SHAPES = [(3, 12, 20), (2, 2, 8, 132), (1, 520, 8), (2, 4, 4),
                (6, 32, 48), (1, 36, 44), (2, 68, 72)]
_HW22_SHAPES_LONG = [(1, 520, 8), (2, 4, 4), (1, 36, 44)]


@pytest.mark.parametrize("kind,fam", [
    ("filter", "antonini"), ("filter", "near_sym_a"),
    ("filter", "near_sym_b"), ("filter", "long"),
    ("dfilt", "qshift_06"), ("dfilt", "qshift_a"), ("dfilt", "qshift_d"),
    ("dfilt", "qshift_32"), ("dfilt", "long")])
def test_hw22_tiling_replay(kind, fam):
    """Each block's reads and writes in the float32 (chunked staging) and
    float64 (a value an item) geometries over the shapes, against the
    plain version at float64."""
    f = _hw22_filters(kind, fam)
    plans = _hw22_plans(kind, f)
    P = 1 if kind == "filter" else 2
    plain = getattr(hw, kind + "_hw22_reference")
    shapes = _HW22_SHAPES_LONG if fam == "long" else _HW22_SHAPES
    for no, shape in enumerate(shapes):
        x = np.random.RandomState(no).rand(*shape)
        want = plain(torch.from_numpy(x), *f)
        want = np.stack([want[j][k].numpy() for j in range(2)
                         for k in range(2)])
        H, W = shape[-2:]
        flat = x.reshape((-1, H, W))
        for dtype, vec in ((torch.float32, True), (torch.float64, False)):
            mt = hw._hw22_tap_bound(plans, P)
            geo = hw._hw22_geometry(P, mt, dtype)
            got = _replay_hw22(flat, plans, P, geo, dtype, vec)
            np.testing.assert_allclose(
                got.reshape(want.shape), want, rtol=0, atol=1e-12,
                err_msg="%s %s" % (shape, dtype))


def test_hw22_tap_bounds():
    """The least bound of each family's analysis instance set
    (csrc/hwtile.cuh hs_bound, every dtype), its taps centred on the halo:
    every tap in place, zeros elsewhere, dfilt's streams on the two
    parities.  The longest filters taken before the redesign (odd filters
    of 31 taps, qshift pairs of 32) take the largest bound; one tap a
    stream more is refused with the ValueError of the plans' table, as
    before; every odd length up to 31 and every even pair length up to 32
    is held."""
    want = {("filter", "legall"): 5, ("filter", "near_sym_a"): 7,
            ("filter", "antonini"): 9, ("filter", "near_sym_b"): 19,
            ("filter", "long"): 31, ("dfilt", "qshift_06"): 10,
            ("dfilt", "qshift_a"): 10, ("dfilt", "qshift_b"): 14,
            ("dfilt", "qshift_c"): 16, ("dfilt", "qshift_d"): 18,
            ("dfilt", "qshift_32"): 32, ("dfilt", "long"): 32}
    for (kind, fam), m in want.items():
        P = 1 if kind == "filter" else 2
        f = _hw22_filters(kind, fam)
        plans = _hw22_plans(kind, f)
        assert hw._hw22_tap_bound(plans, P) == m, fam
        flat = [np.asarray(h) for h in f] if P == 1 else \
            [np.asarray(h) for p in f for h in p]
        assert hw._plan(kind + "_hw22", flat).mt == m
        T, sw = hw._inv_taps(plans, P, m)
        for b, (taps, offs) in enumerate(plans):
            np.testing.assert_array_equal(np.sort(T[b][T[b] != 0]),
                                          np.sort(taps[taps != 0]))
            if P == 2:
                # stream s on parity s ^ sw, both streams' taps centred
                assert sw[b] == (offs[0] + m - 2) & 1
                assert (offs[1] + m - 2) & 1 == 1 - sw[b]
        smaller = [b for b in hw._HW_BOUNDS[P] if b < m]
        assert all(hw._inv_taps(plans, P, b) is None for b in smaller)
    assert hw._HW_BOUNDS == {1: (5, 7, 9, 19, 31), 2: (10, 14, 16, 18, 32)}
    rs = np.random.RandomState(8)
    for m in range(1, 33, 2):
        assert hw._hw22_tap_bound(_hw22_plans(
            "filter", (rs.randn(m), rs.randn(m))), 1) <= 31
    for m in range(2, 34, 2):
        pairs = [(rs.randn(m), rs.randn(m)) for _ in range(2)]
        assert hw._hw22_tap_bound(_hw22_plans("dfilt", pairs), 2) == min(
            b for b in hw._HW_BOUNDS[2] if b >= m)
    with pytest.raises(ValueError, match="at most 32 taps per stream"):
        hw._plan("filter_hw22", [np.ones(33), np.ones(33)])
    with pytest.raises(ValueError, match="at most 32 taps per stream"):
        hw._plan("dfilt_hw22", [np.ones(34)] * 4)


def test_hw22_geometry_sharded_shapes():
    """The sharded 256^3 round trip's shards (filter_hw22 [1, 64, 256, 256]
    with near_sym_a; dfilt_hw22 [1, 64, 256, 256] and [1, 32, 128, 128]
    with qshift_a): 32 x 32 output samples, and shared memory that leaves
    an SM the 2048 threads' eight blocks of filter and four of dfilt in
    float32.  The largest bounds in float64 fit."""
    sm = 233472                    # an H100 SM; 1 KB of it a block's
    b = biort("near_sym_a")
    plan = hw._plan("filter_hw22", [b[0], b[2]])
    geo = hw._hw22_geometry(1, plan.mt, torch.float32)
    assert (geo.oh, geo.ow, geo.mt, geo.so, geo.dl, geo.xr, geo.xs, geo.ns,
            geo.nw, geo.cw, geo.smem) == (32, 32, 7, 4, 1, 40, 40, 10, 12,
                                          4, 16960)
    assert geo.tile() == (32, 32, 7, 40, 40, 16960)
    assert min(8, sm // (geo.smem + 1024)) == 8
    q = qshift("qshift_a")
    plan = hw._plan("dfilt_hw22", [q[1], q[0], q[5], q[4]])
    geo = hw._hw22_geometry(2, plan.mt, torch.float32)
    assert (geo.mt, geo.so, geo.dl, geo.xr, geo.xs, geo.ns, geo.nw,
            geo.smem) == (10, 8, 0, 80, 84, 24, 24, 48000)
    assert sm // (geo.smem + 1024) == 4
    # the shard shapes: blocks a launch
    for shape, P, blocks in (((1, 64, 256, 256), 1, 64 * 8 * 8),
                             ((1, 64, 256, 256), 2, 64 * 4 * 4),
                             ((1, 32, 128, 128), 2, 32 * 2 * 2)):
        Ho, Wo = shape[-2] // P, shape[-1] // P
        assert shape[1] * -(-Ho // 32) * -(-Wo // 32) == blocks
    for P in (1, 2):
        for dtype in (torch.float32, torch.bfloat16, torch.float64):
            geo = hw._hw22_geometry(P, hw._HW_BOUNDS[P][-1], dtype)
            assert geo.smem <= 220 * 1024 and geo.smem <= _build.SMEM_LIMIT
