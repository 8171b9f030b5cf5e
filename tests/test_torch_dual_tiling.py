"""The tiling of the dual kernels' synthesis sums, ``filter2_sum`` and
``ifilt2_sum`` (``csrc/streamsum.cuh``), replayed on the CPU in numpy at
float64.

The kernel cannot run here, so this replays, block by block, what
``ops/dual.py:_sum_geometry`` and ``_sum_plan`` tell it to do.  On the
columns path (inner > 1): each thread's columns and groups, the rows (ifilt:
row pairs) of both inputs its window loads, where each loaded row reaches
(the taps centred on the bound's halo, ifilt's parity swap), and the
outputs it stores, a warp's lanes on consecutive columns.  On the rows
path (inner = 1): each block's staging of a flat range of both inputs
(a head and a tail a value at a time, 16-byte chunks between, every chunk
aligned on both sides), each item's register windows (inside the row, or
read at the reflected index, or as zero past an extended buffer, the
clamp moving no read a stored output takes) and its vector or scalar
stores.  Every staged cell must be written at most once, every cell a
window reads must have been written, every output sample written exactly
once, and the result must equal the plain versions
(:func:`dual.filter2_sum_axis_reference`,
:func:`dual.ifilt2_sum_axis_reference` and their from-extension forms)
within 1e-12.  Edit the replay together with the kernel.  The file takes
about 10 s in one process.
"""

import numpy as np
import pytest
import torch

from dtcwt_tpu_torch.coeffs import biort, qshift
from dtcwt_tpu_torch.ops import dual, fb

_THREADS = 256
_EVEN = (np.array([1.0, 3.0, 3.0, 1.0]) / 8,
         np.array([-0.25, -1.0, 2.0, 1.0, -0.5, 0.125]))


def _cdiv(a, b):
    return -(-a // b)


def _source(j, n, refl):
    """source() of csrc/common.cuh: the in-axis index of sample j, or -1
    where it reads as zero."""
    j = np.asarray(j)
    t = np.mod(j, 2 * n)
    r = np.where(t < n, t, 2 * n - 1 - t)
    return np.where((j >= 0) & (j < n), j, r if refl else -1)


class _Img:
    """A shared image filled with NaN whose writes are counted: a cell
    read before it is written reads NaN, which the outputs show."""

    def __init__(self, n):
        self.v = np.full(n, np.nan)
        self.n = np.zeros(n, np.int64)

    def put(self, idx, val):
        idx = np.asarray(idx).reshape(-1)
        if not idx.size:
            return
        assert idx.min() >= 0 and idx.max() < self.v.size
        np.add.at(self.n, idx, 1)
        self.v[idx] = np.asarray(val).reshape(-1)

    def get(self, idx):
        val = self.v[idx]
        assert not np.isnan(val).any(), "a cell read before it was written"
        return val


def _fir(acc, T, sw, bb, w, P, mt, nv):
    """Add branch bb's taps over windows w [items, samples] into acc
    [items, nv groups, P] (ifilt: the parity windows by the swap)."""
    if P == 1:
        for m in range(mt):
            for v in range(nv):
                acc[:, v, 0] += T[bb, 0, m] * w[:, v + m]
        return
    ev, od = w[:, 0::2], w[:, 1::2]
    wa, wb = (od, ev) if sw[bb] else (ev, od)
    for m in range(mt):
        for v in range(nv):
            for s in range(4):
                acc[:, v, s] += T[bb, s, m] * (wb if s & 1 else wa)[:, v + m]


def _replay_cols(X, T, sw, P, mt, g, side, refl, geo, y, cnt):
    outer, n_in, inner = X[0].shape
    D, ph = (1 if P == 1 else 2), (mt - 1) // 2
    RV, VC, TX = geo.v, geo.vc, geo.tx
    TY = _THREADS // TX
    assert geo.seg == TY * RV and geo.rows == 1 and geo.smem == 0
    assert geo.grid == (outer, _cdiv(g, geo.seg), _cdiv(inner, TX * VC))
    n_rt, n_ct = geo.grid[1:]
    blk, tid = np.meshgrid(np.arange(geo.blocks), np.arange(_THREADS),
                           indexing="ij")
    blk, tid = blk.reshape(-1), tid.reshape(-1)
    ct, rt, o = blk % n_ct, (blk // n_ct) % n_rt, blk // (n_ct * n_rt)
    tx, ty = tid % TX, tid // TX
    col, g0 = (ct * TX + tx) * VC, (rt * TY + ty) * RV
    # a warp's lanes of one group row on consecutive vectors
    nxt = (tid % 32 != 31) & (np.roll(ty, -1) == ty)
    assert (np.roll(col, -1)[nxt] - col[nxt] == VC).all()
    live = (col < inner) & (g0 < g)
    o, col, g0 = o[live], col[live], g0[live]
    u = np.arange(VC)
    cols = col[:, None] + u
    assert (cols < inner).all()   # a vector stays inside the row
    j0 = D * (g0 - ph) + side
    acc = np.zeros((o.size, RV, P, VC))

    def load(x, j):
        jj = _source(j, n_in, refl)
        val = x[o[:, None], np.maximum(jj, 0)[:, None], cols]
        return np.where((jj >= 0)[:, None], val, 0.0)

    for r in range(RV + mt - 1):
        for bb in range(2):
            if P == 1:
                w = load(X[bb], j0 + r)
                for m in range(mt):
                    if 0 <= r - m < RV:
                        acc[:, r - m, 0] += T[bb, 0, m] * w
                continue
            ev, od = load(X[bb], j0 + 2 * r), load(X[bb], j0 + 2 * r + 1)
            wa, wb = (od, ev) if sw[bb] else (ev, od)
            for m in range(mt):
                if 0 <= r - m < RV:
                    for s in range(4):
                        acc[:, r - m, s] += T[bb, s, m] * (
                            wb if s & 1 else wa)
    for v in range(RV):
        ok = g0 + v < g
        for s in range(P):
            idx = (o[ok][:, None], (P * (g0[ok] + v) + s)[:, None],
                   cols[ok])
            np.add.at(cnt, idx, 1)
            y[idx] = acc[ok, v, s]


def _replay_rows(X, T, sw, P, mt, g, side, refl, geo, y, cnt, size,
                 eoff):
    outer, n_in, inner = X[0].shape
    assert inner == 1
    flat = [x.reshape(-1) for x in X]
    D, ph = (1 if P == 1 else 2), (mt - 1) // 2
    vec = 16 // size
    GV, R, L = geo.v, geo.rows, geo.seg
    NW = D * (GV + mt - 1)
    assert geo.vc == 1 and geo.tx == 1 and L % GV == 0
    assert geo.grid == (_cdiv(outer, R), _cdiv(g, L))
    n_seg = geo.grid[1]
    assert n_seg == 1 or R == 1
    rb = geo.smem // (2 * size)
    assert 2 * rb * size == geo.smem and rb % vec == 0
    assert rb >= vec + (R - 1) * n_in + min(n_in, D * (L + mt - 1))
    vec_out = (P * g) % vec == 0 and (eoff[2] * size) % 16 == 0
    for blk in range(geo.blocks):
        s0, o0 = (blk % n_seg) * L, (blk // n_seg) * R
        rows, lr = min(R, outer - o0), min(L, g - s0)
        j00 = D * (s0 - ph) + side
        sa, sb = max(j00, 0), min(n_in, j00 + D * (L + mt - 1))
        f0, ln = o0 * n_in + sa, (rows - 1) * n_in + (sb - sa)
        xs, pads = _Img(2 * rb), []
        for i in range(2):
            pad = (eoff[i] + f0) * size % 16 // size
            head = min((vec - pad) % vec, ln)
            nvec = (ln - head) // vec
            dst0 = i * rb + pad
            xs.put(dst0 + np.arange(head), flat[i][f0:f0 + head])
            for q in range(nvec):
                e = head + q * vec
                assert (dst0 + e) % vec == 0               # shared side
                assert (eoff[i] + f0 + e) * size % 16 == 0  # device side
                xs.put(dst0 + e + np.arange(vec),
                       flat[i][f0 + e:f0 + e + vec])
            e = head + nvec * vec
            xs.put(dst0 + np.arange(e, ln), flat[i][f0 + e:f0 + ln])
            assert dst0 + ln <= (i + 1) * rb
            pads.append(pad)
        assert xs.n.max() <= 1
        items = _cdiv(lr, GV)
        lo, hi = -j00, n_in - NW - j00
        q_lo = min(items, _cdiv(lo, D * GV)) if lo > 0 else 0
        q_hi = max(q_lo, min(items, 0 if hi < 0 else hi // (D * GV) + 1))
        q = np.arange(items)
        fast = (q >= q_lo) & (q < q_hi)
        j = (j00 + D * GV * q)[:, None] + np.arange(NW)
        assert ((j[fast] >= 0) & (j[fast] < n_in)).all()
        nvg = np.minimum(GV, lr - GV * q)        # the item's stored groups
        used = (np.arange(NW) // D)[None, :] <= (nvg + mt - 2)[:, None]
        for r in range(rows):
            acc = np.zeros((items, GV, P))
            for bb in range(2):
                base = bb * rb + pads[bb] - sa + r * n_in
                lo_c, hi_c = bb * rb + pads[bb], bb * rb + pads[bb] + ln - 1
                jj = _source(j, n_in, refl)
                jj = np.where(fast[:, None], j, jj)
                c = base + np.maximum(jj, 0)
                cc = np.clip(c, lo_c, hi_c)
                assert ((c == cc) | ~used | (jj < 0)).all()
                w = np.where(jj >= 0, xs.get(cc), 0.0)
                _fir(acc, T, sw, bb, w, P, mt, GV)
            for qi in range(items):
                gq = s0 + GV * qi
                nv = P * nvg[qi]
                start = (o0 + r) * P * g + P * gq   # flat output index
                if vec_out and nv == GV * P:
                    for e in range(GV * P // vec):
                        assert (eoff[2] + start + e * vec) * size % 16 == 0
                yf, cf = y.reshape(-1), cnt.reshape(-1)
                out = acc[qi].reshape(-1)[:nv]
                np.add.at(cf, start + np.arange(nv), 1)
                yf[start:start + nv] = out


def _replay(name, xs, filters, axis, side, size, eoff=(0, 0, 0)):
    """The kernel's result on the numpy inputs *xs* along *axis* (side:
    the from-extension mode), for elements of *size* bytes whose pointers
    sit *eoff* elements past 16-byte alignment (a, b, y)."""
    P = 1 if name == "filter2_sum" else 4
    plan = dual._sum_plan(name, filters)
    mt = plan.mt
    T, sw = dual._inv_taps(plan.plans, P, mt)
    ax = axis % xs[0].ndim
    shape = xs[0].shape
    outer = int(np.prod(shape[:ax], dtype=np.int64))
    inner = int(np.prod(shape[ax + 1:], dtype=np.int64))
    n_in = shape[ax]
    X = [x.reshape(outer, n_in, inner) for x in xs]
    n = n_in - 2 * (side or 0)
    g = n + 1 - plan.odd if P == 1 else n // 2
    vb = 8 if size == 2 else 16
    geo = dual._sum_geometry(P, outer, n_in, inner, g, mt, size,
                             all(e * size % vb == 0 for e in eoff))
    y = np.full((outer, P * g, inner), np.nan)
    cnt = np.zeros(y.shape, np.int64)
    refl = side is None
    if geo.path == "cols":
        _replay_cols(X, T, sw, P, mt, g, side or 0, refl, geo, y, cnt)
    else:
        assert geo.path == "rows"
        _replay_rows(X, T, sw, P, mt, g, side or 0, refl, geo, y, cnt,
                     size, eoff)
    assert (cnt == 1).all(), "an output written other than once"
    out = list(shape)
    out[ax] = P * g
    return y.reshape(out), geo


def _plain(name, xs, filters, axis, side):
    a, b = (torch.from_numpy(x) for x in xs)
    f = (filters if name == "filter2_sum"
         else (tuple(filters[:2]), tuple(filters[2:])))
    if side is None:
        ref = getattr(dual, name + "_axis_reference")(a, b, *f, axis)
    else:
        ref = getattr(dual, name + "_fromext_axis_reference")(a, b, side, *f,
                                                              axis)
    return ref.numpy()


def _filters(name, fam, seed=0):
    """The filter set of a case: a biort family's synthesis pair, the even
    pair of 4 and 6 taps, random odd or even filters of the longest
    lengths; a qshift family's inverse pairs (mixed: qshift_a's first,
    qshift_d's second), random pairs of 64 taps."""
    rs = np.random.RandomState(seed)
    if name == "filter2_sum":
        if fam == "even":
            return _EVEN
        if fam in ("odd31", "even32"):
            m = 31 if fam == "odd31" else 32
            return rs.randn(m), rs.randn(m)
        b = biort(fam)
        return b[1], b[3]
    if fam == "long64":
        return tuple(rs.randn(64) for _ in range(4))
    q0 = qshift("qshift_a" if fam == "mixed" else fam)
    q1 = qshift("qshift_d" if fam == "mixed" else fam)
    return q0[3], q0[2], q1[7], q1[6]


# (shape, axis): _DUAL_SHAPES of the card tests, the main-path views (inner
# 128, inner 1 past the staging target, inner H x W), partial last tiles
_SHAPES = [((8, 20, 36), -1), ((8, 20, 36), -2), ((8, 20, 36), -3),
           ((4, 8, 4), -1), ((4, 8, 4), -3), ((1028, 1), 0),
           ((12, 130), 0), ((40, 128), 0), ((9000,), 0),
           ((1, 16, 6, 6), -3), ((2, 70, 3), 1)]

_CASES = ([("filter2_sum", f) for f in ("near_sym_a", "near_sym_b",
                                         "antonini", "even", "odd31",
                                         "even32")]
          + [("ifilt2_sum", f) for f in ("qshift_a", "qshift_06",
                                         "qshift_32", "mixed", "long64")])


@pytest.fixture
def any_grid(monkeypatch):
    """Small grids keep their column vectors (``_FEW_BLOCKS`` 0), so that
    the replay's small shapes take the vector columns path too."""
    monkeypatch.setattr(dual, "_FEW_BLOCKS", 0)
    dual._sum_geometry.cache_clear()
    yield
    dual._sum_geometry.cache_clear()


@pytest.mark.parametrize("name,fam", _CASES)
def test_dual_sum_tiling_replay(any_grid, name, fam):
    """Both paths, both modes, every itemsize's tiling, aligned and odd
    element offsets, against the plain version at 1e-12."""
    f = _filters(name, fam)
    side = 40           # covers the 64-tap pairs' reach
    rs = np.random.RandomState(7)
    paths = set()
    for k, (shape, axis) in enumerate(_SHAPES):
        if name == "ifilt2_sum" and shape[axis] % 2:
            continue
        xs = [rs.rand(*shape) for _ in range(2)]
        size = (4, 2, 8)[k % 3]
        eoff = (0, 0, 0) if k % 2 else (1, 3, 1)
        for s in (None, side):
            ins = xs if s is None else [
                fb.symmetric_extend(torch.from_numpy(x), s, axis).numpy()
                for x in xs]
            got, geo = _replay(name, ins, f, axis, s, size, eoff)
            paths.add((geo.path, geo.vc > 1))
            want = _plain(name, ins, f, axis, s)
            assert got.shape == want.shape
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= 1e-12 * scale, (
                shape, axis, s, size, geo)
    assert paths == {("rows", False), ("cols", True), ("cols", False)}


def test_dual_sum_replay_fails_an_inverted_stream_order():
    """The replay sees a wrong parity: qshift_a's branch swaps inverted
    give a result off the plain version."""
    f = _filters("ifilt2_sum", "qshift_a")
    x = [np.random.RandomState(i).rand(12, 130) for i in range(2)]
    inv = dual._inv_taps

    def swapped(plans, P, mt):
        out = inv(plans, P, mt)
        return None if out is None else (out[0], [1 - v for v in out[1]])
    dual._inv_taps = swapped
    try:
        got, _ = _replay("ifilt2_sum", x, f, 0, None, 4)
    finally:
        dual._inv_taps = inv
    assert np.abs(got - _plain("ifilt2_sum", x, f, 0, None)).max() > 1e-3


@pytest.mark.parametrize("name,fams", [
    ("filter2_sum", {"legall": 5, "near_sym_a": 7, "antonini": 9,
                     "near_sym_b": 19, "even": 7, "odd31": 33,
                     "even32": 33}),
    ("ifilt2_sum", {"qshift_06": 5, "qshift_a": 5, "qshift_b": 7,
                    "qshift_c": 9, "qshift_d": 9, "qshift_32": 17,
                    "mixed": 9, "long64": 33})])
def test_dual_sum_tap_bounds(name, fams):
    """Each family's least tap bound (csrc/taps.cuh st_bound), none
    smaller holding it; filters of up to 32 taps a stream of either parity
    are taken and longer ones refused with ValueError, as before the
    redesign; the plan is cached by the filters' values."""
    P = 1 if name == "filter2_sum" else 4
    for fam, mt in fams.items():
        f = _filters(name, fam)
        plan = dual._sum_plan(name, f)
        assert plan.mt == mt, fam
        assert dual._sum_plan(name, tuple(np.copy(v) for v in f)) is plan
        smaller = [b for b in dual._SUM_BOUNDS[P] if b < mt]
        assert all(dual._inv_taps(plan.plans, P, b) is None
                   for b in smaller), fam
    rs = np.random.RandomState(1)
    if P == 1:
        for m in range(1, 41):
            f = (rs.randn(m), rs.randn(m))
            if m <= 32:
                assert dual._sum_plan(name, f).mt <= 33
            else:
                with pytest.raises(ValueError, match="at most 32 taps"):
                    dual._sum_plan(name, f)
    else:
        for m in range(2, 72, 2):
            f = tuple(rs.randn(m) for _ in range(4))
            if m <= 64:
                assert dual._sum_plan(name, f).mt <= 33
            else:
                with pytest.raises(ValueError, match="at most 32 taps"):
                    dual._sum_plan(name, f)


def test_dual_sum_geometry_main_path():
    """The tiling of every launch shape of the main paths: the 1-D
    [131072, 128] round trip's columns (16-byte vectors, 32 threads across
    the 128 columns; its three smallest ifilt levels, under 128 blocks, a
    column a thread), the 3-D 256^3 round trip's depth axis (64 threads
    across H x W, four group rows a block; float64 256 threads), the
    sharded one's shards and the 4M vector's staged segments."""
    geo = dual._sum_geometry
    g = geo(1, 1, 131072, 128, 131072, 7, 4, True)
    assert g == dual.SumGeometry("cols", 7, 8, 4, 1, 64, 32, (1, 2048, 1), 0)
    for k in range(7):
        n = 1024 << k
        g = geo(4, 1, n, 128, n // 2, 5, 4, True)
        if k < 3:
            assert (g.vc, g.tx, g.seg, g.grid) == (1, 64, 16,
                                                   (1, n // 32, 2))
        else:
            assert (g.path, g.vc, g.tx, g.seg, g.grid) == (
                "cols", 4, 32, 32, (1, n // 64, 1))
    g = geo(1, 1, 256, 65536, 256, 7, 4, True)
    assert g == dual.SumGeometry("cols", 7, 8, 4, 1, 32, 64, (1, 8, 256), 0)
    g = geo(1, 1, 256, 65536, 256, 7, 8, True)
    assert (g.vc, g.tx, g.seg, g.grid) == (2, 256, 8, (1, 32, 128))
    g = geo(4, 1, 128, 65536, 64, 5, 4, True)
    assert (g.v, g.vc, g.seg, g.grid) == (4, 4, 16, (1, 4, 256))
    g = geo(4, 1, 64, 16384, 32, 5, 4, True)
    assert (g.v, g.vc, g.seg, g.grid) == (4, 4, 16, (1, 2, 64))
    # the sharded round trip's shards (side 8): 64 and 16 blocks of vectors
    # become 256 and 64 of single columns
    g = geo(1, 1, 80, 65536, 64, 7, 4, True)
    assert (g.vc, g.grid) == (4, (1, 2, 256))
    assert geo(4, 1, 48, 16384, 16, 5, 4, True).grid == (1, 1, 256)
    assert geo(4, 1, 32, 4096, 8, 5, 4, True).grid == (1, 1, 64)
    # unaligned or ragged columns: one column a thread
    assert geo(1, 1, 256, 65536, 256, 7, 4, False).vc == 1
    assert geo(1, 1, 256, 130, 256, 7, 4, True).vc == 1
    assert geo(1, 1, 2048, 130, 2048, 7, 8, True).vc == 2
    # the vector: segments of 16 KB of each input, 16-byte items
    g = geo(1, 1, 4194304, 1, 4194304, 7, 4, True)
    assert g == dual.SumGeometry("rows", 7, 4, 1, 1, 4096, 1, (1, 1024),
                                 2 * 4108 * 4)
    g = geo(4, 1, 2097152, 1, 1048576, 5, 4, True)
    assert (g.v, g.seg, g.grid, g.smem) == (1, 2048, (1, 512),
                                            2 * 4108 * 4)
    assert geo(4, 1, 2097152, 1, 1048576, 5, 2, True).v == 2
    assert geo(4, 1, 2097152, 1, 1048576, 5, 8, True).v == 1
    # short rows: whole rows a block
    g = geo(4, 64, 100, 1, 50, 5, 4, True)
    assert (g.rows, g.seg, g.grid) == (40, 50, (2, 1))
