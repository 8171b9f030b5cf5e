"""The tiling of the stream kernels, the analysis entries ``filter2``
and ``dfilt2`` (``csrc/streamana.cuh``), the synthesis sums
``filter2_sum`` and ``ifilt2_sum`` (``csrc/streamsum.cuh``) and their
one-branch instances ``dfilt`` and ``ifilt`` (``csrc/single.cu``),
replayed on the CPU in numpy at float64.

The kernels cannot run here, so this replays, block by block, what
``ops/dual.py:_stream_geometry`` and ``_plan`` tell them to do.  On the
columns path (inner > 1): each thread's columns and groups, the rows
(qshift: row pairs) of the inputs its window loads, where each loaded row
reaches (the taps centred on the bound's halo; ifilt's parity swap, or
dfilt's taps placed by parity and each branch's swap applied at the
store), and the outputs it stores, a warp's lanes on consecutive columns.
On the rows path (inner = 1): each block's staging of a flat range of
each input (a head and a tail a value at a time, 16-byte chunks between,
every chunk aligned on both sides), each item's register windows (inside
the row, or read at the reflected index, or as zero past an extended
buffer, the clamp moving no read a stored output takes) and its vector or
scalar stores, to each output of an analysis entry, whose two branches
may differ in length (filter2's filters of two parities), and where one
branch reads its window in vectors, that the last stays in its region.  Every staged
cell must be written at most once, every cell a window reads must have
been written, every output sample written exactly once, and the result
must equal the plain versions (:func:`dual.filter2_axis_reference`,
:func:`dual.dfilt2_axis_reference`, :func:`dual.filter2_sum_axis_reference`,
:func:`dual.ifilt2_sum_axis_reference`, :func:`single.dfilt_axis_reference`,
:func:`single.ifilt_axis_reference` and their from-extension forms)
within 1e-12.  Edit the replay together with the kernels.  The file takes
about 18-24 s in one process, the analysis kernels' 17 tests (``-k
analysis``) about 7 s, the one-branch instances' 21 (``-k single``)
about 7-10 s.
"""

import numpy as np
import pytest
import torch

import dtcwt_tpu_torch as dt
from dtcwt_tpu_torch.coeffs import biort, qshift
from dtcwt_tpu_torch.ops import dual, fb, single

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
    nin = len(X)
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
        for bb in range(nin):
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
    nin = len(X)
    flat = [x.reshape(-1) for x in X]
    D, ph = (1 if P == 1 else 2), (mt - 1) // 2
    vec = 16 // size
    GV, R, L = geo.v, geo.rows, geo.seg
    NW = D * (GV + mt - 1)
    assert geo.vc == 1 and geo.tx == 1 and L % GV == 0
    assert geo.grid == (_cdiv(outer, R), _cdiv(g, L))
    n_seg = geo.grid[1]
    assert n_seg == 1 or R == 1
    rb = geo.smem // (nin * size)
    assert nin * rb * size == geo.smem and rb % vec == 0
    assert rb >= vec + (R - 1) * n_in + min(n_in, D * (L + mt - 1))
    vec_out = (P * g) % vec == 0 and (eoff[nin] * size) % 16 == 0
    for blk in range(geo.blocks):
        s0, o0 = (blk % n_seg) * L, (blk // n_seg) * R
        rows, lr = min(R, outer - o0), min(L, g - s0)
        j00 = D * (s0 - ph) + side
        sa, sb = max(j00, 0), min(n_in, j00 + D * (L + mt - 1))
        f0, ln = o0 * n_in + sa, (rows - 1) * n_in + (sb - sa)
        xs, pads = _Img(nin * rb), []
        for i in range(nin):
            pad = (eoff[i] + f0) * size % 16 // size
            head = min((vec - pad) % vec, ln)
            nvec = (ln - head) // vec
            dst0 = i * rb + pad
            xs.put(dst0 + np.arange(head), flat[i][f0:f0 + head])
            # the 16-byte chunks, each aligned on both sides
            e = head + vec * np.arange(nvec)
            assert ((dst0 + e) % vec == 0).all()               # shared side
            assert ((eoff[i] + f0 + e) * size % 16 == 0).all()  # device side
            xs.put(dst0 + head + np.arange(nvec * vec),
                   flat[i][f0 + head:f0 + head + nvec * vec])
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
            for bb in range(nin):
                base = bb * rb + pads[bb] - sa + r * n_in
                lo_c, hi_c = bb * rb + pads[bb], bb * rb + pads[bb] + ln - 1
                jj = _source(j, n_in, refl)
                jj = np.where(fast[:, None], j, jj)
                c = base + np.maximum(jj, 0)
                cc = np.clip(c, lo_c, hi_c)
                assert ((c == cc) | ~used | (jj < 0)).all()
                w = np.where(jj >= 0, xs.get(cc), 0.0)
                _fir(acc, T, sw, bb, w, P, mt, GV)
            # each item's outputs, its first nv; the whole ones as vectors
            nv = P * nvg
            start = (o0 + r) * P * g + P * (s0 + GV * q)  # flat indices
            if vec_out:
                vs = start[nv == GV * P, None] + vec * np.arange(GV * P // vec)
                assert ((eoff[nin] + vs) * size % 16 == 0).all()
            keep = np.arange(GV * P)[None, :] < nv[:, None]
            idx = (start[:, None] + np.arange(GV * P))[keep]
            np.add.at(cnt.reshape(-1), idx, 1)
            y.reshape(-1)[idx] = acc.reshape(items, GV * P)[keep]


def _replay(name, xs, filters, axis, side, size, eoff=(0, 0, 0)):
    """The kernel's result on the numpy inputs *xs* (the sums two, ifilt
    one) along *axis* (side: the from-extension mode), for elements of
    *size* bytes whose pointers sit *eoff* elements past 16-byte alignment
    (each input's, then the output's)."""
    P = 1 if name == "filter2_sum" else 4
    plan = dual._plan(name, filters)
    assert len(plan.plans) == len(xs)
    mt = plan.mt
    T, sw = dual._inv_taps(plan.plans, P, mt)
    ax = axis % xs[0].ndim
    shape = xs[0].shape
    outer = int(np.prod(shape[:ax], dtype=np.int64))
    inner = int(np.prod(shape[ax + 1:], dtype=np.int64))
    n_in = shape[ax]
    X = [x.reshape(outer, n_in, inner) for x in xs]
    n = n_in - 2 * (side or 0)
    g = n + 1 - plan.odd[0] if P == 1 else n // 2
    vb = 8 if size == 2 else 16
    geo = dual._stream_geometry(P, outer, n_in, inner, g, mt, size,
                                all(e * size % vb == 0 for e in eoff),
                                len(xs), len(xs))
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
    ts = [torch.from_numpy(x) for x in xs]
    mod = single if name == "ifilt" else dual
    f = (filters if name in ("filter2_sum", "ifilt")
         else (tuple(filters[:2]), tuple(filters[2:])))
    if side is None:
        ref = getattr(mod, name + "_axis_reference")(*ts, *f, axis)
    else:
        ref = getattr(mod, name + "_fromext_axis_reference")(*ts, side, *f,
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
    dual._stream_geometry.cache_clear()
    yield
    dual._stream_geometry.cache_clear()


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
        plan = dual._plan(name, f)
        assert plan.mt == mt, fam
        assert dual._plan(name, tuple(np.copy(v) for v in f)) is plan
        smaller = [b for b in dual._TAP_BOUNDS[P] if b < mt]
        assert all(dual._inv_taps(plan.plans, P, b) is None
                   for b in smaller), fam
    rs = np.random.RandomState(1)
    if P == 1:
        for m in range(1, 41):
            f = (rs.randn(m), rs.randn(m))
            if m <= 32:
                assert dual._plan(name, f).mt <= 33
            else:
                with pytest.raises(ValueError, match="at most 32 taps"):
                    dual._plan(name, f)
    else:
        for m in range(2, 72, 2):
            f = tuple(rs.randn(m) for _ in range(4))
            if m <= 64:
                assert dual._plan(name, f).mt <= 33
            else:
                with pytest.raises(ValueError, match="at most 32 taps"):
                    dual._plan(name, f)


def test_dual_sum_geometry_main_path():
    """The tiling of every launch shape of the main paths: the 1-D
    [131072, 128] round trip's columns (16-byte vectors, 32 threads across
    the 128 columns; its four smallest ifilt levels, under 132 blocks, a
    column a thread), the 3-D 256^3 round trip's depth axis (64 threads
    across H x W, four group rows a block; float64 256 threads), the
    sharded one's shards and the 4M vector's staged segments."""
    geo = dual._stream_geometry
    g = geo(1, 1, 131072, 128, 131072, 7, 4, True)
    assert g == dual.StreamGeometry("cols", 7, 8, 4, 1, 64, 32,
                                    (1, 2048, 1), 0)
    for k in range(7):
        n = 1024 << k
        g = geo(4, 1, n, 128, n // 2, 5, 4, True)
        if k < 4:
            assert (g.vc, g.tx, g.seg, g.grid) == (1, 64, 16,
                                                   (1, n // 32, 2))
        else:
            assert (g.path, g.vc, g.tx, g.seg, g.grid) == (
                "cols", 4, 32, 32, (1, n // 64, 1))
    g = geo(1, 1, 256, 65536, 256, 7, 4, True)
    assert g == dual.StreamGeometry("cols", 7, 8, 4, 1, 32, 64, (1, 8, 256), 0)
    g = geo(1, 1, 256, 65536, 256, 7, 8, True)
    assert (g.vc, g.tx, g.seg, g.grid) == (2, 256, 8, (1, 32, 128))
    g = geo(4, 1, 128, 65536, 64, 5, 4, True)
    assert (g.v, g.vc, g.seg, g.grid) == (4, 4, 16, (1, 4, 256))
    g = geo(4, 1, 64, 16384, 32, 5, 4, True)
    assert (g.v, g.vc, g.seg, g.grid) == (4, 1, 16, (1, 2, 256))
    # the sharded round trip's shards (side 8): 64 and 16 blocks of vectors
    # become 256 and 64 of single columns
    g = geo(1, 1, 80, 65536, 64, 7, 4, True)
    assert (g.vc, g.grid) == (4, (1, 2, 256))
    assert geo(4, 1, 48, 16384, 16, 5, 4, True).grid == (1, 1, 256)
    assert geo(4, 1, 32, 4096, 8, 5, 4, True).grid == (1, 1, 64)
    # unaligned or ragged columns: one column a thread
    assert geo(1, 1, 256, 65536, 256, 7, 4, False).vc == 1
    assert geo(1, 1, 256, 130, 256, 7, 4, True).vc == 1
    assert geo(1, 1, 4096, 130, 4096, 7, 8, True).vc == 2
    # the vector: segments of 16 KB of each input, 16-byte items
    g = geo(1, 1, 4194304, 1, 4194304, 7, 4, True)
    assert g == dual.StreamGeometry("rows", 7, 4, 1, 1, 4096, 1, (1, 1024),
                                 2 * 4108 * 4)
    g = geo(4, 1, 2097152, 1, 1048576, 5, 4, True)
    assert (g.v, g.seg, g.grid, g.smem) == (1, 2048, (1, 512),
                                            2 * 4108 * 4)
    assert geo(4, 1, 2097152, 1, 1048576, 5, 2, True).v == 2
    assert geo(4, 1, 2097152, 1, 1048576, 5, 8, True).v == 1
    # short rows: whole rows a block
    g = geo(4, 64, 100, 1, 50, 5, 4, True)
    assert (g.rows, g.seg, g.grid) == (40, 50, (2, 1))


# ---------------------------------------------------------------------------
# the analysis entries, filter2 and dfilt2 (csrc/streamana.cuh)
# ---------------------------------------------------------------------------

def _ana_taps(plan, P):
    """The kernel's taps: the plans centred on the bound's halo, dfilt's
    placed by parity (csrc/taps.cuh hs_taps_by_parity: a branch whose
    first stream reads the odd samples has its streams swapped), and the
    branch swaps."""
    T, sw = dual._inv_taps(plan.plans, P, plan.mt)
    if P == 2:
        T = np.stack([T[b, ::-1] if sw[b] else T[b] for b in range(len(T))])
    return T, sw


def _ana_fir(acc, T, b, w, P, mt, nv):
    """Branch b's taps over windows w [items, samples] into acc [items,
    nv groups, P], acc[..., p] the sum of parity p (dfilt)."""
    for m in range(mt):
        for v in range(nv):
            if P == 1:
                acc[:, v, 0] += T[b, 0, m] * w[:, v + m]
            else:
                for p in range(2):
                    acc[:, v, p] += T[b, p, m] * w[:, 4 * v + p + 2 * m]


def _replay_ana_cols(X, T, sw, P, mt, gs, side, refl, geo, ys, cnts):
    outer, n_in, inner = X.shape
    D, S = dual._STEPS[P]
    ph = (mt - 1) // 2
    RV, VC, TX = geo.v, geo.vc, geo.tx
    TY = _THREADS // TX
    gn = max(gs)
    assert geo.seg == TY * RV and geo.rows == 1 and geo.smem == 0
    assert geo.grid == (outer, _cdiv(gn, geo.seg), _cdiv(inner, TX * VC))
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
    live = (col < inner) & (g0 < gn)
    o, col, g0 = o[live], col[live], g0[live]
    cols = col[:, None] + np.arange(VC)
    assert (cols < inner).all()   # a vector stays inside the row
    j0 = D * g0 - S * ph + side
    nb = len(gs)
    acc = np.zeros((nb, o.size, RV, P, VC))
    loaded = []                   # the window rows a thread loads

    def load(j):
        loaded.append(j)
        jj = _source(j, n_in, refl)
        val = X[o[:, None], np.maximum(jj, 0)[:, None], cols]
        return np.where((jj >= 0)[:, None], val, 0.0)

    if P == 1:
        for r in range(RV + mt - 1):
            w = load(j0 + r)
            for b in range(nb):
                for v in range(RV):
                    if 0 <= r - v < mt:
                        acc[b, :, v, 0] += T[b, 0, r - v] * w
    else:
        for r in range(2 * RV + mt - 2):
            e, od = load(j0 + 2 * r), load(j0 + 2 * r + 1)
            for b in range(nb):
                for v in range(RV):
                    m = r - 2 * v
                    if 0 <= m < mt:
                        acc[b, :, v, 0] += T[b, 0, m] * e
                        acc[b, :, v, 1] += T[b, 1, m] * od
    # each thread loads each row of its window once, the whole window
    rows = np.stack(loaded, 1) - j0[:, None]
    assert (np.sort(rows, 1) == np.arange(rows.shape[1])).all()
    assert rows.shape[1] == D * (RV - 1) + S * mt
    for b in range(nb):
        for v in range(RV):
            ok = g0 + v < gs[b]
            for p in range(P):
                row = P * (g0[ok] + v) + (p ^ (sw[b] if P == 2 else 0))
                idx = (o[ok][:, None], row[:, None], cols[ok])
                np.add.at(cnts[b], idx, 1)
                ys[b][idx] = acc[b, ok, v, p]


def _replay_ana_rows(X, T, sw, P, mt, gs, side, refl, geo, ys, cnts, size,
                     eoff):
    outer, n_in, inner = X.shape
    assert inner == 1
    flat = X.reshape(-1)
    D, S = dual._STEPS[P]
    ph = (mt - 1) // 2
    vec = 16 // size
    GV, R, L = geo.v, geo.rows, geo.seg
    NW = D * (GV - 1) + S * mt
    gn = max(gs)
    assert geo.vc == 1 and geo.tx == 1 and L % GV == 0 and GV * P % vec == 0
    assert geo.grid == (_cdiv(outer, R), _cdiv(gn, L))
    n_seg = geo.grid[1]
    assert n_seg == 1 or R == 1
    rb = geo.smem // size
    assert rb * size == geo.smem and rb % vec == 0
    assert rb >= vec + (R - 1) * n_in + min(n_in, D * (L - 1) + S * mt)
    vec_out = [(P * g) % vec == 0 and (eoff[1 + b] * size) % 16 == 0
               for b, g in enumerate(gs)]
    for blk in range(geo.blocks):
        s0, o0 = (blk % n_seg) * L, (blk // n_seg) * R
        rows, lr = min(R, outer - o0), min(L, gn - s0)
        j00 = D * s0 - S * ph + side
        sa, sb = max(j00, 0), min(n_in, j00 + D * (L - 1) + S * mt)
        f0, ln = o0 * n_in + sa, (rows - 1) * n_in + (sb - sa)
        # the staging: a head and a tail a value at a time, 16-byte chunks
        # between, each chunk aligned on both sides
        xs = _Img(rb)
        pad = (eoff[0] + f0) * size % 16 // size
        head = min((vec - pad) % vec, ln)
        nvec = (ln - head) // vec
        xs.put(pad + np.arange(head), flat[f0:f0 + head])
        e = head + vec * np.arange(nvec)
        assert ((pad + e) % vec == 0).all()                   # shared side
        assert ((eoff[0] + f0 + e) * size % 16 == 0).all()     # device side
        xs.put(pad + head + np.arange(nvec * vec),
               flat[f0 + head:f0 + head + nvec * vec])
        e = head + nvec * vec
        xs.put(pad + np.arange(e, ln), flat[f0 + e:f0 + ln])
        assert pad + ln <= rb and xs.n.max() <= 1
        items = _cdiv(lr, GV)
        lo, hi = -j00, n_in - NW - j00
        q_lo = min(items, _cdiv(lo, D * GV)) if lo > 0 else 0
        q_hi = max(q_lo, min(items, 0 if hi < 0 else hi // (D * GV) + 1))
        q = np.arange(items)
        fast = (q >= q_lo) & (q < q_hi)
        j = (j00 + D * GV * q)[:, None] + np.arange(NW)
        assert ((j[fast] >= 0) & (j[fast] < n_in)).all()
        gq = s0 + GV * q
        # each branch's stored groups of an item, and the window samples
        # the stored outputs take
        nvg = [np.clip(min(g, s0 + lr) - gq, 0, GV) for g in gs]
        top = np.max(nvg, 0)
        used = np.arange(NW)[None, :] < (D * (top - 1) + S * mt)[:, None]
        jj = np.where(fast[:, None], j, _source(j, n_in, refl))
        for r in range(rows):
            c = pad - sa + r * n_in + np.maximum(jj, 0)
            cc = np.clip(c, pad, pad + ln - 1)
            assert ((c == cc) | ~used | (jj < 0)).all()
            if len(gs) == 1:
                # one branch: an item inside its row that starts on a
                # vector reads whole vectors, its last inside the region
                vec_item = fast & (c[:, 0] % vec == 0)
                assert (_cdiv(c[vec_item, -1] + 1, vec) * vec <= rb).all()
            w = np.where(jj >= 0, xs.get(cc), 0.0)
            for b in range(len(gs)):
                acc = np.zeros((items, GV, P))
                _ana_fir(acc, T, b, w, P, mt, GV)
                if P == 2 and sw[b]:
                    acc = acc[:, :, ::-1]
                # each item's outputs, its first nv; the whole ones as
                # vectors
                nv = P * nvg[b]
                start = (o0 + r) * P * gs[b] + P * gq   # flat output index
                if vec_out[b]:
                    assert ((eoff[1 + b] + start[nv == GV * P]) * size
                            % 16 == 0).all()
                keep = np.arange(GV * P)[None, :] < nv[:, None]
                idx = (start[:, None] + np.arange(GV * P))[keep]
                np.add.at(cnts[b].reshape(-1), idx, 1)
                ys[b].reshape(-1)[idx] = acc.reshape(items, GV * P)[keep]


def _replay_ana(name, x, filters, axis, side, size, eoff=(0, 0, 0)):
    """The analysis kernel's outputs on the numpy input *x* along *axis*
    (side: the from-extension mode), a branch each (filter2 and dfilt2
    two, dfilt one), for elements of *size* bytes whose pointers sit *eoff*
    elements past 16-byte alignment (x, then each output)."""
    P = 1 if name == "filter2" else 2
    plan = dual._plan(name, filters)
    nb = len(plan.plans)
    T, sw = _ana_taps(plan, P)
    ax = axis % x.ndim
    outer = int(np.prod(x.shape[:ax], dtype=np.int64))
    inner = int(np.prod(x.shape[ax + 1:], dtype=np.int64))
    n_in = x.shape[ax]
    X = x.reshape(outer, n_in, inner)
    n = n_in - 2 * (side or 0)
    gs = [n + 1 - o for o in plan.odd] if P == 1 else [n // 4] * nb
    vb = 8 if size == 2 else 16
    geo = dual._stream_geometry(P, outer, n_in, inner, max(gs), plan.mt,
                                size, all(e * size % vb == 0 for e in eoff),
                                1, nb)
    ys = [np.full((outer, P * g, inner), np.nan) for g in gs]
    cnts = [np.zeros(y.shape, np.int64) for y in ys]
    refl = side is None
    if geo.path == "cols":
        _replay_ana_cols(X, T, sw, P, plan.mt, gs, side or 0, refl, geo, ys,
                         cnts)
    else:
        assert geo.path == "rows"
        _replay_ana_rows(X, T, sw, P, plan.mt, gs, side or 0, refl, geo, ys,
                         cnts, size, eoff)
    outs = []
    for y, cnt in zip(ys, cnts):
        assert (cnt == 1).all(), "an output written other than once"
        shape = list(x.shape)
        shape[ax] = y.shape[1]
        outs.append(y.reshape(shape))
    return outs, geo


def _ana_plain(name, x, filters, axis, side):
    t = torch.from_numpy(x)
    mod = single if name == "dfilt" else dual
    f = (filters if name in ("filter2", "dfilt")
         else (tuple(filters[:2]), tuple(filters[2:])))
    if side is None:
        ref = getattr(mod, name + "_axis_reference")(t, *f, axis)
    else:
        ref = getattr(mod, name + "_fromext_axis_reference")(t, side, *f,
                                                             axis)
    return [r.numpy() for r in (ref if isinstance(ref, tuple) else (ref,))]


# the mixed-parity pair of filter2: 7 and 6 taps (outputs n and n + 1)
_MIXED = (biort("near_sym_a")[2], _EVEN[1])


def _ana_filters(name, fam, seed=0):
    """The filter set of an analysis case: a biort family's analysis pair,
    the even pair of 4 and 6 taps, the mixed-parity pair, random filters
    of 31 or 32 taps; a qshift family's decimating pairs (mixed: qshift_a's
    first, qshift_d's second), random pairs of 32 taps with sum(ha hb) of
    either sign ("long32": positive then negative, "long32n" the
    reverse)."""
    rs = np.random.RandomState(seed)
    if name == "filter2":
        if fam == "even":
            return _EVEN
        if fam == "mixed":
            return _MIXED
        if fam in ("odd31", "even32"):
            m = 31 if fam == "odd31" else 32
            return rs.randn(m), rs.randn(m)
        b = biort(fam)
        return b[0], b[2]
    if fam.startswith("long32"):
        pairs = []
        for sign in ((1, -1) if fam == "long32" else (-1, 1)):
            ha, hb = rs.randn(32), rs.randn(32)
            if np.sign(np.sum(ha * hb)) != sign:
                hb = -hb
            pairs += [ha, hb]
        return tuple(pairs)
    q0 = qshift("qshift_a" if fam == "mixed" else fam)
    q1 = qshift("qshift_d" if fam == "mixed" else fam)
    return q0[1], q0[0], q1[5], q1[4]


_ANA_CASES = ([("filter2", f) for f in ("near_sym_a", "near_sym_b",
                                         "legall", "even", "mixed",
                                         "odd31", "even32")]
              + [("dfilt2", f) for f in ("qshift_a", "qshift_d",
                                          "qshift_32", "mixed", "long32",
                                          "long32n")])


@pytest.mark.parametrize("name,fam", _ANA_CASES)
def test_dual_analysis_tiling_replay(any_grid, name, fam):
    """Both paths, both modes, every itemsize's tiling, aligned and odd
    element offsets, both outputs against the plain version at 1e-12."""
    f = _ana_filters(name, fam)
    side = 32           # covers the 32-tap filters' reach
    rs = np.random.RandomState(8)
    paths = set()
    for k, (shape, axis) in enumerate(_SHAPES):
        if name == "dfilt2" and shape[axis] % 4:
            continue
        x = rs.rand(*shape)
        size = (4, 2, 8)[k % 3]
        eoff = (0, 0, 0) if k % 2 else (1, 3, 1)
        for s in (None, side):
            ins = x if s is None else fb.symmetric_extend(
                torch.from_numpy(x), s, axis).numpy()
            got, geo = _replay_ana(name, ins, f, axis, s, size, eoff)
            paths.add((geo.path, geo.vc > 1))
            for g, w in zip(got, _ana_plain(name, ins, f, axis, s)):
                assert g.shape == w.shape
                assert np.abs(g - w).max() <= 1e-12 * np.abs(w).max(), (
                    shape, axis, s, size, geo)
    assert paths == {("rows", False), ("cols", True), ("cols", False)}


def test_dual_analysis_replay_fails_an_inverted_stream_order():
    """The replay sees a wrong parity: the branch swaps of the mixed
    qshift pairs inverted give outputs off the plain version, on both
    paths."""
    f = _ana_filters("dfilt2", "mixed")
    inv = dual._inv_taps

    def swapped(plans, P, mt):
        out = inv(plans, P, mt)
        return None if out is None else (out[0], [1 - v for v in out[1]])
    for shape in ((12, 128), (1028,)):
        x = np.random.RandomState(2).rand(*shape)
        dual._inv_taps = swapped
        try:
            got, _ = _replay_ana("dfilt2", x, f, 0, None, 4)
        finally:
            dual._inv_taps = inv
        want = _ana_plain("dfilt2", x, f, 0, None)
        for g, w in zip(got, want):
            assert np.abs(g - w).max() > 1e-3


@pytest.mark.parametrize("name,fams", [
    ("filter2", {"legall": 5, "near_sym_a": 7, "antonini": 9,
                 "near_sym_b": 19, "even": 7, "mixed": 7, "odd31": 33,
                 "even32": 33}),
    ("dfilt2", {"qshift_06": 10, "qshift_a": 10, "qshift_b": 14,
                "qshift_c": 16, "qshift_d": 18, "qshift_32": 32,
                "mixed": 18, "long32": 32, "long32n": 32})])
def test_dual_analysis_tap_bounds(name, fams):
    """Each family's least tap bound (csrc/taps.cuh st_bound), none
    smaller holding it; the filters taken before the redesign are taken
    (filter2: up to 32 taps of either parity, the two branches of either
    parity each; dfilt2: qshift pairs of up to 32 taps) and longer ones
    refused with ValueError, as before; the plan is cached by the
    filters' values."""
    P = 1 if name == "filter2" else 2
    for fam, mt in fams.items():
        if fam in ("legall", "antonini"):
            b = biort(fam)
            f = (b[0], b[2])
        elif fam.startswith("qshift") and fam not in ("qshift_a",
                                                      "qshift_d",
                                                      "qshift_32"):
            q = qshift(fam)
            f = (q[1], q[0], q[5], q[4])
        else:
            f = _ana_filters(name, fam)
        plan = dual._plan(name, f)
        assert plan.mt == mt, fam
        assert dual._plan(name, tuple(np.copy(v) for v in f)) is plan
        smaller = [b for b in dual._TAP_BOUNDS[P] if b < mt]
        assert all(dual._inv_taps(plan.plans, P, b) is None
                   for b in smaller), fam
    rs = np.random.RandomState(3)
    if P == 1:
        for m0 in range(1, 41):
            for m1 in (m0, max(1, m0 - 1)):
                f = (rs.randn(m0), rs.randn(m1))
                if m0 <= 32:
                    assert dual._plan(name, f).mt <= 33
                else:
                    with pytest.raises(ValueError, match="at most 32 taps"):
                        dual._plan(name, f)
    else:
        for m in range(2, 42, 2):
            f = tuple(rs.randn(m) for _ in range(4))
            if m <= 32:
                assert dual._plan(name, f).mt <= 32
            else:
                with pytest.raises(ValueError, match="at most 32 taps"):
                    dual._plan(name, f)


def test_dual_analysis_geometry_main_path():
    """The tiling of every launch shape of the main paths, one input
    staged: the 1-D [131072, 128] round trip's columns (filter2: 16-byte
    vectors, 32 threads across the 128 columns, 4 outputs a thread;
    dfilt2: 2 groups of 2 a thread; its levels under 132 blocks a column a
    thread), the 3-D 256^3 round trip's depth axis (64 threads across H x
    W; float64 256), the sharded shards (a vector grid of 128 blocks, under
    one an SM, a column a thread) and the 4M vector's staged segments."""
    geo = dual._stream_geometry
    g = geo(1, 1, 131072, 128, 131072, 7, 4, True, 1)
    assert g == dual.StreamGeometry("cols", 7, 4, 4, 1, 32, 32,
                                    (1, 4096, 1), 0)
    for k in range(7):
        n = 131072 >> k
        g = geo(2, 1, n, 128, n // 4, 10, 4, True, 1)
        if n // 4 // 16 >= 132:
            assert (g.v, g.vc, g.tx, g.seg, g.grid) == (
                2, 4, 32, 16, (1, n // 64, 1))
        else:
            assert (g.v, g.vc, g.tx, g.seg, g.grid) == (
                2, 1, 64, 8, (1, n // 32, 2))
    g = geo(1, 1, 256, 65536, 256, 7, 4, True, 1)
    assert g == dual.StreamGeometry("cols", 7, 4, 4, 1, 16, 64,
                                    (1, 16, 256), 0)
    g = geo(2, 1, 256, 65536, 64, 10, 4, True, 1)
    assert g == dual.StreamGeometry("cols", 10, 2, 4, 1, 8, 64,
                                    (1, 8, 256), 0)
    assert geo(2, 1, 128, 16384, 32, 10, 4, True, 1).grid == (1, 4, 64)
    g = geo(2, 1, 256, 65536, 64, 10, 8, True, 1)
    assert (g.vc, g.tx, g.seg, g.grid) == (2, 256, 2, (1, 32, 128))
    # the sharded shards (side 8 and 16): vectors kept; 128 vector blocks
    # become 256 of single columns
    assert geo(1, 1, 80, 65536, 64, 7, 4, True, 1).grid == (1, 4, 256)
    g = geo(2, 1, 96, 16384, 16, 10, 4, True, 1)
    assert (g.vc, g.grid) == (1, (1, 2, 256))
    # the vector: segments of 16 KB of the one input, 16-byte items
    g = geo(1, 1, 4194304, 1, 4194304, 7, 4, True, 1)
    assert g == dual.StreamGeometry("rows", 7, 4, 1, 1, 4096, 1, (1, 1024),
                                    4108 * 4)
    g = geo(2, 1, 4194304, 1, 1048576, 10, 4, True, 1)
    assert g == dual.StreamGeometry("rows", 10, 2, 1, 1, 1024, 1,
                                    (1, 1024), 4116 * 4)
    assert geo(2, 1, 4194304, 1, 1048576, 10, 2, True, 1).v == 4
    assert geo(2, 1, 4194304, 1, 1048576, 10, 8, True, 1).v == 1
    # short rows: whole rows a block
    g = geo(2, 64, 100, 1, 25, 10, 4, True, 1)
    assert (g.rows, g.seg, g.grid) == (40, 26, (2, 1))


# ---------------------------------------------------------------------------
# single's one-branch entries, dfilt (csrc/streamana.cuh, NB = 1) and ifilt
# (csrc/streamsum.cuh, NIN = 1), exported by csrc/single.cu
# ---------------------------------------------------------------------------

def _single_sets(name, fam, seed=0):
    """The pairs of a one-branch case, each in both tap orders: a qshift
    family's two decimating pairs (dfilt: (h0b, h0a), (h1b, h1a)) or
    interpolating pairs (ifilt: (g0b, g0a), (g1b, g1a)), sum(ha hb)
    positive for the first and negative for the second; "long": random
    pairs of the longest length (dfilt 32 taps, ifilt 64) with sum(ha hb)
    of either sign."""
    if fam == "long":
        rs = np.random.RandomState(seed)
        m = 32 if name == "dfilt" else 64
        pairs = []
        for sign in (1, -1):
            ha, hb = rs.randn(m), rs.randn(m)
            if np.sign(np.sum(ha * hb)) != sign:
                hb = -hb
            pairs.append((ha, hb))
    else:
        q = qshift(fam)
        first = 0 if name == "dfilt" else 2
        pairs = [(q[first + 1], q[first]), (q[first + 5], q[first + 4])]
    return [p for ha, hb in pairs for p in ((ha, hb), (hb, ha))]


def _single_replay(name, x, f, axis, side, size, eoff):
    """(output, geometry) of dfilt's or ifilt's kernel on the numpy input
    *x*: the analysis replay with one branch, or the sums' with one
    input."""
    if name == "dfilt":
        got, geo = _replay_ana(name, x, f, axis, side, size, eoff)
        assert len(got) == 1
        return got[0], geo
    return _replay(name, [x], f, axis, side, size, eoff)


def _single_plain(name, x, f, axis, side):
    if name == "dfilt":
        return _ana_plain(name, x, f, axis, side)[0]
    return _plain(name, [x], f, axis, side)


# _SHAPES, and the low-level path's 4096^2 calls cut to 256 columns (the
# columns view, inner 256; the rows view, inner 1, a block of whole rows),
# and partial last tiles of both paths: columns tiles partial across inner
# and along the axis, the last block of whole rows partial, and segments
# of a long row whose last is partial
_SINGLE_SHAPES = _SHAPES + [((64, 256), 0), ((16, 256), -1),
                            ((3, 72, 136), -2), ((45, 100), -1),
                            ((3, 5000), -1)]
_SINGLE_CASES = [(n, f) for n in ("dfilt", "ifilt")
                 for f in dt.QSHIFT_NAMES + ("long",)]


@pytest.mark.parametrize("name,fam", _SINGLE_CASES)
def test_single_stream_tiling_replay(any_grid, name, fam):
    """Both paths, both modes, every itemsize's tiling, aligned and odd
    element offsets, each pair in both tap orders (both stream orders)
    taking the shapes in turn, against the plain version at 1e-12."""
    sets = _single_sets(name, fam)
    side = 40           # covers the 64-tap pairs' reach
    step = 4 if name == "dfilt" else 2
    rs = np.random.RandomState(9)
    paths = set()
    for k, (shape, axis) in enumerate(_SINGLE_SHAPES):
        if shape[axis] % step:
            continue
        f = sets[k % len(sets)]
        x = rs.rand(*shape)
        size = (4, 2, 8)[k % 3]
        eoff = (0, 0) if k % 2 else (1, 3)
        for s in (None, side):
            ins = x if s is None else fb.symmetric_extend(
                torch.from_numpy(x), s, axis).numpy()
            got, geo = _single_replay(name, ins, f, axis, s, size, eoff)
            paths.add((geo.path, geo.vc > 1))
            want = _single_plain(name, ins, f, axis, s)
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max(), (
                shape, axis, s, size, geo)
    assert paths == {("rows", False), ("cols", True), ("cols", False)}


@pytest.mark.parametrize("name", ["dfilt", "ifilt"])
def test_single_stream_replay_fails_an_inverted_stream_order(name):
    """The replay sees a wrong parity: qshift_a's pairs with their branch
    swap inverted give a result off the plain version, on both paths and
    for both signs of sum(ha hb)."""
    inv = dual._inv_taps

    def swapped(plans, P, mt):
        out = inv(plans, P, mt)
        return None if out is None else (out[0], [1 - v for v in out[1]])
    sets = _single_sets(name, "qshift_a")
    for f in (sets[0], sets[2]):
        for shape in ((12, 128), (1028,)):
            x = np.random.RandomState(2).rand(*shape)
            dual._inv_taps = swapped
            try:
                got, _ = _single_replay(name, x, f, 0, None, 4, (0, 0))
            finally:
                dual._inv_taps = inv
            want = _single_plain(name, x, f, 0, None)
            assert np.abs(got - want).max() > 1e-3, (f[0].size, shape)


@pytest.mark.parametrize("name,fams", [
    ("dfilt", {"qshift_06": 10, "qshift_a": 10, "qshift_b": 14,
               "qshift_c": 16, "qshift_d": 18, "qshift_b_bp": 14,
               "qshift_32": 32, "long": 32}),
    ("ifilt", {"qshift_06": 5, "qshift_a": 5, "qshift_b": 7,
               "qshift_c": 9, "qshift_d": 9, "qshift_b_bp": 7,
               "qshift_32": 17, "long": 33})])
def test_single_stream_tap_bounds(name, fams):
    """Each family's least tap bound (csrc/taps.cuh st_bound: dfilt
    hs_bound<2>, ifilt hs_bound<4>), in both tap orders, none smaller
    holding it; the pairs taken before the redesign are taken (dfilt
    qshift pairs of up to 32 taps, ifilt of up to 64) and longer ones
    refused with ValueError, as before; the plan, one branch, is cached by
    the filters' values."""
    P = 2 if name == "dfilt" else 4
    for fam, mt in fams.items():
        for f in _single_sets(name, fam):
            plan = dual._plan(name, f)
            assert len(plan.plans) == 1 and plan.taps.shape == (1, P, 32)
            assert plan.mt == mt, fam
            assert dual._plan(name, tuple(np.copy(v) for v in f)) is plan
            assert all(dual._inv_taps(plan.plans, P, b) is None
                       for b in dual._TAP_BOUNDS[P] if b < mt), fam
    rs = np.random.RandomState(4)
    for m in range(2, 72, 2):
        f = (rs.randn(m), rs.randn(m))
        if m <= (32 if name == "dfilt" else 64):
            want = 32 if name == "dfilt" else 33
            assert dual._plan(name, f).mt <= want
            assert dual._plan(name, f[::-1]).mt <= want
        else:
            with pytest.raises(ValueError, match="at most 32 taps"):
                dual._plan(name, f)
    # the refusal sits where it did: the host table, for 34-tap dfilt and
    # 66-tap ifilt pairs
    m = 34 if name == "dfilt" else 66
    streams = dual.dfilt_streams if name == "dfilt" else dual.ifilt_streams
    with pytest.raises(ValueError, match="at most 32 taps"):
        dual._table([streams(rs.randn(m), rs.randn(m))])


def test_single_stream_geometry_low_level_path():
    """The tiling of the low-level path's 4096^2 calls, and the groups a
    columns-path thread by (streams, inputs, branches): coldfilt and
    colifilt take 16-byte vectors, 64 threads across the 4096 columns and
    2 groups a thread, dfilt's under a key of its own beside dfilt2's and
    ifilt's beside ifilt2_sum's (4); rowdfilt and rowifilt a block a row of
    16 KB staged, 16-byte items; bfloat16 and float64 likewise."""
    assert dual._COL_GROUPS == {(1, 1, 2): 4, (2, 1, 2): 2, (1, 2, 2): 8,
                                (4, 2, 2): 4, (2, 1, 1): 2, (4, 1, 1): 2}
    geo = dual._stream_geometry
    N = 4096
    g = geo(2, 1, N, N, N // 4, 10, 4, True, 1, 1)
    assert g == dual.StreamGeometry("cols", 10, 2, 4, 1, 8, 64,
                                    (1, 128, 16), 0)
    g = geo(4, 1, N, N, N // 2, 5, 4, True, 1, 1)
    assert g == dual.StreamGeometry("cols", 5, 2, 4, 1, 8, 64,
                                    (1, 256, 16), 0)
    assert geo(4, 1, N, N, N // 2, 5, 4, True).v == 4     # ifilt2_sum
    g = geo(2, N, N, 1, N // 4, 10, 4, True, 1, 1)
    assert g == dual.StreamGeometry("rows", 10, 2, 1, 1, 1024, 1, (N, 1),
                                    4100 * 4)
    g = geo(4, N, N, 1, N // 2, 5, 4, True, 1, 1)
    assert g == dual.StreamGeometry("rows", 5, 1, 1, 1, 2048, 1, (N, 1),
                                    4100 * 4)
    # bfloat16: 8-byte column vectors, 16-byte items; float64: 256 threads
    # across inner, and rows of 32 KB staged in segments
    g = geo(2, 1, N, N, N // 4, 10, 2, True, 1, 1)
    assert (g.vc, g.tx, g.seg, g.grid) == (4, 64, 8, (1, 128, 16))
    assert geo(2, N, N, 1, N // 4, 10, 2, True, 1, 1).v == 4
    g = geo(4, 1, N, N, N // 2, 5, 8, True, 1, 1)
    assert (g.vc, g.tx, g.seg, g.grid) == (2, 256, 2, (1, 1024, 8))
    g = geo(4, N, N, 1, N // 2, 5, 8, True, 1, 1)
    assert (g.v, g.rows, g.seg, g.grid) == (1, 1, 1024, (N, 2))
    # unaligned or ragged columns: one column a thread
    assert geo(2, 1, N, N, N // 4, 10, 4, False, 1, 1).vc == 1
    assert geo(4, 1, 256, 130, 128, 5, 4, True, 1, 1).vc == 1
