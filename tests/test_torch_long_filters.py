"""Filters of any length: the port's long-filter route on the CPU.

* ``Transform3d(device="cpu")`` and ``ShardedTransform3d`` on a CPU mesh
  take level-1 filters of 33 to 129 taps (they refused 32 or more before
  the route existed) and agree with ``dtcwt_tpu.Transform3d``; the 1-D and
  2-D transforms take the same random long families.  Float64, every
  pyramid leaf and the inverse, within 1e-12 of the largest reference
  value.  The families are seeded random taps, none of them zero (a
  zero-padded published filter hides a tap offset), of odd biort lengths
  33 to 131 and even qshift lengths 34, 36, 64 and 130, and include
  filters longer than the axis they filter.
* The route rule (``_build.within_bound``) at each bound's edge: a length
  at the bound stays on the wrapper's own kernel, whose host planning
  accepts it, and the next length takes the long route, where that
  planning refuses it.
* A replay of ``csrc/longfir.cu``'s index map: :class:`_Replay` stands in
  for the kernel library and runs the kernel's arithmetic thread by thread
  of every block on host memory (the path and tiling checks of the C
  entry, the block decomposition, each thread's columns and groups, the
  chunk loop over each slot's zero-padded taps, the rows path's staging
  rounds with the fold once a staged sample, the from-extension shift),
  checking that every output is written exactly once; each long route,
  from a wrapper down to the kernel's arguments, runs through it against
  its plain version with its launch counts, as do filters of many chunks
  and staging rounds and the sharded 2-D and 1-D long routes (those also
  on the plain path, against the unsharded transform).
"""

import ctypes

import numpy as np
import pytest
import torch

import dtcwt_tpu as jdt
from dtcwt_tpu.ops import engine
import dtcwt_tpu_torch as tdt
from dtcwt_tpu_torch.ops import (
    _build, dual, fb, hw, hwtile, ilevel1, ilevel2, level1, level2, longfir,
    pack3d, single)
from dtcwt_tpu_torch.parallel import (
    ShardedTransform3d, halo_exchange, make_mesh)

TOL = 1e-12
TOL32 = 1e-5


def _taps(m, seed):
    """*m* seeded random taps, each of magnitude 0.5-1.5 before scaling to a
    unit sum of magnitudes."""
    rs = np.random.RandomState(seed)
    h = rs.uniform(0.5, 1.5, m) * rs.choice((-1.0, 1.0), m)
    return h / np.abs(h).sum()


def _biort(m, seed=0):
    """A random biort family (h0o, g0o, h1o, g1o) of m, m + 2, m + 2, m
    taps."""
    return tuple(_taps(k, seed + i) for i, k in enumerate((m, m + 2, m + 2,
                                                            m)))


def _qshift(m, seed=10):
    """A random qshift family: 8 filters of *m* taps."""
    return tuple(_taps(m, seed + i) for i in range(8))


def _np(a):
    if isinstance(a, torch.Tensor):
        a = torch.view_as_real(a) if a.is_complex() else a
        return a.double().numpy()
    a = np.asarray(a)
    if np.iscomplexobj(a):
        a = np.stack([a.real, a.imag], axis=-1)
    return a.astype(np.float64)


def _rel(got, want):
    """Max abs difference over the largest reference value (the largest
    of them, over tuples of outputs)."""
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        return max(_rel(a, b) for a, b in zip(got, want))
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-300)


def _check(got_p, want_p, got_rec, want_rec, tol=TOL):
    assert _rel(got_p.lowpass, want_p.lowpass) < tol
    assert len(got_p.highpasses) == len(want_p.highpasses)
    for a, b in zip(got_p.highpasses, want_p.highpasses):
        assert _rel(a, b) < tol
    assert _rel(got_rec, want_rec) < tol


# ---------------------------------------------------------------------------
# the transforms against dtcwt_tpu
# ---------------------------------------------------------------------------

# name -> (level-1 length m, qshift length, volume, nlevels); each JAX
# program compiles once per module
_FAMS_3D = {
    "33": (33, 36, (2, 64, 16, 16), 1),
    "35": (35, 36, (2, 64, 16, 16), 2),
    "65": (65, 36, (8, 10, 12), 1),      # filters longer than the volume
    "129": (129, 36, (8, 10, 12), 1),
}
_JAX = {}


def _jax3d(name):
    """(biort, qshift, volume, nlevels, JAX pyramid, JAX inverse)."""
    if name not in _JAX:
        m, mq, vol, nl = _FAMS_3D[name]
        b, q = _biort(m), _qshift(mq)
        x = np.random.RandomState(m).rand(*vol)
        with engine.engine("xla"):
            j = jdt.Transform3d(biort=b, qshift=q)
            jp = j.forward(x, nl)
            _JAX[name] = (b, q, x, nl, jp, j.inverse(jp))
    return _JAX[name]


@pytest.mark.parametrize("name", list(_FAMS_3D))
def test_transform3d_cpu_takes_long_level1_filters(name):
    """The 3-D level-1 entries checked the card's length limit before the
    CPU dispatch (``ValueError: fwd_level1_pack takes odd-length level-1
    filters of at most 31 taps``); they now take any odd length."""
    b, q, x, nl, jp, jrec = _jax3d(name)
    t = tdt.Transform3d(biort=b, qshift=q, device="cpu")
    p = t.forward(torch.from_numpy(x), nl)
    _check(p, jp, t.inverse(p), jrec)


@pytest.mark.parametrize("name", ["33", "35"])
def test_sharded3d_cpu_mesh_takes_long_level1_filters(name):
    """On a (2, 2) CPU mesh the depth pass of level 1 runs sharded (each
    depth shard of 32 holds the 24-sample halo) and agrees with the JAX
    package's transform."""
    b, q, x, nl, jp, jrec = _jax3d(name)
    ts = ShardedTransform3d(make_mesh((2, 2), ("data", "depth"),
                                      ["cpu"] * 4), biort=b, qshift=q)
    assert ts._plan(x.shape[-3], nl)[0]
    p = ts.forward(torch.from_numpy(x), nl)
    _check(p, jp, ts.inverse(p), jrec)


def test_sharded3d_short_shards_keep_the_refusal():
    """Where a depth shard (16) is shorter than the long filter's halo (24),
    level 1 runs replicated and still agrees with the unsharded transform;
    an exchange that wide is refused, as on any CPU mesh."""
    b, q = _biort(35), _qshift(36)
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 32, 16, 16))
    ts = ShardedTransform3d(make_mesh((2, 2), ("data", "depth"),
                                      ["cpu"] * 4), biort=b, qshift=q)
    assert not any(ts._plan(32, 2))
    t = tdt.Transform3d(biort=b, qshift=q, device="cpu")
    p, want = ts.forward(x, 2), t.forward(x, 2)
    _check(p, want, ts.inverse(p), t.inverse(want))
    shards = list(x[0].split(16, 0))
    with pytest.raises(ValueError, match="exceeds local extent"):
        halo_exchange(shards, 24, 0)


@pytest.mark.parametrize("kind,m,mq,shape,nl", [
    ("1d", 33, 130, (64, 3), 3),        # 130 taps against 64 samples
    ("1d", 37, 34, (96,), 4),
    ("2d", 35, 64, (40, 56), 2),
])
def test_transforms_take_long_families(kind, m, mq, shape, nl):
    b, q = _biort(m), _qshift(mq)
    x = np.random.RandomState(m + mq).rand(*shape)
    cls = {"1d": "Transform1d", "2d": "Transform2d"}[kind]
    with engine.engine("xla"):
        j = getattr(jdt, cls)(biort=b, qshift=q)
        jp = j.forward(x, nl)
        jrec = j.inverse(jp)
    t = getattr(tdt, cls)(biort=b, qshift=q, device="cpu")
    p = t.forward(torch.from_numpy(x), nl)
    _check(p, jp, t.inverse(p), jrec)


# ---------------------------------------------------------------------------
# the route rule at each bound's edge
# ---------------------------------------------------------------------------

def _r(m, seed=0):
    return _taps(m, seed)


def _pack_plans(plans, P, fwd=False):
    """The 3-D level kernels' host planning of *plans* in float32 and
    float64: the tap table, then the analysis tap bound and tile (*fwd*)
    or the synthesis tap bound."""
    pack3d._table(plans)
    for dtype in (torch.float32, torch.float64):
        if fwd:
            hwtile._fwd_pack_geometry(P, hwtile._hw22_tap_bound(plans, P),
                                      dtype, True)
        else:
            pack3d._inv_tap_bound(plans, P, dtype)


# wrapper -> its own kernel's host planning of filters of m taps, which
# refuses the lengths its kernel does not take (the 2-D levels' bound is
# csrc's MAX_TAPS, checked by their C entries; their geometry at m)
_F32 = torch.float32
_FUSED = {
    "filter": lambda m: single._filter_geometry(1, 64, 1, 65 - m % 2, m, 4,
                                                0, 0),
    "filter2": lambda m: dual._plan("filter2", (_r(m), _r(m, 1))),
    "filter2_sum": lambda m: dual._plan("filter2_sum", (_r(m), _r(m, 1))),
    "dfilt": lambda m: dual._plan("dfilt", (_r(m), _r(m, 1))),
    "dfilt2": lambda m: dual._plan("dfilt2", [_r(m, i) for i in range(4)]),
    "ifilt": lambda m: dual._plan("ifilt", (_r(m), _r(m, 1))),
    "ifilt2_sum": lambda m: dual._plan("ifilt2_sum",
                                       [_r(m, i) for i in range(4)]),
    "fwd_level1": lambda m: level1._level1_geometry(1, 64, 64, m, _F32,
                                                    False),
    "inv_level1": lambda m: ilevel1._ilevel1_geometry(1, 64, 64, m, _F32,
                                                      False),
    "fwd_level2": lambda m: level2._level2_geometry(1, 64, 64, m, _F32,
                                                    False),
    "inv_level2": lambda m: ilevel2._ilevel2_geometry(1, 32, 32, m, _F32,
                                                      False),
    "filter_hw22": lambda m: hw._plan("filter_hw22", (_r(m), _r(m, 1))),
    "filter_sum_hw22": lambda m: hw._plan("filter_sum_hw22",
                                          (_r(m), _r(m, 1))),
    "dfilt_hw22": lambda m: hw._plan("dfilt_hw22",
                                     [_r(m, i) for i in range(4)]),
    "ifilt_sum_hw22": lambda m: hw._plan("ifilt_sum_hw22",
                                         [_r(m, i) for i in range(4)]),
    "fwd_level1_pack": lambda m: _pack_plans(
        [fb.filter_streams(_r(m)), fb.filter_streams(_r(m, 1))], 1, True),
    "fwd_level2_pack": lambda m: _pack_plans(
        [fb.dfilt_streams(_r(m, 2 * p), _r(m, 2 * p + 1)) for p in (0, 1)],
        2, True),
    "inv_level1_pack": lambda m: _pack_plans(
        [fb.filter_streams(_r(m)), fb.filter_streams(_r(m, 1))], 1),
    "inv_level2_pack": lambda m: _pack_plans(
        [fb.ifilt_streams(_r(m, 2 * p), _r(m, 2 * p + 1)) for p in (0, 1)],
        4),
}
# wrappers whose kernels take one parity only: odd (level 1) or even
# (qshift); the others take both
_ODD = {"fwd_level1", "inv_level1", "filter_hw22", "filter_sum_hw22",
        "fwd_level1_pack", "inv_level1_pack"}
_EVEN = {"dfilt", "dfilt2", "ifilt", "ifilt2_sum", "fwd_level2",
         "inv_level2", "dfilt_hw22", "ifilt_sum_hw22", "fwd_level2_pack",
         "inv_level2_pack"}
_MAX_TAPS_BOUND = {"fwd_level1", "inv_level1", "fwd_level2", "inv_level2"}


@pytest.mark.parametrize("name", sorted(_build.TAP_BOUNDS))
def test_route_rule_at_each_bound(name):
    bound = _build.TAP_BOUNDS[name]
    step = 2 if name in _ODD | _EVEN else 1
    assert bound % 2 == (1 if name in _ODD else 0)
    assert _build.within_bound(name, [bound, None, 3])
    assert not _build.within_bound(name, [bound + step])
    assert not _build.within_bound(name, [3, bound + step])
    _FUSED[name](bound)
    if name in _MAX_TAPS_BOUND:
        # the C entries refuse filters past csrc/common.cuh MAX_TAPS
        assert bound + step > _build.MAX_TAPS
    else:
        with pytest.raises((ValueError, StopIteration)):
            _FUSED[name](bound + step)


# ---------------------------------------------------------------------------
# the replay of csrc/longfir.cu
# ---------------------------------------------------------------------------

_CTYPES = {np.float32: ctypes.c_float, np.float64: ctypes.c_double,
           np.int32: ctypes.c_int32, np.uint16: ctypes.c_uint16}
# csrc/longfir.cu: LF_THREADS, LF_MT, LF_SMEM_MAX; (P, branches, sum) of
# its instances
_THREADS, _MT, _SMEM_MAX = 256, 8, 227 * 1024
_INSTANCES = {(1, 1, 0), (1, 2, 0), (1, 2, 1), (2, 1, 0), (2, 2, 0),
              (4, 1, 0), (4, 2, 1)}


def _mem(ptr, n, dtype):
    """The *n* values of *dtype* at host address *ptr*, as a numpy view."""
    p = ctypes.cast(ptr, ctypes.POINTER(_CTYPES[dtype]))
    return np.ctypeslib.as_array(p, shape=(n,))


def _source(j, n, refl):
    """common.cuh source(): the in-axis index of sample j, one fold of two
    compares and the modulo of reflect() beyond it; -1 outside a
    pre-extended buffer."""
    inside = (j >= 0) & (j < n)
    if not refl:
        return np.where(inside, j, -1)
    f = np.where(j < 0, -1 - j, 2 * n - 1 - j)
    t = np.mod(j, 2 * n)
    r = np.where(t < n, t, 2 * n - 1 - t)
    return np.where(inside, j, np.where((f >= 0) & (f < n), f, r))


def _load(mem):
    """Storage values as the accumulator reads them (bfloat16 bits, as
    uint16, widened to float32)."""
    if mem.dtype == np.uint16:
        return (mem.astype(np.uint32) << 16).view(np.float32)
    return mem


def _to_storage(v, dt):
    """Accumulated values in storage type *dt* (bfloat16: rounded to the
    nearest even, as __float2bfloat16)."""
    if dt != np.uint16:
        return v.astype(dt)
    u = v.astype(np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


class _Replay:
    """The kernel library with ``dtcwt_longfir`` replayed on host memory:
    the C entry's checks of the plan and the tiling against the instance,
    then every thread of every block of ``lf_cols`` or ``lf_rows`` as
    csrc/longfir.cu computes them (all threads at once, in numpy): the
    chunk loop over each slot's zero-padded taps, each thread's columns,
    groups and window, the rows path's staging rounds into shared memory
    (the fold once a staged sample; the cells a round does not stage read
    as NaN) and its register windows, and the stores, whose write counts
    are kept.  Any other entry (an in-bound kernel) is recorded and does
    nothing."""

    def __init__(self):
        self.other = []
        self.writes = []
        self.tiles = []

    def __getattr__(self, name):
        if not name.startswith("dtcwt_"):
            raise AttributeError(name)

        def stub(*_a):
            self.other.append(name)
            return 0
        return stub

    def dtcwt_longfir(self, x0, x1, y0, y1, outer, n_in, inner, sum_, side,
                      refl, taps, meta, tile, dtype, stream):
        P, nb, g0, g1, base0, base1, sw0, sw1, chunks = (
            int(v) for v in _mem(meta, 9, np.int32))
        mt, path, v, vc, tx, rows, seg, cr, smem = (
            int(v) for v in _mem(tile, 9, np.int32))
        self.tiles.append(dict(path=path, vc=vc, rows=rows, cr=cr,
                               chunks=chunks))
        assert (P, nb, int(sum_)) in _INSTANCES and mt == _MT
        assert 0 <= sw0 <= 1 and 0 <= sw1 <= 1 and chunks >= 1
        assert P > 1 or sw0 == sw1 == 0
        if sum_:
            assert g0 == g1 and sw0 == sw1
        elif nb == 2:
            assert base0 == base1
        assert 1 <= cr <= chunks and tx & (tx - 1) == 0 and 1 <= tx <= 256
        g = [g0, g1 if nb == 2 else 0]
        shift = 0 if refl else side
        lay = dict(P=P, nb=nb, sum_=bool(sum_), g=g, gn=max(g),
                   base=[base0 + shift, base1 + shift], sw=[sw0, sw1],
                   chunks=chunks, D={1: 1, 2: 4, 4: 2}[P], S=1 if P == 1
                   else 2, slots=P if sum_ else P * nb, outer=outer,
                   n_in=n_in, inner=inner, refl=refl)
        # storage and accumulator types: bfloat16 is stored as the top 16
        # bits of a float32 and accumulates in float32
        dt = {0: np.float32, 1: np.uint16, 2: np.float64}[dtype]
        acc_t = np.float64 if dtype == 2 else np.float32
        xs = [_load(_mem(x0, outer * n_in * inner, dt))]
        if sum_:
            xs.append(_load(_mem(x1, outer * n_in * inner, dt)))
        t = _mem(taps, P * nb * chunks * _MT, acc_t).reshape(P * nb, -1)
        run = self._cols if path == 1 else self._rows
        outs = run(lay, xs, t, acc_t, dtype == 2, v, vc, tx, rows, seg, cr,
                   smem)
        for b, (idx, val) in outs.items():
            ptr = y1 if b else y0
            n = outer * P * g[b] * inner
            y = _mem(ptr, n, dt)
            y[idx] = _to_storage(val, dt)
            count = np.zeros(n, np.int64)
            np.add.at(count, idx, 1)
            self.writes.append(count)
        return 0

    @staticmethod
    def _phase(q, P):
        return (q % P) & 1 if P > 1 else 0

    def _pick(self, lay, b):
        """(accumulator index) of each output stream s of branch b."""
        P, sw = lay["P"], lay["sw"][b]
        base = 0 if lay["sum_"] else b * P
        return [base + (s ^ sw if P > 1 else s) for s in range(P)]

    def _cols(self, lay, xs, t, acc_t, wide, rv, vc, tx, rows, seg, cr,
              smem):
        P, D, S, slots = lay["P"], lay["D"], lay["S"], lay["slots"]
        outer, n_in, inner, gn = lay["outer"], lay["n_in"], lay["inner"], \
            lay["gn"]
        assert inner >= 2 and rv == 8 // slots
        assert vc in (1, 2 if wide else 4) and inner % vc == 0
        assert rows == 1 and seg == (_THREADS // tx) * rv and smem == 0
        assert cr == lay["chunks"]
        col_tiles = -(-inner // (tx * vc))
        row_tiles = -(-gn // seg)
        blocks = outer * row_tiles * col_tiles
        assert 1 <= blocks <= _build.INT_MAX
        blk = np.repeat(np.arange(blocks), _THREADS)
        tid = np.tile(np.arange(_THREADS), blocks)
        ct, rest = blk % col_tiles, blk // col_tiles
        rt, o = rest % row_tiles, rest // row_tiles
        c0 = (ct * tx + tid % tx) * vc
        i0 = (rt * (_THREADS // tx) + tid // tx) * rv
        live = (c0 < inner) & (i0 < gn)
        c0, i0, o = c0[live], i0[live], o[live]
        nwr = (D // S) * (rv - 1) + _MT     # window rows (pairs) a chunk
        acc = np.zeros((c0.size, rv, slots, vc), acc_t)
        cols = c0[:, None] + np.arange(vc)
        for b, x in enumerate(xs):
            x = x.reshape(outer, n_in, inner)
            jc0 = D * i0 + lay["base"][b]
            for c in range(lay["chunks"]):
                tk = t[b * slots:(b + 1) * slots, c * _MT:(c + 1) * _MT]
                jc = jc0 + S * _MT * c
                fast = (jc >= 0) & (jc + S * nwr <= n_in)
                j = jc[:, None] + np.arange(S * nwr)
                src = np.where(fast[:, None], j, _source(j, n_in, lay["refl"]))
                assert ((src[fast] >= 0) & (src[fast] < n_in)).all()
                ok = src >= 0
                win = np.where(ok[:, :, None], x[o[:, None, None],
                                                  np.maximum(src, 0)[:, :, None],
                                                  cols[:, None, :]], 0)
                for v in range(rv):
                    for q in range(slots):
                        idx = D * v + self._phase(q, P) + S * np.arange(_MT)
                        assert idx.max() < S * nwr
                        acc[:, v, q] += np.einsum("k,nkc->nc", tk[q],
                                                  win[:, idx].astype(acc_t))
        outs = {}
        for b in range(1 if lay["sum_"] else lay["nb"]):
            g, pick = lay["g"][b], self._pick(lay, b)
            idx, val = [], []
            for v in range(rv):
                i = i0 + v
                ok = i < g
                for s in range(P):
                    row = (o * P * g + P * i + s) * inner
                    idx.append((row[:, None] + cols)[ok].ravel())
                    val.append(acc[ok, v, pick[s]].ravel())
            outs[b] = (np.concatenate(idx), np.concatenate(val))
        return outs

    def _rows(self, lay, xs, t, acc_t, wide, gv, vc, tx, rows, seg, cr,
              smem):
        P, D, S, slots = lay["P"], lay["D"], lay["S"], lay["slots"]
        outer, n_in, gn, chunks = lay["outer"], lay["n_in"], lay["gn"], \
            lay["chunks"]
        nin = len(xs)
        assert lay["inner"] == 1 and vc == 1 and tx == 1
        assert gv == ((6 if P == 1 else 3) if wide else {1: 12, 2: 3, 4: 6}[P])
        assert seg % gv == 0 and rows * (seg // gv) <= _THREADS
        n_seg = -(-gn // seg)
        assert n_seg == 1 or rows == 1
        V, asize = (2, 8) if wide else (4, 4)
        wp = -(-(D * (seg - 1) + S * _MT * cr + V - 1) // V) * V
        bufs = 2 if cr < chunks else 1
        assert smem == bufs * nin * rows * wp * asize <= _SMEM_MAX
        nw = D * (gv - 1) + S * _MT      # a chunk's window samples
        nwv = -(-nw // V) * V
        assert (D * gv) % V == 0 and (S * _MT) % V == 0
        # a block a unit (segment of rows), its rounds staged into buffer
        # round & 1
        units = -(-outer // rows) * n_seg
        assert 1 <= units <= _build.INT_MAX
        rounds = -(-chunks // cr)
        bi = np.arange(units)
        o0 = (bi // n_seg) * rows
        nrows = np.minimum(rows, outer - o0)
        s0 = (bi % n_seg) * seg
        items = -(-np.minimum(seg, gn - s0) // gv)
        blk = np.repeat(bi, _THREADS)
        tid = np.tile(np.arange(_THREADS), units)
        r = tid // items[blk]
        q = tid - r * items[blk]
        live = r < nrows[blk]
        blk, r, q = blk[live], r[live], q[live]
        acc = np.zeros((blk.size, gv, slots), acc_t)
        sm = np.full((units, bufs, nin, rows, wp), np.nan, acc_t)
        for rd in range(rounds):
            cn = min(cr, chunks - rd * cr)
            W = D * (seg - 1) + S * _MT * cn
            bf = np.full(units, rd & 1)
            assert bufs == 2 or rd == 0
            sm[bi, bf] = np.nan
            for b, x in enumerate(xs):
                js = D * s0 + lay["base"][b] + S * _MT * cr * rd
                fast = (js >= 0) & (js + W <= n_in)
                j = js[:, None] + np.arange(W)
                src = np.where(fast[:, None], j, _source(j, n_in, lay["refl"]))
                for k in range(rows):
                    on = k < nrows
                    row = x.reshape(outer, n_in)[np.minimum(o0 + k, outer - 1)]
                    vals = np.where(src >= 0, np.take_along_axis(
                        row, np.maximum(src, 0), 1), 0)
                    sm[bi[on], bf[on], b, k, :W] = vals[on]
            for c in range(rd * cr, rd * cr + cn):
                for b in range(nin):
                    tk = t[b * slots:(b + 1) * slots, c * _MT:(c + 1) * _MT]
                    e0 = D * gv * q + S * _MT * (c - rd * cr)
                    assert (e0 + nwv <= wp).all()
                    win = sm[blk, bf[blk], b, r]
                    for v in range(gv):
                        for k in range(slots):
                            idx = (e0[:, None] + D * v + self._phase(k, P)
                                   + S * np.arange(_MT))
                            acc[:, v, k] += (np.take_along_axis(win, idx, 1)
                                             * tk[k]).sum(1)
        outs = {}
        i0 = s0[blk] + gv * q
        o = o0[blk] + r
        for b in range(1 if lay["sum_"] else lay["nb"]):
            g, pick = lay["g"][b], self._pick(lay, b)
            ok = i0 < g
            n = P * np.minimum(g - i0, gv)
            val = acc[:, :, pick].reshape(blk.size, gv * P)
            e = np.arange(gv * P)
            on = ok[:, None] & (e < n[:, None])
            idx = (o * P * g + P * i0)[:, None] + e
            outs[b] = (idx[on], val[on])
        return outs


@pytest.fixture
def replay(monkeypatch):
    """The kernel library replaced by :class:`_Replay`, no CUDA stream, and
    every wrapper taking its card route on CPU tensors."""
    lib = _Replay()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda _d: 0)
    monkeypatch.setattr(_build, "on_cpu", lambda _x, _n: False)
    _build.reset_launches()
    yield lib
    assert all((c == 1).all() for c in lib.writes), \
        "an output not written exactly once"


def _rand(shape, seed, dtype=torch.float64):
    return torch.from_numpy(np.random.RandomState(seed).rand(*shape)).to(
        dtype)


# entry -> (inputs, filter arguments of the length past its bound): the
# four dual entries, single's three, each signal 30 long along its axis
_STREAM_CASES = {
    "filter": (1, lambda: (_r(35),)),
    "filter2": (1, lambda: (_r(33), _r(36, 1))),        # parities differ
    "filter2_sum": (2, lambda: (_r(37), _r(33, 1))),
    "dfilt": (1, lambda: (_r(34), _r(34, 1))),
    "dfilt2": (1, lambda: ((_r(36), _r(36, 1)), (_r(36, 2), _r(36, 3)))),
    "ifilt": (1, lambda: (_r(66), _r(66, 1))),
    "ifilt2_sum": (2, lambda: ((_r(68), _r(68, 1)), (_r(68, 2),
                                                      _r(68, 3)))),
}
# (shape, axis): inner > 1 with tx * 4 columns a tile (vc 4), a short
# inner (vc 1), the axis contiguous (inner = 1), a middle axis
_VIEWS = [((3, 28, 300), 1), ((28, 5), 0), ((4, 2, 28), -1),
          ((2, 28, 3, 2), 1)]


def _lens(f):
    """The lengths of a nest of filters."""
    if isinstance(f, (tuple, list)):
        return [n for g in f for n in _lens(g)]
    return [fb._as_taps(f).size]


def _entry(name, side):
    mod = single if name in ("filter", "dfilt", "ifilt") else dual
    return (getattr(mod, name + ("_fromext_axis" if side else "_axis")),
            getattr(mod, name + ("_fromext_axis_reference" if side
                                 else "_axis_reference")))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("mode", ["reflect", "fromext"])
@pytest.mark.parametrize("name", list(_STREAM_CASES))
def test_longfir_replay_matches_plain(replay, name, mode, dtype):
    """Each stream entry past its bound: one launch of the long-filter
    kernel, replayed, against its plain version on every view, in both
    boundary modes (the from-extension buffer 40 samples wider a side than
    the reach needs: the shift is the whole extension's)."""
    n_in, filters = _STREAM_CASES[name]
    f = filters()
    op = longfir._OPS[longfir.STREAMS[name]][0]
    kern, plain = _entry(name, mode == "fromext")
    tol = {torch.float64: TOL, torch.float32: TOL32, torch.bfloat16: 1e-2}[
        dtype]
    for seed, (shape, axis) in enumerate(_VIEWS):
        xs = [_rand(shape, seed + k, dtype) for k in range(n_in)]
        args = [x for x in xs]
        if mode == "fromext":
            side = max(_lens(f)) + 40
            args = [fb.symmetric_extend(x, side, axis).contiguous()
                    for x in xs] + [side]
        _build.reset_launches()
        got = kern(*args, *f, axis)
        assert dict(_build.launches) == {"longfir_" + op: 1}
        assert _rel(got, plain(*args, *f, axis)) < tol, (shape, axis)
    assert not replay.other


def test_longfir_filter_longer_than_the_axis(replay):
    """37 taps along an axis of 8 (a level-2 side): the fold repeats."""
    x = _rand((3, 8, 5), 0)
    h0, h1 = _r(37), _r(39, 1)
    got = dual.filter2_axis(x, h0, h1, 1)
    want = dual.filter2_axis_reference(x, h0, h1, 1)
    assert _rel(got, want) < TOL
    q = (_r(36), _r(36, 1))
    assert _rel(single.dfilt_axis(x.transpose(1, 2).contiguous(), *q, -1),
                single.dfilt_axis_reference(x.transpose(1, 2), *q, -1)) < TOL


# case -> (entry, filters, shape, axis, staging rounds of a float32 rows
# launch, 0 for the columns path): several chunks of taps (131 taps: 17 of
# 8; an ifilt pair of 130: 9), several staging rounds (301 taps: 38 chunks
# in rounds of 32; qshift pairs of 300: rounds of 16), filters longer than
# the axis they filter, columns one and four a thread, rows in several
# blocks (many short rows, and a row longer than one segment of 256 items)
_CHUNK_CASES = {
    "filter 131 rows": ("filter", lambda: (_r(131),), (3, 40), -1, 1),
    "filter2 131/130 cols": ("filter2", lambda: (_r(131), _r(130, 1)),
                             (40, 6), 0, 0),
    "ifilt 130 cols": ("ifilt", lambda: (_r(130), _r(130, 1)), (2, 36, 8),
                       1, 0),
    "ifilt2_sum 130 rows": ("ifilt2_sum", lambda: (
        (_r(130), _r(130, 1)), (_r(130, 2), _r(130, 3))), (3, 36), -1, 1),
    "filter 301 rows": ("filter", lambda: (_r(301),), (100, 50), -1, 2),
    "filter2_sum 301/299 rows": ("filter2_sum", lambda: (_r(301),
                                                         _r(299, 1)),
                                 (2, 60), -1, 2),
    "dfilt2 300 rows": ("dfilt2", lambda: ((_r(300), _r(300, 1)),
                                           (_r(300, 2), _r(300, 3))),
                        (90, 64), -1, 3),
    "ifilt 300 rows": ("ifilt", lambda: (_r(300), _r(300, 1)), (80, 40), -1,
                       2),
    "dfilt 300 cols": ("dfilt", lambda: (_r(300), _r(300, 1)), (64, 5), 0,
                       0),
    "filter2 segments": ("filter2", lambda: (_r(35), _r(36, 1)), (2, 5000),
                         -1, 1),
}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("mode", ["reflect", "fromext"])
@pytest.mark.parametrize("case", list(_CHUNK_CASES))
def test_longfir_replay_chunks_and_rounds(replay, case, mode, dtype):
    """Filters of many chunks, over several staging rounds, longer than
    their axis, rows in several blocks: one launch, replayed, against the
    plain version, on the path and with the rounds the case names."""
    name, filters, shape, axis, rounds = _CHUNK_CASES[case]
    f = filters()
    kern, plain = _entry(name, mode == "fromext")
    n_in = 2 if name.endswith("_sum") else 1
    args = [_rand(shape, k, dtype) for k in range(n_in)]
    if mode == "fromext":
        side = max(_lens(f)) + 40
        args = [fb.symmetric_extend(x, side, axis).contiguous()
                for x in args] + [side]
    got = kern(*args, *f, axis)
    tol = {torch.float64: TOL, torch.float32: TOL32, torch.bfloat16: 1e-2}[
        dtype]
    assert _rel(got, plain(*args, *f, axis)) < tol
    tile = replay.tiles[-1]
    assert tile["chunks"] > 1 and tile["path"] == (0 if rounds else 1)
    if rounds and dtype == torch.float32:
        assert -(-tile["chunks"] // tile["cr"]) == rounds
    assert not replay.other


def test_in_bound_filters_keep_their_kernels(replay):
    """At the bound the wrappers launch their own kernels, not the long
    one."""
    x = _rand((4, 32, 8), 1)
    b = tdt.biort("near_sym_b")
    q = tdt.qshift("qshift_32")
    single.filter_axis(x, np.ones(32), 1)
    dual.filter2_axis(x, np.ones(32), np.ones(31), 1)
    dual.dfilt2_axis(x, (q[1], q[0]), (q[5], q[4]), 1)
    dual.ifilt2_sum_axis(x, x, *[(_r(64), _r(64, 1))] * 2, 1)
    level1.fwd_level1(x, b[0], b[2])
    assert dict(_build.launches) == {"filter": 1, "filter2": 1, "dfilt2": 1,
                                     "ifilt2_sum": 1, "level1": 1}
    assert replay.other == ["dtcwt_filter", "dtcwt_filter2", "dtcwt_dfilt2",
                            "dtcwt_ifilt2_sum", "dtcwt_level1"]


def _bands2d(shape, seed, planes):
    h, w = shape[-2] // 2, shape[-1] // 2
    rs = np.random.RandomState(seed)
    if planes:
        ph = tuple(shape[:-2]) + (6, h, w)
        return {"bands": (torch.from_numpy(rs.rand(*ph)),
                          torch.from_numpy(rs.rand(*ph)))}
    hw6 = tuple(shape[:-2]) + (h, w, 6)
    return {"yh": torch.complex(torch.from_numpy(rs.rand(*hw6)),
                                torch.from_numpy(rs.rand(*hw6)))}


_B, _BBP = _biort(35), _biort(33, 4)
_Q, _QBP = _qshift(36), (_taps(36, 40), _taps(36, 41))


def _level_cases():
    """entry -> (call on the card's route, its plain version, launches)."""
    x = _rand((2, 24, 20), 0)
    z = _rand((2, 12, 10), 1)
    v = _rand((2, 8, 12, 16), 2)
    lo = _rand((2, 4, 6, 8), 3)
    b, q = _B, _Q
    p0, p1 = (q[1], q[0]), (q[5], q[4])
    s0, s1 = (q[3], q[2]), (q[7], q[6])
    re3 = _rand((2, 28, 2, 3, 4), 4)
    im3 = _rand((2, 28, 2, 3, 4), 5)
    hw_in = [_rand((3, 12, 16), 7 + k) for k in range(4)]
    hw_sum = [_rand((3, 6, 8), 11 + k) for k in range(4)]
    f, d, i = "longfir_filter", "longfir_dfilt", "longfir_ifilt"
    cases = {}
    for planes in (False, True):
        tag = "planes" if planes else "interleaved"
        bz = _bands2d(z.shape, 2, planes)
        cases["fwd_level1 " + tag] = (
            lambda pl=planes: level1.fwd_level1(x, b[0], b[2], pl),
            lambda pl=planes: level1.fwd_level1_reference(x, b[0], b[2], pl),
            {f: 3})
        cases["fwd_level2 " + tag] = (
            lambda pl=planes: level2.fwd_level2(x, q[0], q[1], q[4], q[5],
                                                pl),
            lambda pl=planes: level2.fwd_level2_reference(
                x, q[0], q[1], q[4], q[5], pl), {d: 3})
        cases["inv_level2 " + tag] = (
            lambda bz=bz: ilevel2.inv_level2(z, g0a=q[2], g0b=q[3],
                                             g1a=q[6], g1b=q[7], **bz),
            lambda bz=bz: ilevel2.inv_level2_reference(
                z, g0a=q[2], g0b=q[3], g1a=q[6], g1b=q[7], **bz), {i: 3})
        cases["inv_level1 " + tag] = (
            lambda bz=bz: ilevel1.inv_level1(z, g0o=b[1], g1o=b[3], **bz),
            lambda bz=bz: ilevel1.inv_level1_reference(z, g0o=b[1],
                                                       g1o=b[3], **bz),
            {f: 3})
    bz = _bands2d(z.shape, 3, True)
    cases["fwd_level1 bandpass"] = (
        lambda: level1.fwd_level1(x, b[0], b[2], True, _BBP[0]),
        lambda: level1.fwd_level1_reference(x, b[0], b[2], True, _BBP[0]),
        {f: 5})
    cases["fwd_level2 bandpass"] = (
        lambda: level2.fwd_level2(x, q[0], q[1], q[4], q[5], True,
                                  *_QBP),
        lambda: level2.fwd_level2_reference(x, q[0], q[1], q[4], q[5], True,
                                            *_QBP), {d: 5})
    cases["inv_level2 bandpass"] = (
        lambda: ilevel2.inv_level2(z, g0a=q[2], g0b=q[3], g1a=q[6],
                                   g1b=q[7], g2a=_QBP[0], g2b=_QBP[1], **bz),
        lambda: ilevel2.inv_level2_reference(
            z, g0a=q[2], g0b=q[3], g1a=q[6], g1b=q[7], g2a=_QBP[0],
            g2b=_QBP[1], **bz), {i: 5})
    cases["inv_level1 bandpass"] = (
        lambda: ilevel1.inv_level1(z, g0o=b[1], g1o=b[3], g2o=_BBP[1], **bz),
        lambda: ilevel1.inv_level1_reference(z, g0o=b[1], g1o=b[3],
                                             g2o=_BBP[1], **bz), {f: 5})
    cases["fwd_level1_pack"] = (
        lambda: pack3d.fwd_level1_pack(v, b[0], b[2]),
        lambda: pack3d.fwd_level1_pack_reference(v, b[0], b[2]), {f: 7})
    cases["fwd_level2_pack"] = (
        lambda: pack3d.fwd_level2_pack(v, p0, p1, False),
        lambda: pack3d.fwd_level2_pack_reference(v, p0, p1, False), {d: 7})
    cases["inv_level1_pack"] = (
        lambda: pack3d.inv_level1_pack(lo, re3, im3, b[1], b[3]),
        lambda: pack3d.inv_level1_pack_reference(lo, re3, im3, b[1], b[3]),
        {f: 7})
    cases["inv_level2_pack"] = (
        lambda: pack3d.inv_level2_pack(lo, re3, im3, s0, s1),
        lambda: pack3d.inv_level2_pack_reference(lo, re3, im3, s0, s1),
        {i: 7})
    cases["filter_hw22"] = (
        lambda: hw.filter_hw22(hw_in[0], b[0], b[2]),
        lambda: hw.filter_hw22_reference(hw_in[0], b[0], b[2]), {f: 3})
    cases["dfilt_hw22"] = (
        lambda: hw.dfilt_hw22(hw_in[0], p0, p1),
        lambda: hw.dfilt_hw22_reference(hw_in[0], p0, p1), {d: 3})
    cases["filter_sum_hw22"] = (
        lambda: hw.filter_sum_hw22(*hw_in, b[1], b[3]),
        lambda: hw.filter_sum_hw22_reference(*hw_in, b[1], b[3]), {f: 3})
    # ifilt_sum_hw22's own kernel takes pairs of up to 64 taps
    l0, l1 = (_r(66, 50), _r(66, 51)), (_r(66, 52), _r(66, 53))
    cases["ifilt_sum_hw22"] = (
        lambda: hw.ifilt_sum_hw22(*hw_sum, l0, l1),
        lambda: hw.ifilt_sum_hw22_reference(*hw_sum, l0, l1), {i: 3})
    return cases


_LEVEL_CASES = sorted(_level_cases())


@pytest.mark.parametrize("entry", _LEVEL_CASES)
def test_level_wrappers_take_the_long_route(replay, entry):
    """Each level and hw wrapper past its bound: its plain chain on the
    long-filter kernel (replayed), then its packing, against its plain
    version, with no launch of its own kernel."""
    call, plain, launches = _level_cases()[entry]
    got = call()
    assert dict(_build.launches) == launches
    assert not replay.other
    want = plain()
    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    flat = lambda t: [a for v in t for a in (
        flat(v) if isinstance(v, (tuple, list)) else [v])]
    for a, c in zip(flat(got), flat(want)):
        assert _rel(a, c) < TOL, entry


@pytest.mark.parametrize("kind,mq,nl,launches", [
    # the 1-D transform's inverse merges on ifilt2_sum itself, whose own
    # kernel takes pairs of up to 64 taps
    ("Transform1d", 66, 3, {"longfir_filter": 2, "longfir_dfilt": 2,
                            "longfir_ifilt": 2}),
    ("Transform2d", 36, 3, {"longfir_filter": 6, "longfir_dfilt": 6,
                            "longfir_ifilt": 6}),
    ("Transform3d", 36, 2, {"longfir_filter": 14, "longfir_dfilt": 7,
                            "longfir_ifilt": 7}),
])
def test_transforms_on_the_long_route(replay, kind, mq, nl, launches):
    """A round trip of each transform on the card's route (replayed) with a
    35/37-tap biort family and a qshift family past its kernels' bounds:
    only the long-filter kernel launches, and every leaf agrees with the
    plain path."""
    shape = {"Transform1d": (48, 3), "Transform2d": (24, 20),
             "Transform3d": (8, 12, 16)}[kind]
    x = _rand(shape, 5)
    t = getattr(tdt, kind)(biort=_B, qshift=_qshift(mq), device="cpu")
    p = t.forward(x, nl)
    rec = t.inverse(p)
    assert dict(_build.launches) == launches
    assert not replay.other
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "on_cpu", lambda _x, _n: True)
        want = t.forward(x, nl)
        _check(p, want, rec, t.inverse(want))


# mesh -> (mesh shape, axis names, constructor keywords, input, levels,
# levels sharded along rows and along columns (2-D) or the signal (1-D))
_SHARDED_LONG = {
    "2-D rows": ((1, 4), ("data", "rows"), {}, (1, 1024, 64), 3),
    "2-D cols": ((1, 2, 2), ("data", "rows", "cols"), {"cols_axis": "cols"},
                 (1, 512, 512), 3),
    "1-D": ((1, 4), ("data", "rows"), {}, (1, 2048, 3), 3),
}


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("mesh", list(_SHARDED_LONG))
def test_sharded_long_route(mesh, route, monkeypatch):
    """``ShardedTransform2d`` on a rows and a cols mesh with the 35/37-tap
    biort and 36-tap qshift family, ``ShardedTransform1d`` on a (1, 4)
    mesh with a 130-tap qshift family: levels 1 and 2 run sharded (their
    shards hold the long filters' halos), and every leaf and the inverse
    agree with the unsharded transform within 1e-12 (float64), on the
    plain path and on the card's route (the long-filter kernel replayed,
    no launch of any other kernel; the 2-D route with a 66-tap qshift
    family, past the sharded inverse's ``ifilt2_sum`` bound of 64)."""
    from dtcwt_tpu_torch.parallel import ShardedTransform1d, \
        ShardedTransform2d
    mshape, names, kw, shape, nl = _SHARDED_LONG[mesh]
    one_d = mesh == "1-D"
    q = _qshift(130) if one_d else _Q if route == "plain" else _qshift(66)
    m = make_mesh(mshape, names, ["cpu"] * int(np.prod(mshape)))
    cls = ShardedTransform1d if one_d else ShardedTransform2d
    ts = cls(m, biort=_B, qshift=q, **kw)
    x = _rand(shape, 11)
    if one_d:
        assert ts._plan(shape[1], nl)[:2] == [True, True]
        t = tdt.Transform1d(biort=_B, qshift=q, device="cpu")
    else:
        for plan in ts._plan(shape[1], shape[2], nl)[:2 if kw else 1]:
            assert plan[:2] == [True, True]
        t = tdt.Transform2d(biort=_B, qshift=q, device="cpu")
    want = t.forward(x, nl)
    want_rec = t.inverse(want)
    if route == "kernel":
        lib = _Replay()
        monkeypatch.setattr(_build, "library", lambda: lib)
        monkeypatch.setattr(_build, "stream_ptr", lambda _d: 0)
        monkeypatch.setattr(_build, "on_cpu", lambda _x, _n: False)
    _build.reset_launches()
    p = ts.forward(x, nl)
    rec = ts.inverse(p)
    if route == "kernel":
        assert not lib.other and all((c == 1).all() for c in lib.writes)
        assert set(_build.launches) == {"longfir_filter", "longfir_dfilt",
                                        "longfir_ifilt"}
    _check(p, want, rec, want_rec)


def test_the_c_entry_and_its_ctypes_types_agree():
    """``dtcwt_longfir``'s ctypes argument types follow its C signature, a
    64-bit int where the C entry takes ``long long`` and a pointer for
    every pointer (ctypes would pass an undeclared int as 32 bits)."""
    import os
    import re
    src = open(os.path.join(_build.CSRC, "longfir.cu")).read()
    sig = re.search(r'extern "C" int dtcwt_longfir\(([^)]*)\)', src).group(1)
    params = [" ".join(p.split()) for p in sig.split(",")]
    want = [ctypes.c_void_p if "*" in p else
            ctypes.c_longlong if p.startswith("long long") else ctypes.c_int
            for p in params]
    assert list(_build._SIGNATURES["dtcwt_longfir"]) == want
