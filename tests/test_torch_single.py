"""The single-stream module of the port (``ops/single``) and the public
low-level names of ``dtcwt_tpu_torch.ops``.

On the CPU each entry runs its plain version.  That is held against
(a) ``dtcwt_tpu.ops.fb``'s ``filter_axis`` / ``dfilt_axis`` /
``ifilt_axis`` and ``*_from_wide_ext`` under the XLA engine, at float64 with
1e-12, on axes -1, -2 and -3, for the filters of every family (the bandpass
ones included, and even-length filters through ``filter``) and signals
shorter than the filter; and (b) the JAX package's Pallas kernels of
``pallas_fb`` run in interpret mode, as ``tests/test_pallas.py`` runs them,
at float32 with 1e-4.  (c) The fourteen names of ``dtcwt_tpu_torch.ops``
match ``dtcwt_tpu.ops`` on CPU tensors at 1e-12.  The CUDA kernels
themselves are held against these plain versions on the card by
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import dtcwt_tpu.ops as jops
from dtcwt_tpu.coeffs import biort, qshift
from dtcwt_tpu.ops import engine, pallas_fb
from dtcwt_tpu.ops import fb as jfb
import dtcwt_tpu_torch.ops as tops
from dtcwt_tpu_torch.ops import fb, single

TOL = 1e-4       # test_torch_kernels.TOL, for float32 against Pallas
TOL64 = 1e-12

BIORTS = ["antonini", "legall", "near_sym_a", "near_sym_b", "near_sym_b_bp"]
QSHIFTS = ["qshift_06", "qshift_a", "qshift_b", "qshift_c", "qshift_d",
           "qshift_b_bp", "qshift_32"]
_EVEN = np.array([-0.25, -1.0, 2.0, 1.0, -0.5, 0.125])


def _filters(kind, fam):
    """The filter arguments of every call of one kernel for one family: a
    biort family's four (six) filters, or a qshift family's pairs in the
    transform's call order (analysis (h*b, h*a) for dfilt, synthesis (g*b,
    g*a) for ifilt; the h1/g1 pairs have sum(ha*hb) < 0)."""
    if kind == "filter":
        if fam == "even":
            return [(_EVEN,), (qshift("qshift_a")[0],)]
        return [(h,) for h in biort(fam)]
    q = qshift(fam)
    first = 0 if kind == "dfilt" else 2
    return [(q[i + 1], q[i]) for i in range(first, len(q), 4)]


_CASES = ([("filter", f) for f in BIORTS + ["even"]]
          + [(k, f) for k in ("dfilt", "ifilt") for f in QSHIFTS])
# (8, 12, 16): every axis a multiple of 4; (4, 8, 4): every axis shorter
# than near_sym_b's 19 taps and the qshift filters, so the reflection folds
_SHAPES = [(8, 12, 16), (4, 8, 4)]


def _err(got, want):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max())


def _rand(shape, seed):
    return np.random.RandomState(seed).rand(*shape)


@pytest.mark.parametrize("axis", [-1, -2, -3])
@pytest.mark.parametrize("kind,fam", _CASES)
def test_axis_forms_match_jax_f64(kind, fam, axis):
    port = getattr(single, kind + "_axis")
    jax_fn = getattr(jfb, kind + "_axis")
    for seed, shape in enumerate(_SHAPES):
        x = _rand(shape, seed)
        for f in _filters(kind, fam):
            with engine.engine("xla"):
                want = jax_fn(jnp.asarray(x), *f, axis)
            assert _err(port(torch.from_numpy(x), *f, axis), want) < TOL64


@pytest.mark.parametrize("kind,fam", _CASES)
def test_wide_ext_forms_match_jax_f64(kind, fam):
    """The from-extension forms on a buffer extended wider than the filters
    need (side 32 >= qshift_32's 32 taps)."""
    port = getattr(single, kind + "_fromext_axis")
    jax_fn = getattr(jfb, kind + "_from_wide_ext")
    side = 32
    for axis in (-1, -2, -3):
        for seed, shape in enumerate(_SHAPES):
            ext = fb.symmetric_extend(torch.from_numpy(_rand(shape, seed)),
                                      side, axis).contiguous()
            for f in _filters(kind, fam):
                with engine.engine("xla"):
                    want = jax.jit(lambda e: jax_fn(e, side, *f, axis))(
                        jnp.asarray(ext.numpy()))
                assert _err(port(ext, side, *f, axis), want) < TOL64


# --- plain versions against the Pallas kernels (interpret mode), float32 ---

_PALLAS = [("filter", "near_sym_b", lambda: (biort("near_sym_b")[2],)),
           ("dfilt", "qshift_d", lambda: (qshift("qshift_d")[5],
                                         qshift("qshift_d")[4])),
           ("ifilt", "qshift_a", lambda: (qshift("qshift_a")[3],
                                          qshift("qshift_a")[2]))]


@pytest.mark.parametrize("axis", [-1, -2, -3])
@pytest.mark.parametrize("kind,fam,taps", _PALLAS, ids=[p[0] for p in _PALLAS])
def test_plain_matches_pallas_kernel(kind, fam, taps, axis):
    x = _rand((32, 32, 128), 3).astype(np.float32)
    f = taps()
    want = getattr(pallas_fb, kind + "_axis")(jnp.asarray(x), *f, axis)
    assert want is not None
    got = getattr(single, kind + "_axis")(torch.from_numpy(x), *f, axis)
    assert got.dtype == torch.float32
    assert _err(got, want) < TOL


@pytest.mark.parametrize("kind,fam,taps", _PALLAS, ids=[p[0] for p in _PALLAS])
def test_fromext_plain_matches_pallas_kernel(kind, fam, taps):
    side, axis = 24, -2     # Pallas takes a sublane-multiple side
    x = _rand((2, 32, 128), 4).astype(np.float32)
    f = taps()
    with engine.engine("xla"):
        ext = np.array(jfb.symmetric_extend(jnp.asarray(x), side, axis))
    want = getattr(pallas_fb, kind + "_fromext_axis")(jnp.asarray(ext), *f,
                                                      axis, side)
    assert want is not None
    got = getattr(single, kind + "_fromext_axis")(torch.from_numpy(ext),
                                                  side, *f, axis)
    assert _err(got, want) < TOL


# --- the public names of dtcwt_tpu_torch.ops --------------------------------

def _op_args(name):
    """Arguments of one ``ops`` name: (numpy data arrays, other arguments)."""
    b, q = biort("near_sym_b"), qshift("qshift_d")
    x = _rand((2, 12, 16), 5)
    w = _rand((2, 3, 4), 6) + 1j * _rand((2, 3, 4), 7)
    return {"colfilter": ((x,), (b[0],)), "rowfilter": ((x,), (b[2],)),
            "coldfilt": ((x,), (q[1], q[0])),
            "rowdfilt": ((x,), (q[5], q[4])),
            "colifilt": ((x,), (q[3], q[2])),
            "rowifilt": ((x,), (q[7], q[6])),
            "filter_axis": ((x,), (b[1], 0)),
            "dfilt_axis": ((x,), (q[1], q[0], -1)),
            "ifilt_axis": ((x,), (q[3], q[2], 0)),
            "symmetric_extend": ((x,), (13, -1)),
            "q2c": ((x,), ()), "c2q": ((w, 2 * w), ()),
            "q2c1d": ((x,), (1,)), "c2q1d": ((w,), (-1,))}[name]


@pytest.mark.parametrize("name", tops.__all__)
def test_ops_names_match_jax(name):
    assert set(tops.__all__) == set(jops.__all__)
    data, rest = _op_args(name)
    got = getattr(tops, name)(*(torch.from_numpy(a) for a in data), *rest)
    with engine.engine("xla"):
        want = getattr(jops, name)(*(jnp.asarray(a) for a in data), *rest)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for a, c in zip(got, want):
        c = np.asarray(c)
        assert tuple(a.shape) == c.shape
        assert float(np.abs(a.numpy() - c).max()) < TOL64


def test_filter_names_are_the_device_dispatching_entries():
    for name in ("filter_axis", "dfilt_axis", "ifilt_axis", "colfilter",
                 "rowfilter", "coldfilt", "rowdfilt", "colifilt", "rowifilt"):
        assert getattr(tops, name) is getattr(single, name)


def test_col_alias_axis_rule():
    """1-D and 2-D inputs filter axis 0 (columns of a matrix); batched
    inputs filter axis -2."""
    h = biort("near_sym_a")[0]
    for shape, axis in (((12,), 0), ((12, 5), 0), ((3, 12, 5), -2)):
        x = torch.from_numpy(_rand(shape, 8))
        assert torch.equal(single.colfilter(x, h),
                           single.filter_axis(x, h, axis))


def test_bf16_plain_runs_at_f32_and_stores_bf16():
    q = qshift("qshift_a")
    x = torch.from_numpy(_rand((16, 8), 9)).to(torch.bfloat16)
    y = single.dfilt_axis(x, q[1], q[0], 0)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, single.dfilt_axis(x.float(), q[1], q[0], 0).to(
        torch.bfloat16))


def test_integer_input_is_filtered_as_float():
    h = biort("near_sym_a")[0]
    x = torch.arange(24).reshape(4, 6)
    y = single.filter_axis(x, h, -1)
    assert y.dtype == torch.get_default_dtype()
    assert torch.equal(y, single.filter_axis(x.to(y.dtype), h, -1))


def test_wrappers_refuse_other_devices():
    h, q = biort("near_sym_a")[0], qshift("qshift_a")
    x = torch.zeros(8, 8, device="meta")
    e = torch.zeros(72, 8, device="meta")
    for call in (lambda: single.filter_axis(x, h, 0),
                 lambda: single.dfilt_axis(x, q[1], q[0], 0),
                 lambda: single.ifilt_axis(x, q[3], q[2], 0),
                 lambda: single.filter_fromext_axis(e, 32, h, 0),
                 lambda: single.dfilt_fromext_axis(e, 32, q[1], q[0], 0),
                 lambda: single.ifilt_fromext_axis(e, 32, q[3], q[2], 0)):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            call()


def test_input_errors():
    q = qshift("qshift_a")
    x = torch.zeros(10, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="multiple of 4"):
        single.dfilt_axis(x, q[1], q[0], 0)
    with pytest.raises(ValueError, match="multiple of 2"):
        single.ifilt_axis(x[:9], q[3], q[2], 0)
    with pytest.raises(ValueError, match="Shapes of ha and hb"):
        single.dfilt_axis(x[:8], q[1], q[0][:8], 0)
    with pytest.raises(ValueError, match="must be even"):
        single.ifilt_axis(x, q[3][:9], q[2][:9], 0)


# --- non-tensor inputs: a numpy array or a list, as the JAX package takes ---

_NAMES = ["colfilter", "rowfilter", "coldfilt", "rowdfilt", "colifilt",
          "rowifilt", "filter_axis", "dfilt_axis", "ifilt_axis"]


@pytest.mark.parametrize("name", _NAMES)
def test_numpy_input_on_the_cpu_matches_jax(name):
    data, rest = _op_args(name)
    with engine.engine("xla"):
        want = np.asarray(getattr(jops, name)(data[0], *rest))
    for x in (data[0], data[0].tolist()):
        got = getattr(tops, name)(x, *rest, device="cpu")
        assert got.device.type == "cpu" and got.dtype == torch.float64
        assert got.shape == want.shape
        assert float(np.abs(got.numpy() - want).max()) < TOL64


def test_numpy_input_without_a_card_raises(monkeypatch):
    """A non-tensor input goes to the card unless the caller asks for the
    CPU: with no card it raises, and never runs the plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _rand((16, 16), 11)
    h, q = biort("near_sym_a")[0], qshift("qshift_a")
    for call in (lambda: tops.colfilter(x, h),
                 lambda: tops.rowdfilt(x, q[1], q[0]),
                 lambda: tops.ifilt_axis(x, q[3], q[2], 0)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_device_keyword_moves_a_tensor():
    x = torch.from_numpy(_rand((8, 8), 12))
    h = biort("near_sym_a")[0]
    assert tops.colfilter(x, h, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tops.rowfilter(x, h, device="meta")


# --- the tiling of the filter kernel (csrc/filter.cu), replayed in numpy ----

def _source(j, n_in, refl):
    """csrc/filter.cu source(): in-axis index of sample j, -1 for zero."""
    j = np.asarray(j)
    r = 2 * n_in
    t = j % r
    t = np.where(t < n_in, t, r - 1 - t)
    inside = (j >= 0) & (j < n_in)
    return np.where(inside, j, t if refl else -1)


def _windows(w, m, count):
    """[items, count, ...rest, m]: the m samples from each of the first
    *count* positions of axis 1 of *w* (a thread's register window)."""
    return np.lib.stride_tricks.sliding_window_view(w, m, axis=1)[:, :count]


def _replay_rows(geo, xf, taps, outer, n_in, g, c, refl, isz, x_ptr):
    """Every block and thread item of the rows path: (flat output index,
    value) of each store, with the staging and window reads checked."""
    m, V, mt = taps.size, geo.v, geo.mt
    vec = 16 // isz
    assert geo.smem % isz == 0
    n_seg = geo.grid[1]
    idx, val = [], []
    for blk in range(geo.blocks):
        s0 = (blk % n_seg) * geo.seg
        o0 = (blk // n_seg) * geo.rows
        rows = min(geo.rows, outer - o0)
        lr = min(geo.seg, g - s0)
        a = max(0, s0 + c)
        b = min(n_in, s0 + c + geo.seg + mt - 1)
        f0 = o0 * n_in + a
        ln = (rows - 1) * n_in + (b - a)
        pad = ((x_ptr + f0 * isz) % 16) // isz
        assert 0 < ln and pad < vec and pad + ln <= geo.smem // isz
        staged = np.full(geo.smem // isz, np.nan)
        staged[pad:pad + ln] = xf[f0:f0 + ln]
        # the interior chunks [q_lo, q_hi) first, then the row ends
        chunks = -(-lr // V)
        reach = V + m - 1
        lo, hi = -(s0 + c), n_in - reach - s0 - c
        q_lo = min(chunks, -(-lo // V)) if lo > 0 else 0
        q_hi = max(q_lo, min(chunks, 0 if hi < 0 else hi // V + 1))
        ni, ne = q_hi - q_lo, chunks - (q_hi - q_lo)
        it, ie = np.arange(rows * ni), np.arange(rows * ne)
        k = ie % max(ne, 1)
        r = np.concatenate([it // max(ni, 1), ie // max(ne, 1)])
        q = np.concatenate([q_lo + it % max(ni, 1),
                            np.where(k < q_lo, k, q_hi + k - q_lo)])
        fast = np.arange(r.size) < it.size
        i0 = s0 + q * V
        j0 = i0 + c
        rbase = r * n_in - a + pad
        t = np.arange(V + mt - 1)
        assert ((j0 >= 0) & (j0 + reach <= n_in))[fast].all()
        jj = np.where(fast[:, None], j0[:, None] + t,
                      _source(j0[:, None] + t, n_in, refl))
        s = rbase[:, None] + np.maximum(jj, 0)
        used = (t < reach) & (jj >= 0)
        nv = np.minimum(V, s0 + lr - i0)
        # a sample that a real tap of a stored output reads lies in the
        # staged range, unclamped
        need = used & (t < (nv + m - 1)[:, None])
        assert ((s >= pad) & (s < pad + ln))[need].all()
        w = np.where(used, staged[np.clip(s, pad, pad + ln - 1)], 0.0)
        acc = _windows(w, m, V) @ taps
        v = np.arange(V)
        ok = v[None, :] < nv[:, None]
        flat = (o0 + r)[:, None] * g + i0[:, None] + v
        idx.append(flat[ok])
        val.append(acc[ok])
    return np.concatenate(idx), np.concatenate(val)


def _replay_cols(geo, xf, taps, outer, n_in, inner, g, c, refl):
    """Every thread of the columns path: (flat output index, value) of
    each store, with every read checked to lie in the input."""
    m, RV, vc, mt, tx = taps.size, geo.v, geo.vc, geo.mt, geo.tx
    n_rt, n_ct = geo.grid[1], geo.grid[2]
    blk = np.arange(geo.blocks)[:, None]
    tid = np.arange(256)[None, :]
    ct, rt = blk % n_ct, (blk // n_ct) % n_rt
    o = blk // (n_ct * n_rt)
    col = (ct * tx + tid % tx) * vc
    i0 = (rt * (256 // tx) + tid // tx) * RV
    live = (col < inner) & (i0 < g)
    col, i0, o = col[live], i0[live], np.broadcast_to(o, live.shape)[live]
    r = np.arange(RV + mt - 1)
    jj = _source(i0[:, None] + c + r, n_in, refl)
    u = np.arange(vc)
    src = ((o * n_in)[:, None, None] + np.maximum(jj, 0)[:, :, None]) \
        * inner + col[:, None, None] + u
    assert src.min() >= 0 and src.max() < xf.size
    win = np.where(jj[:, :, None] >= 0, xf[src], 0.0)
    acc = _windows(win, m, RV) @ taps
    v = np.arange(RV)
    ok = np.broadcast_to((i0[:, None] + v < g)[:, :, None], acc.shape)
    flat = ((o * g)[:, None, None] + i0[:, None, None] + v[:, None]) \
        * inner + col[:, None, None] + u
    return flat[ok], acc[ok]


# (itemsize, storage offset of the input in elements).  Rows: float32
# aligned and not, bfloat16 three elements off, float64 one element off.
# Columns: vector columns (float32 aligned, float64) and scalar ones
# (float32 one element off).
_ALIGN = {"rows": [(4, 0), (4, 1), (2, 3), (8, 1)],
          "cols": [(4, 0), (4, 1), (8, 0)]}


@pytest.mark.parametrize("inner", [1, 2, 3, 4, 33, 64, 65])
@pytest.mark.parametrize("n", [1, 2, 5, 31, 255, 256, 257, 1500, 4097])
def test_filter_tiling_replay(n, inner):
    """Replay ``single._filter_geometry``'s tiles as ``csrc/filter.cu``
    walks them, at float64: which input samples each block and thread
    reads (staged or direct, reflected or from the extension) and which
    outputs it writes.  Every output is written exactly once and equals
    ``fb.filter_axis`` / ``fb.filter_from_wide_ext`` at 1e-12, for 1 to
    32 taps, both modes, and inputs at offsets that break 16-byte
    alignment (the rows path's scalar head and tail, the columns path's
    scalar columns)."""
    outer = 5 if inner == 1 else 2
    path = "rows" if inner == 1 else "cols"
    rng = np.random.RandomState(n * 100 + inner)
    x = torch.from_numpy(rng.rand(outer, n, inner))
    for m in range(1, 33):
        h = rng.rand(m) - 0.5
        taps = h[::-1].copy()
        g = n + 1 - m % 2
        for side in (None, m // 2 + 2):
            if side is None:
                buf, c = x, -(m // 2)
                want = fb.filter_axis(x, h, 1)
            else:
                buf, c = fb.symmetric_extend(x, side, 1), side - m // 2
                want = fb.filter_from_wide_ext(buf, side, h, 1)
            n_in = buf.shape[1]
            xf = buf.reshape(-1).numpy()
            want = want.reshape(-1).numpy()
            for isz, off in _ALIGN[path]:
                x_ptr, y_ptr = 1 << 20 | off * isz, 1 << 21
                geo = single._filter_geometry(outer, n_in, inner, g, m, isz,
                                              x_ptr, y_ptr)
                assert geo.path == path
                if path == "rows":
                    idx, val = _replay_rows(geo, xf, taps, outer, n_in, g,
                                            c, side is None, isz, x_ptr)
                else:
                    idx, val = _replay_cols(geo, xf, taps, outer, n_in,
                                            inner, g, c, side is None)
                hits = np.bincount(idx, minlength=want.size)
                assert hits.size == want.size and (hits == 1).all(), \
                    (m, side, isz, off)
                got = np.empty_like(want)
                got[idx] = val
                assert np.abs(got - want).max() < TOL64, (m, side, isz, off)


def test_filter_geometry_main_path_tiles():
    """The tiles of the main path's calls: 256^3 W (rows of 256, 16 to a
    block), H and D (8 output rows a thread, float4 columns), the 4096^2
    row and column calls and the 4M-sample vector's segments."""
    g = single._filter_geometry
    w = g(65536, 256, 1, 256, 5, 4, 0, 0)
    assert (w.path, w.rows, w.seg, w.v, w.grid) == ("rows", 16, 256, 4,
                                                    (4096, 1))
    assert w.smem == 4 * (4 + 15 * 256 + 256)
    h = g(256, 256, 256, 256, 7, 4, 0, 0)
    assert (h.path, h.vc, h.tx, h.seg, h.grid) == ("cols", 4, 64, 32,
                                                   (256, 8, 1))
    d = g(1, 256, 65536, 256, 7, 4, 0, 0)
    assert (d.vc, d.tx, d.seg, d.grid) == (4, 256, 8, (1, 32, 64))
    assert g(4096, 4096, 1, 4096, 7, 2, 0, 0).rows == 2
    assert g(1, 4096, 4096, 4096, 7, 2, 0, 0).vc == 4
    assert g(1, 4096, 4096, 4096, 7, 4, 4, 0).vc == 1
    v = g(1, 4194304, 1, 4194304, 7, 4, 0, 0)
    assert (v.rows, v.seg, v.grid, v.mt) == (1, 4096, (1, 1024), 8)
    assert g(1, 64, 1, 65, 32, 8, 0, 0).mt == 32
