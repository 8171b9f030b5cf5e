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
