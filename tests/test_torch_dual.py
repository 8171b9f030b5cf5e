"""The dual-stream module of the port (``ops/dual``): the plain versions of
the four kernels ``filter2``, ``dfilt2``, ``filter2_sum`` and ``ifilt2_sum``,
in their axis and from-extension forms.

On the CPU each wrapper runs its plain version.  That is held against
(a) ``dtcwt_tpu.ops.fb``'s dual forms and wide-extension forms under the XLA
engine, at float64 with 1e-12, on axes -1, -2 and -3, for filters of unequal
lengths (near_sym_b's 13/19 taps, qshift pairs of 10 and 14 taps), even
lengths and signals shorter than the filter; and (b) the JAX package's
Pallas kernels of ``pallas_dual`` run in interpret mode, as
``tests/test_pallas_dual.py`` runs them, at float32 with 1e-4.  The CUDA
kernels themselves are held against these plain versions on the card by
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dtcwt_tpu.coeffs import biort, qshift
from dtcwt_tpu.ops import engine, pallas_dual
from dtcwt_tpu.ops import fb as jfb
from dtcwt_tpu_torch.ops import dual, fb

TOL = 1e-4       # test_torch_kernels.TOL, for float32 against Pallas
TOL64 = 1e-12

_EVEN = (np.array([1.0, 3.0, 3.0, 1.0]) / 8,
         np.array([-0.25, -1.0, 2.0, 1.0, -0.5, 0.125]))


def _filters(fam):
    """(analysis pair h0, h1; synthesis pair g0, g1) of a level-1 case."""
    if fam == "even":
        return _EVEN, _EVEN[::-1]
    b = biort(fam)
    return (b[0], b[2]), (b[1], b[3])


def _pairs(fam):
    """(forward pairs p0, p1; inverse pairs i0, i1) in the transform's call
    order; "mixed" takes branch 0 from qshift_a (10 taps) and branch 1 from
    qshift_d (14 taps)."""
    q0 = qshift("qshift_a" if fam == "mixed" else fam)
    q1 = qshift("qshift_d" if fam == "mixed" else fam)
    return ((q0[1], q0[0]), (q1[5], q1[4])), ((q0[3], q0[2]), (q1[7], q1[6]))


def _err(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.double().numpy(), np.asarray(b, np.float64)
        assert a.shape == b.shape, (a.shape, b.shape)
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def _calls(kind, fam):
    """(port entry, JAX entry) of one kernel on one filter case, both taking
    ``(inputs, axis)``."""
    if kind in ("filter2", "filter2_sum"):
        (h0, h1), (g0, g1) = _filters(fam)
        if kind == "filter2":
            return (lambda x, ax: dual.filter2_axis(x[0], h0, h1, ax),
                    lambda x, ax: jfb.filter2_axis(x[0], h0, h1, ax))
        return (lambda x, ax: dual.filter2_sum_axis(*x, g0, g1, ax),
                lambda x, ax: jfb.filter2_sum_axis(*x, g0, g1, ax))
    (p0, p1), (i0, i1) = _pairs(fam)
    if kind == "dfilt2":
        return (lambda x, ax: dual.dfilt2_axis(x[0], p0, p1, ax),
                lambda x, ax: jfb.dfilt2_axis(x[0], p0, p1, ax))
    return (lambda x, ax: dual.ifilt2_sum_axis(*x, i0, i1, ax),
            lambda x, ax: jfb.ifilt2_sum_axis(*x, i0, i1, ax))


def _wide_calls(kind, fam):
    """(port entry, JAX entry) of one from-extension form, both taking
    ``(extended inputs, side, axis)``."""
    if kind in ("filter2", "filter2_sum"):
        (h0, h1), (g0, g1) = _filters(fam)
        if kind == "filter2":
            return (lambda e, s, ax: dual.filter2_fromext_axis(e[0], s, h0,
                                                               h1, ax),
                    lambda e, s, ax: jfb.filter2_from_wide_ext(e[0], s, h0,
                                                               h1, ax))
        return (lambda e, s, ax: dual.filter2_sum_fromext_axis(*e, s, g0, g1,
                                                               ax),
                lambda e, s, ax: jfb.filter2_sum_from_wide_ext(*e, s, g0, g1,
                                                               ax))
    (p0, p1), (i0, i1) = _pairs(fam)
    if kind == "dfilt2":
        return (lambda e, s, ax: dual.dfilt2_fromext_axis(e[0], s, p0, p1,
                                                          ax),
                lambda e, s, ax: jfb.dfilt2_from_wide_ext(e[0], s, p0, p1,
                                                          ax))
    return (lambda e, s, ax: dual.ifilt2_sum_fromext_axis(*e, s, i0, i1, ax),
            lambda e, s, ax: jfb.ifilt2_sum_from_wide_ext(*e, s, i0, i1, ax))


_NINPUTS = {"filter2": 1, "dfilt2": 1, "filter2_sum": 2, "ifilt2_sum": 2}
_CASES = ([(k, f) for k in ("filter2", "filter2_sum")
           for f in ("near_sym_a", "near_sym_b", "even")]
          + [(k, f) for k in ("dfilt2", "ifilt2_sum")
             for f in ("qshift_a", "qshift_d", "mixed")])
# (8, 12, 16): every axis a multiple of 4; (4, 8, 4): every axis shorter
# than near_sym_b's 19 taps and qshift_d's 14, so the reflection folds
_SHAPES = [(8, 12, 16), (4, 8, 4)]


def _inputs(kind, shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(*shape) for _ in range(_NINPUTS[kind])]


@pytest.mark.parametrize("axis", [-1, -2, -3])
@pytest.mark.parametrize("kind,fam", _CASES)
def test_axis_forms_match_jax_f64(kind, fam, axis):
    port, jax_fn = _calls(kind, fam)
    for seed, shape in enumerate(_SHAPES):
        xs = _inputs(kind, shape, seed)
        with engine.engine("xla"):
            want = jax_fn([jnp.asarray(x) for x in xs], axis)
        got = port([torch.from_numpy(x) for x in xs], axis)
        assert _err(got, want) < TOL64


@pytest.mark.parametrize("kind,fam", _CASES)
def test_wide_ext_forms_match_jax_f64(kind, fam):
    """The from-extension forms on a buffer extended wider than the filters
    need (side 20 >= 19 taps // 2 and >= 14 taps)."""
    port, jax_fn = _wide_calls(kind, fam)
    side = 20
    for axis in (-1, -2, -3):
        for seed, shape in enumerate(_SHAPES):
            ext = [fb.symmetric_extend(torch.from_numpy(x), side, axis)
                   .contiguous() for x in _inputs(kind, shape, seed)]
            with engine.engine("xla"):
                want = jax.jit(lambda *e: jax_fn(list(e), side, axis))(
                    *(jnp.asarray(e.numpy()) for e in ext))
            assert _err(port(ext, side, axis), want) < TOL64


# --- plain versions against the Pallas kernels (interpret mode), float32 ---

def _pallas(kind, fam, fromext):
    """The pallas_dual entry of one kernel, taking (inputs, axis[, side])."""
    if kind in ("filter2", "filter2_sum"):
        (h0, h1), (g0, g1) = _filters(fam)
        if kind == "filter2":
            fn = pallas_dual.filter2_fromext_axis if fromext else \
                pallas_dual.filter2_axis
            return lambda x, ax, *s: fn(x[0], h0, h1, ax, *s)
        fn = pallas_dual.filter2_sum_fromext_axis if fromext else \
            pallas_dual.filter2_sum_axis
        return lambda x, ax, *s: fn(*x, g0, g1, ax, *s)
    (p0, p1), (i0, i1) = _pairs(fam)
    if kind == "dfilt2":
        fn = pallas_dual.dfilt2_fromext_axis if fromext else \
            pallas_dual.dfilt2_axis
        return lambda x, ax, *s: fn(x[0], *p0, *p1, ax, *s)
    fn = pallas_dual.ifilt2_sum_fromext_axis if fromext else \
        pallas_dual.ifilt2_sum_axis
    return lambda x, ax, *s: fn(*x, *i0, *i1, ax, *s)


@pytest.mark.parametrize("axis", [-1, -2, -3])
@pytest.mark.parametrize("kind,fam", [("filter2", "near_sym_b"),
                                      ("dfilt2", "qshift_a"),
                                      ("filter2_sum", "near_sym_b"),
                                      ("ifilt2_sum", "qshift_d")])
def test_plain_matches_pallas_kernel(kind, fam, axis):
    xs = [x.astype(np.float32) for x in _inputs(kind, (32, 32, 128), 3)]
    want = _pallas(kind, fam, False)([jnp.asarray(x) for x in xs], axis)
    assert want is not None
    port, _ = _calls(kind, fam)
    got = port([torch.from_numpy(x) for x in xs], axis)
    got = got if isinstance(got, tuple) else (got,)
    assert all(y.dtype == torch.float32 for y in got)
    assert _err(got, want) < TOL


@pytest.mark.parametrize("kind,fam", [("filter2", "near_sym_b"),
                                      ("dfilt2", "qshift_a"),
                                      ("filter2_sum", "near_sym_b"),
                                      ("ifilt2_sum", "qshift_d")])
def test_fromext_plain_matches_pallas_kernel(kind, fam):
    side, axis = 16, -2     # Pallas takes a sublane-multiple side
    xs = [x.astype(np.float32) for x in _inputs(kind, (2, 32, 128), 4)]
    with engine.engine("xla"):
        ext = [np.array(jfb.symmetric_extend(jnp.asarray(x), side, axis))
               for x in xs]
    want = _pallas(kind, fam, True)([jnp.asarray(e) for e in ext], axis,
                                    side)
    assert want is not None
    port, _ = _wide_calls(kind, fam)
    got = port([torch.from_numpy(e) for e in ext], side, axis)
    assert _err(got, want) < TOL


def test_bf16_plain_runs_at_f32_and_stores_bf16():
    (h0, h1), _ = _filters("near_sym_a")
    x = torch.from_numpy(np.random.RandomState(5).rand(16, 8)).to(
        torch.bfloat16)
    lo, hi = dual.filter2_axis(x, h0, h1, 0)
    want = dual.filter2_axis(x.float(), h0, h1, 0)
    assert lo.dtype == hi.dtype == torch.bfloat16
    assert torch.equal(lo, want[0].to(torch.bfloat16))
    assert torch.equal(hi, want[1].to(torch.bfloat16))


def test_wrappers_refuse_other_devices():
    (h0, h1), (g0, g1) = _filters("near_sym_a")
    (p0, p1), (i0, i1) = _pairs("qshift_a")
    x = torch.zeros(8, 8, device="meta")
    e = torch.zeros(24, 8, device="meta")
    for call in (lambda: dual.filter2_axis(x, h0, h1, 0),
                 lambda: dual.dfilt2_axis(x, p0, p1, 0),
                 lambda: dual.filter2_sum_axis(x, x, g0, g1, 0),
                 lambda: dual.ifilt2_sum_axis(x, x, i0, i1, 0),
                 lambda: dual.filter2_fromext_axis(e, 8, h0, h1, 0),
                 lambda: dual.dfilt2_fromext_axis(e, 8, p0, p1, 0),
                 lambda: dual.filter2_sum_fromext_axis(e, e, 8, g0, g1, 0),
                 lambda: dual.ifilt2_sum_fromext_axis(e, e, 8, i0, i1, 0)):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            call()


def test_input_errors():
    (h0, _), (g0, _) = _filters("near_sym_a")
    (p0, p1), (i0, i1) = _pairs("qshift_a")
    x = torch.zeros(10, 3, dtype=torch.float64)
    with pytest.raises(ValueError, match="multiple of 4"):
        dual.dfilt2_axis(x, p0, p1, 0)
    with pytest.raises(ValueError, match="multiple of 2"):
        dual.ifilt2_sum_axis(x[:9], x[:9], i0, i1, 0)
    with pytest.raises(ValueError, match="same shape"):
        dual.ifilt2_sum_axis(x, x[:8], i0, i1, 0)
    with pytest.raises(ValueError, match="parities"):
        dual.filter2_sum_axis(x, x, g0, _EVEN[0], 0)
