"""The port's plain filter-bank primitives and 2-D packing against
``dtcwt_tpu.ops.fb`` / ``packing`` (XLA engine) at float64, tolerance 1e-12.
Inputs are made with numpy from a seed and fed to both packages."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dtcwt_tpu.coeffs import biort, qshift
from dtcwt_tpu.ops import engine
from dtcwt_tpu.ops import fb as jfb
from dtcwt_tpu.ops import packing as jpack
from dtcwt_tpu_torch.ops import fb, packing

TOL = 1e-12

BIORTS = ["antonini", "legall", "near_sym_a", "near_sym_b", "near_sym_b_bp"]
QSHIFTS = ["qshift_06", "qshift_a", "qshift_b", "qshift_c", "qshift_d",
           "qshift_b_bp", "qshift_32"]


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape)


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() < TOL


@pytest.fixture(autouse=True)
def _xla_engine():
    with engine.engine("xla"):
        yield


# (batched shape, axis): odd and even lengths along both axes
_FILTER_CASES = [((3, 17, 10), -2), ((3, 17, 10), -1), ((2, 12, 9), -1),
                 ((4, 6), 0), ((2, 5, 7), -2)]


@pytest.mark.parametrize("name", BIORTS)
@pytest.mark.parametrize("shape,axis", _FILTER_CASES)
def test_filter_axis(name, shape, axis):
    x = _rand(shape, 0)
    for h in biort(name):
        _close(fb.filter_axis(torch.from_numpy(x), h, axis),
               jfb.filter_axis(jnp.asarray(x), h, axis))


# multiple-of-4 lengths for dfilt; even lengths for ifilt; the short ones
# are shorter than qshift_32's 32 taps (and qshift_d's 18)
_QCASES = [((2, 16, 12), -2), ((2, 16, 12), -1), ((8, 4), 0), ((3, 4, 8), -1)]


@pytest.mark.parametrize("name", QSHIFTS)
@pytest.mark.parametrize("shape,axis", _QCASES)
def test_dfilt_ifilt_axis(name, shape, axis):
    q = qshift(name)
    x = _rand(shape, 1)
    for ha, hb in [(q[1], q[0]), (q[5], q[4])]:
        _close(fb.dfilt_axis(torch.from_numpy(x), ha, hb, axis),
               jfb.dfilt_axis(jnp.asarray(x), ha, hb, axis))
    y = _rand(shape[:-1] + (shape[-1] + 2,), 2)
    for ha, hb in [(q[3], q[2]), (q[7], q[6])]:
        _close(fb.ifilt_axis(torch.from_numpy(y), ha, hb, axis),
               jfb.ifilt_axis(jnp.asarray(y), ha, hb, axis))


@pytest.mark.parametrize("n", [3, 9, 40])
def test_symmetric_extend_multi_fold(n):
    """Extension wider than the signal folds as often as needed."""
    x = _rand((2, 5, 7), 3)
    for axis in (-2, -1):
        _close(fb.symmetric_extend(torch.from_numpy(x), n, axis),
               jfb.symmetric_extend(jnp.asarray(x), n, axis))


def test_from_ext_dual_and_col_row_forms():
    x = _rand((2, 16, 20), 4)
    t = torch.from_numpy(x)
    j = jnp.asarray(x)
    h0, g0, h1, g1 = biort("near_sym_b")
    q = qshift("qshift_c")
    _close(fb.filter_from_ext(fb.symmetric_extend(t, 6, -1), h0, -1),
           jfb.filter_from_ext(jfb.symmetric_extend(j, 6, -1), h0, -1))
    _close(fb.dfilt_from_ext(fb.symmetric_extend(t, q[0].size, -2),
                             q[1], q[0], -2),
           jfb.dfilt_from_ext(jfb.symmetric_extend(j, q[0].size, -2),
                              q[1], q[0], -2))
    m2 = q[2].size // 2
    _close(fb.ifilt_from_ext(fb.symmetric_extend(t, m2, -1), q[3], q[2], -1),
           jfb.ifilt_from_ext(jfb.symmetric_extend(j, m2, -1), q[3], q[2],
                              -1))
    for a, b in zip(fb.filter2_axis(t, h0, h1, -2),
                    jfb.filter2_axis(j, h0, h1, -2)):
        _close(a, b)
    for a, b in zip(fb.dfilt2_axis(t, (q[1], q[0]), (q[5], q[4]), -1),
                    jfb.dfilt2_axis(j, (q[1], q[0]), (q[5], q[4]), -1)):
        _close(a, b)
    _close(fb.filter2_sum_axis(t, 2 * t, g0, g1, -2),
           jfb.filter2_sum_axis(j, 2 * j, g0, g1, -2))
    _close(fb.ifilt2_sum_axis(t, 2 * t, (q[3], q[2]), (q[7], q[6]), -1),
           jfb.ifilt2_sum_axis(j, 2 * j, (q[3], q[2]), (q[7], q[6]), -1))
    img = torch.from_numpy(x[0])
    for name in ("colfilter", "rowfilter"):
        _close(getattr(fb, name)(img, h0), getattr(jfb, name)(x[0], h0))
    for name in ("coldfilt", "rowdfilt", "colifilt", "rowifilt"):
        _close(getattr(fb, name)(t, q[1], q[0]),
               getattr(jfb, name)(j, q[1], q[0]))


def test_shape_errors():
    q = qshift("qshift_a")
    with pytest.raises(ValueError):
        fb.dfilt_axis(torch.zeros(6, 8, dtype=torch.float64), q[1], q[0], 0)
    with pytest.raises(ValueError):
        fb.ifilt_axis(torch.zeros(5, 8, dtype=torch.float64), q[3], q[2], 0)
    with pytest.raises(ValueError):
        fb.filter2_sum_axis(torch.zeros(4, 4), torch.zeros(4, 4),
                            np.ones(3), np.ones(4), -1)


def test_packing_matches_jax():
    y = _rand((2, 6, 10), 5)
    for got, want in zip(packing.q2c(torch.from_numpy(y)),
                         jpack.q2c(jnp.asarray(y))):
        _close(got, want)
    for got, want in zip(packing.q2c_planes(torch.from_numpy(y)),
                         jpack.q2c_planes(jnp.asarray(y))):
        _close(got[0], want[0])
        _close(got[1], want[1])
    w0 = _rand((2, 3, 5), 6) + 1j * _rand((2, 3, 5), 7)
    w1 = _rand((2, 3, 5), 8) + 1j * _rand((2, 3, 5), 9)
    _close(packing.c2q(torch.from_numpy(w0), torch.from_numpy(w1), 0.5, 2.0),
           jpack.c2q(jnp.asarray(w0), jnp.asarray(w1), 0.5, 2.0))
    planes = lambda w: (torch.from_numpy(w.real.copy()),
                        torch.from_numpy(w.imag.copy()))
    _close(packing.c2q_planes(planes(w0), planes(w1), 1.5, 0.25),
           jpack.c2q_planes((w0.real, w0.imag), (w1.real, w1.imag), 1.5,
                            0.25))
