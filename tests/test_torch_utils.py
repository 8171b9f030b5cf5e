"""The port's ``utils`` against ``dtcwt_tpu.utils`` on the CPU: the dtype
helpers, the test-image generators, ``unpack`` of interleaved and plane
pyramids and the three stacked products, on the same seeded numpy inputs
(float64, 1e-12 relative to the largest value).  A tensor keeps its
device (checked on ``meta`` tensors), and the image generators raise
without a card when asked for one."""

import numpy as np
import pytest
import torch

import dtcwt_tpu as jdt
from dtcwt_tpu import utils as JU
from dtcwt_tpu_torch import utils as TU
from dtcwt_tpu_torch.convert import pyramid_from_numpy

TOL = 1e-12

_TORCH_DTYPE = {np.dtype(np.complex64): torch.complex64,
                np.dtype(np.complex128): torch.complex128}


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    return float(np.abs(got - want).max()) / scale


def test_all_names_but_the_tunnel_helpers():
    assert set(TU.__all__) == set(JU.__all__) - {"asnumpy", "asdevice"}


@pytest.mark.parametrize("a", [np.arange(6).reshape(2, 3),
                               np.array([True, False]),
                               np.linspace(0, 1, 5).astype(np.float32),
                               np.linspace(0, 1, 5),
                               np.array([1 + 2j, 3j], np.complex64)],
                         ids=["int", "bool", "f32", "f64", "c64"])
def test_asfarray(a):
    got, want = TU.asfarray(a), JU.asfarray(a)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert TU.asfarray(torch.from_numpy(a)).dtype == got.dtype


@pytest.mark.parametrize("dt", [np.float16, np.float32, np.float64,
                                np.complex64, np.complex128, np.int32])
def test_appropriate_complex_type_for(dt):
    a = np.zeros(3, dt)
    want = _TORCH_DTYPE[np.dtype(JU.appropriate_complex_type_for(a))]
    assert TU.appropriate_complex_type_for(a) == want
    assert TU.appropriate_complex_type_for(torch.from_numpy(a)) == want
    assert TU.appropriate_complex_type_for(
        torch.zeros(3, dtype=torch.bfloat16)) == torch.complex64


@pytest.mark.parametrize("shape", [(), (5,), (1, 5), (5, 1), (3, 4),
                                   (1, 2, 3)])
def test_as_column_vector(shape):
    v = np.random.RandomState(0).rand(*shape)
    got, want = TU.as_column_vector(v), JU.as_column_vector(v)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("theta,r,w,N", [(0, 10.5, 3, 32), (30, 14, 5, 33),
                                         (-75, (12.0, 20.0), 0.5, 40),
                                         (135, 7, 8, 17)])
def test_drawedge(theta, r, w, N):
    got = TU.drawedge(theta, r, w, N, device="cpu")
    assert got.dtype == torch.float64
    assert _rel(got, JU.drawedge(theta, r, w, N)) < TOL


@pytest.mark.parametrize("r,w,du,dv,N", [(8, 2, 0, 0, 32), (5.5, 3, 1.5, -2,
                                                            33),
                                         (12, 0.5, -3, 4, 48),
                                         (3, 6, 0.25, 0.75, 15)])
def test_drawcirc(r, w, du, dv, N):
    got = TU.drawcirc(r, w, du, dv, N, device="cpu")
    assert got.dtype == torch.float64
    assert _rel(got, JU.drawcirc(r, w, du, dv, N)) < TOL


@pytest.mark.parametrize("draw", [lambda: TU.drawedge(30, 10, 3, 16),
                                  lambda: TU.drawcirc(5, 2, 0, 0, 16)],
                         ids=["drawedge", "drawcirc"])
def test_image_generators_default_to_the_card(draw):
    """Without a card the default device raises: no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        draw()


@pytest.mark.parametrize("name,shapes", [
    ("stacked_2d_matrix_vector_prod", ((4, 3, 5, 6), (4, 3, 6))),
    ("stacked_2d_vector_matrix_prod", ((4, 3, 5), (4, 3, 5, 6))),
    ("stacked_2d_matrix_matrix_prod", ((2, 7, 5, 6), (2, 7, 6, 3)))])
def test_stacked_products(name, shapes):
    rng = np.random.RandomState(1)
    a, b = (rng.randn(*s) for s in shapes)
    want = getattr(JU, name)(a, b)
    fn = getattr(TU, name)
    assert _rel(fn(a, b), want) < TOL
    assert _rel(fn(torch.from_numpy(a), torch.from_numpy(b)), want) < TOL
    assert _rel(fn(torch.from_numpy(a), b), want) < TOL


def test_tensors_keep_their_device():
    m = torch.device("meta")
    assert TU.asfarray(torch.zeros(3, dtype=torch.int64, device=m)).device == m
    assert TU.as_column_vector(torch.zeros(4, device=m)).shape == (4, 1)
    assert TU.as_column_vector(torch.zeros(4, device=m)).device == m
    mats, vecs = torch.zeros(2, 3, 3, device=m), torch.zeros(2, 3, device=m)
    for out in (TU.stacked_2d_matrix_vector_prod(mats, vecs),
                TU.stacked_2d_vector_matrix_prod(vecs, mats),
                TU.stacked_2d_matrix_matrix_prod(mats, mats)):
        assert out.device == m
    assert TU.drawedge(10, 5, 2, 8, device=m).device == m
    assert TU.drawcirc(3, 2, 0, 0, 8, device=m).device == m


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
@pytest.mark.parametrize("include_scale", [False, True])
def test_unpack(layout, include_scale):
    X = np.random.RandomState(2).rand(40, 48)
    jp = jdt.Transform2d().forward(X, nlevels=3, include_scale=include_scale,
                                   layout=layout)
    want = list(JU.unpack(jp))
    got = list(TU.unpack(pyramid_from_numpy(jp, "cpu")))
    assert len(got) == len(want) == (3 if include_scale else 2)
    assert _rel(got[0], want[0]) < TOL
    for g, w in zip(got[1:], want[1:]):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert _rel(a, b) < TOL
