"""Pyramids cross the numpy boundary between the JAX package and the port:
a JAX forward pyramid inverted by the port equals the JAX inverse, and the
reverse, for both containers, with dtypes kept."""

import numpy as np
import pytest
import torch

import dtcwt_tpu as jdt
from dtcwt_tpu.ops import engine
from dtcwt_tpu.transforms.pyramid import (
    PlanePyramid as JPlanePyramid, Pyramid as JPyramid)
import dtcwt_tpu_torch as tdt
from dtcwt_tpu_torch.convert import pyramid_from_numpy, pyramid_to_numpy

TOL = 1e-12


@pytest.fixture(autouse=True)
def _xla_engine():
    with engine.engine("xla"):
        yield


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_jax_pyramid_into_port_inverse(layout):
    x = np.random.RandomState(0).rand(2, 36, 52)
    pj = jdt.Transform2d().forward(x, 3, include_scale=True, layout=layout)
    pt = pyramid_from_numpy(pj, device="cpu")
    assert isinstance(pt, tdt.PlanePyramid if layout == "planes"
                      else tdt.Pyramid)
    assert pt.lowpass.dtype == torch.float64 and len(pt.scales) == 3
    got = tdt.Transform2d(device="cpu").inverse(pt).numpy()
    want = np.asarray(jdt.Transform2d().inverse(pj))
    assert np.abs(got - want).max() < TOL


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_port_pyramid_into_jax_inverse(layout):
    x = np.random.RandomState(1).rand(40, 56)
    pt = tdt.Transform2d(device="cpu").forward(torch.from_numpy(x), 3,
                                               layout=layout)
    pn = pyramid_to_numpy(pt)
    assert isinstance(pn.lowpass, np.ndarray)
    if layout == "planes":
        pj = JPlanePyramid(pn.lowpass, pn.highpasses_re, pn.highpasses_im)
    else:
        assert pn.highpasses[0].dtype == np.complex128
        pj = JPyramid(pn.lowpass, pn.highpasses)
    want = np.asarray(jdt.Transform2d().inverse(pj))
    got = tdt.Transform2d(device="cpu").inverse(pt).numpy()
    assert np.abs(got - want).max() < TOL


def test_bf16_plane_pyramid_round_trips_bits():
    import jax.numpy as jnp
    x = np.random.RandomState(2).rand(32, 48).astype(np.float32)
    pj = jdt.Transform2d().forward(jnp.asarray(x, jnp.bfloat16), 2,
                                   layout="planes")
    pt = pyramid_from_numpy(pj, device="cpu")
    assert pt.highpasses_re[0].dtype == torch.bfloat16
    back = pyramid_to_numpy(pt)
    for a, b in zip(back.highpasses_re + back.highpasses_im,
                    pj.highpasses_re + pj.highpasses_im):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.view(np.uint16),
                                      np.asarray(b).view(np.uint16))
