"""The port's ``Transform2d`` against ``dtcwt_tpu.Transform2d`` (XLA engine,
float64) on the CPU: every pyramid leaf and the inverse at 1e-12, the
bfloat16 plane layout at storage grade, and perfect reconstruction.
Inputs are made with numpy from a seed and fed to both packages."""

import numpy as np
import pytest
import torch

import dtcwt_tpu as jdt
from dtcwt_tpu.ops import engine
import dtcwt_tpu_torch as tdt

TOL = 1e-12
BF16_TOL_2D = 0.04      # tests/test_bf16.py, round trip in bfloat16 storage


@pytest.fixture(autouse=True)
def _xla_engine():
    with engine.engine("xla"):
        yield


def _err(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.complex128) - want).max())


def _rand(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape)


def _check_pyramid(got, want, tol=TOL):
    assert _err(got.lowpass, want.lowpass) < tol
    if isinstance(got, tdt.PlanePyramid):
        assert len(got.highpasses_re) == len(want.highpasses_re)
        for a, b in zip(got.highpasses_re, want.highpasses_re):
            assert _err(a, b) < tol
        for a, b in zip(got.highpasses_im, want.highpasses_im):
            assert _err(a, b) < tol
    else:
        assert len(got.highpasses) == len(want.highpasses)
        for a, b in zip(got.highpasses, want.highpasses):
            assert _err(a, b) < tol
    if want.scales is None:
        assert got.scales is None
    else:
        for a, b in zip(got.scales, want.scales):
            assert _err(a, b) < tol


@pytest.mark.parametrize("nlevels", [1, 2, 3, 4])
def test_matches_jax_odd_size(nlevels):
    x = _rand((37, 50))
    got = tdt.Transform2d().forward(torch.from_numpy(x), nlevels)
    want = jdt.Transform2d().forward(x, nlevels)
    _check_pyramid(got, want)
    assert _err(tdt.Transform2d().inverse(got),
                jdt.Transform2d().inverse(want)) < TOL


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_matches_jax_batched_pad_and_crop(layout):
    """Two leading batch axes; 50 x 70 pads before levels 2, 3 and 4 and
    crops after their inverses."""
    x = _rand((2, 3, 50, 70), 1)
    t, j = tdt.Transform2d("near_sym_b", "qshift_b"), \
        jdt.Transform2d("near_sym_b", "qshift_b")
    got = t.forward(torch.from_numpy(x), 4, layout=layout)
    want = j.forward(x, 4, layout=layout)
    _check_pyramid(got, want)
    assert _err(t.inverse(got), j.inverse(want)) < TOL


def test_include_scale_matches_jax():
    x = _rand((2, 36, 44), 2)
    got = tdt.Transform2d().forward(torch.from_numpy(x), 3,
                                    include_scale=True)
    want = jdt.Transform2d().forward(x, 3, include_scale=True)
    assert len(got.scales) == 3
    _check_pyramid(got, want)


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_gain_mask_matches_jax(layout):
    x = _rand((40, 48), 3)
    gm = np.linspace(0.1, 1.5, 18).reshape(6, 3)
    t, j = tdt.Transform2d(), jdt.Transform2d()
    got = t.inverse(t.forward(torch.from_numpy(x), 3, layout=layout), gm)
    want = j.inverse(j.forward(x, 3, layout=layout), gm)
    assert _err(got, want) < TOL


def test_bandpass_family_matches_jax():
    x = _rand((40, 60), 4)
    t = tdt.Transform2d("near_sym_b_bp", "qshift_b_bp")
    j = jdt.Transform2d("near_sym_b_bp", "qshift_b_bp")
    for layout in ("interleaved", "planes"):
        got = t.forward(torch.from_numpy(x), 3, layout=layout)
        want = j.forward(x, 3, layout=layout)
        _check_pyramid(got, want)
        assert _err(t.inverse(got), j.inverse(want)) < TOL


def test_explicit_coefficient_tuples():
    """Filters given as tuples of numpy arrays act as the named family."""
    x = torch.from_numpy(_rand((32, 32), 5))
    named = tdt.Transform2d("near_sym_b", "qshift_c")
    explicit = tdt.Transform2d(
        tuple(np.array(h) for h in jdt.biort("near_sym_b")),
        tuple(np.array(h) for h in jdt.qshift("qshift_c")))
    got, want = explicit.forward(x, 3), named.forward(x, 3)
    assert torch.equal(got.lowpass, want.lowpass)
    assert all(torch.equal(a, b)
               for a, b in zip(got.highpasses, want.highpasses))
    with pytest.raises(ValueError):
        tdt.Transform2d(biort=(np.ones(3),) * 3)


def test_bf16_planes_match_jax_at_storage_grade():
    x = _rand((2, 64, 96), 6).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tdt.Transform2d().forward(xt, 3, layout="planes")
    import jax.numpy as jnp
    want = jdt.Transform2d().forward(jnp.asarray(x, jnp.bfloat16), 3,
                                     layout="planes")
    assert got.lowpass.dtype == torch.bfloat16
    assert all(r.dtype == torch.bfloat16 for r in got.highpasses_re)
    f32 = lambda a: a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)
    for a, b in zip((got.lowpass,) + got.highpasses_re + got.highpasses_im,
                    (want.lowpass,) + want.highpasses_re
                    + want.highpasses_im):
        scale = max(float(np.abs(f32(b)).max()), 1.0)
        assert np.abs(f32(a) - f32(b)).max() < 1e-2 * scale
    rec = tdt.Transform2d().inverse(got)
    assert rec.dtype == torch.bfloat16
    assert float((rec.float() - xt.float()).abs().max()) < BF16_TOL_2D


@pytest.mark.parametrize("biort,qshift", [
    ("near_sym_a", "qshift_a"), ("near_sym_b", "qshift_b"),
    ("antonini", "qshift_d"), ("legall", "qshift_06")])
@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_perfect_reconstruction(biort, qshift, layout):
    x = torch.from_numpy(_rand((2, 64, 80), 7))
    t = tdt.Transform2d(biort, qshift)
    assert float((t.inverse(t.forward(x, 3, layout=layout)) - x).abs()
                 .max()) < TOL


def test_plane_pyramid_conversions_round_trip():
    x = torch.from_numpy(_rand((24, 32), 8))
    p = tdt.Transform2d().forward(x, 2)
    pp = tdt.PlanePyramid.from_interleaved(p)
    back = pp.interleaved()
    for a, b in zip(back.highpasses, p.highpasses):
        assert torch.equal(a, b)
    want = tdt.Transform2d().forward(x, 2, layout="planes")
    for a, b in zip(pp.highpasses_re, want.highpasses_re):
        assert torch.equal(a, b)


def test_zero_levels_and_input_errors():
    x = torch.from_numpy(_rand((9, 12), 9))
    p = tdt.Transform2d().forward(x, 0)
    assert p.highpasses == () and p.lowpass.shape == (10, 12)
    assert torch.equal(tdt.Transform2d().inverse(p), p.lowpass)
    with pytest.raises(ValueError):
        tdt.Transform2d().forward(torch.zeros(8), 1)
    with pytest.raises(ValueError):
        tdt.Transform2d().forward(x, 1, layout="bands")
