"""The port's ``Transform1d`` against ``dtcwt_tpu.Transform1d`` (XLA engine,
float64) on the CPU: every pyramid leaf and the inverse at 1e-12, the
bfloat16 plane layout at storage grade, the error cases, and pyramids
carried between the two packages through ``convert``.

The port runs the flat transform only.  Where the JAX package folds a long
signal with few columns into lanes (``[N, 1]`` with N >= 4096), its result
is held against the port's flat one, so the claim that folding is
bit-identical to the flat transform is checked, not assumed.  Inputs are
made with numpy from a seed and fed to both packages."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import dtcwt_tpu as jdt
from dtcwt_tpu.ops import engine
from dtcwt_tpu.transforms.pyramid import (
    PlanePyramid as JPlanePyramid, Pyramid as JPyramid)
from dtcwt_tpu.transforms.transform1d import _fold_plan
import dtcwt_tpu_torch as tdt
from dtcwt_tpu_torch.convert import pyramid_from_numpy, pyramid_to_numpy

TOL = 1e-12
BF16_TOL_1D = 0.02      # tests/test_bf16.py, 3-level 1-D round trip


@pytest.fixture(autouse=True)
def _xla_engine():
    with engine.engine("xla"):
        yield


def _t(*args):
    return tdt.Transform1d(*args, device="cpu")


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
        assert got.kind == want.kind == "1d"
        assert len(got.highpasses_re) == len(want.highpasses_re)
        for a, b in zip(got.highpasses_re + got.highpasses_im,
                        want.highpasses_re + want.highpasses_im):
            assert _err(a, b) < tol
    else:
        assert len(got.highpasses) == len(want.highpasses)
        for a, b in zip(got.highpasses, want.highpasses):
            assert _err(a, b) < tol
    if want.scales is None:
        assert got.scales is None
    else:
        assert len(got.scales) == len(want.scales)
        for a, b in zip(got.scales, want.scales):
            assert _err(a, b) < tol


def _both(x, nlevels, fams=(), **kw):
    """Forward and inverse in both packages; checks every leaf."""
    t, j = _t(*fams), jdt.Transform1d(*fams)
    got = t.forward(x, nlevels, **kw)
    want = j.forward(x, nlevels, **kw)
    _check_pyramid(got, want)
    rec = t.inverse(got)
    assert _err(rec, j.inverse(want)) < TOL
    return got, rec


@pytest.mark.parametrize("nlevels", [0, 1, 2, 3, 4, 5])
def test_vector_matches_jax(nlevels):
    """A length-100 vector: 50 samples at level 2 pad to 52, 26 to 28 and so
    on, and the inverse crops each pad away."""
    x = _rand((100,), nlevels)
    _, rec = _both(x, nlevels)
    # as in the JAX package, zero levels return the lowpass column as it is
    assert rec.shape == ((100,) if nlevels else (100, 1))
    assert float(np.abs(rec.numpy().reshape(-1) - x).max()) < TOL


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_columns_match_jax(layout):
    """[N, C] with C = 20 > 16 columns: the flat path on both sides, with
    near_sym_b's filters of unequal length and the 14-tap qshift_d."""
    x = _rand((68, 20), 1)
    got, rec = _both(x, 4, ("near_sym_b", "qshift_d"), layout=layout,
                     include_scale=True)
    assert len(got.scales) == 4
    assert float(np.abs(rec.numpy() - x).max()) < TOL


def test_long_single_signal_matches_jax_folded_path():
    """[4096, 1]: the JAX package folds it into lanes, the port does not."""
    x = _rand((4096, 1), 2)
    assert _fold_plan(4096, 1, 5, 3, 10) is not None
    _, rec = _both(x, 5)
    assert rec.shape == (4096,)


def test_forward_channels_matches_jax():
    x = _rand((2, 40, 3), 3)
    t, j = _t("near_sym_a", "qshift_c"), jdt.Transform1d("near_sym_a",
                                                          "qshift_c")
    got = t.forward_channels(x, 3, include_scale=True)
    want = j.forward_channels(x, 3, include_scale=True)
    _check_pyramid(got, want)
    rec = t.inverse_channels(got)
    assert _err(rec, j.inverse_channels(want)) < TOL
    assert float(np.abs(rec.numpy() - x).max()) < TOL


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_gain_mask_matches_jax(layout):
    x = _rand((64, 18), 4)
    gm = np.array([0.0, 1.5, 0.25])
    t, j = _t(), jdt.Transform1d()
    got = t.inverse(t.forward(x, 3, layout=layout), gm)
    want = j.inverse(j.forward(x, 3, layout=layout), gm)
    assert _err(got, want) < TOL


def test_bf16_planes_at_storage_grade():
    x = _rand((1024,), 9).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = _t().forward(xt, 3, layout="planes")
    want = jdt.Transform1d().forward(jnp.asarray(x, jnp.bfloat16), 3,
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
    rec = _t().inverse(got)
    assert rec.dtype == torch.bfloat16
    assert float(np.abs(rec.float().numpy() - x).max()) < BF16_TOL_1D
    assert got.interleaved().highpasses[0].dtype == torch.complex64
    # bfloat16 asked for the interleaved layout computes and stores float32
    assert _t().forward(xt, 2).lowpass.dtype == torch.float32


def test_plane_pyramid_conversions_round_trip():
    x = torch.from_numpy(_rand((48, 5), 5))
    p = _t().forward(x, 3)
    pp = tdt.PlanePyramid.from_interleaved(p, kind="1d")
    assert pp.kind == "1d"
    for a, b in zip(pp.interleaved().highpasses, p.highpasses):
        assert torch.equal(a, b)
    want = _t().forward(x, 3, layout="planes")
    for a, b in zip(pp.highpasses_re + pp.highpasses_im,
                    want.highpasses_re + want.highpasses_im):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_jax_pyramid_into_port_inverse(layout):
    x = _rand((36, 20), 6)
    pj = jdt.Transform1d().forward(x, 3, include_scale=True, layout=layout)
    pt = pyramid_from_numpy(pj, device="cpu")
    if layout == "planes":
        assert isinstance(pt, tdt.PlanePyramid) and pt.kind == "1d"
    assert len(pt.scales) == 3
    assert _err(_t().inverse(pt), jdt.Transform1d().inverse(pj)) < TOL


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_port_pyramid_into_jax_inverse(layout):
    x = _rand((44, 1), 7)
    pn = pyramid_to_numpy(_t().forward(torch.from_numpy(x), 3,
                                       layout=layout))
    if layout == "planes":
        assert pn.kind == "1d"
        pj = JPlanePyramid(pn.lowpass, pn.highpasses_re, pn.highpasses_im,
                           kind=pn.kind)
    else:
        pj = JPyramid(pn.lowpass, pn.highpasses)
    want = np.asarray(jdt.Transform1d().inverse(pj))
    assert want.shape == (44,)
    assert _err(_t().inverse(pn), want) < TOL


def test_runs_on_the_card_unless_asked_for_the_cpu():
    x = _rand((64, 3), 8)
    t = tdt.Transform1d()
    assert t.device.type == "cuda"
    if torch.cuda.is_available():
        assert t.forward(x, 2).lowpass.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            t.forward(x, 2)
    p = _t().forward(torch.from_numpy(x), 2, layout="planes")
    assert p.lowpass.device.type == "cpu" and p.kind == "1d"


def test_input_errors():
    t = _t()
    with pytest.raises(ValueError, match="multiple of 2"):
        t.forward(_rand((9,)), 2)
    with pytest.raises(ValueError, match="layout"):
        t.forward(_rand((8,)), 2, layout="bands")
    with pytest.raises(ValueError, match="bandpass"):
        _t("near_sym_b_bp", "qshift_b_bp")
    with pytest.raises(ValueError, match="forward_channels"):
        t.forward_channels(_rand((8, 2)), 2)
    with pytest.raises(ValueError, match="inverse_channels"):
        t.inverse_channels(t.forward(_rand((8, 2)), 2))
