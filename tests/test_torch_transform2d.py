"""The port's ``Transform2d`` against ``dtcwt_tpu.Transform2d`` (XLA engine,
float64) on the CPU: every pyramid leaf and the inverse at 1e-12, the
bfloat16 plane layout at storage grade, perfect reconstruction, and the
channel adapters in every data format with their format errors.
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
    got = tdt.Transform2d(device="cpu").forward(torch.from_numpy(x), nlevels)
    want = jdt.Transform2d().forward(x, nlevels)
    _check_pyramid(got, want)
    assert _err(tdt.Transform2d(device="cpu").inverse(got),
                jdt.Transform2d().inverse(want)) < TOL


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_matches_jax_batched_pad_and_crop(layout):
    """Two leading batch axes; 50 x 70 pads before levels 2, 3 and 4 and
    crops after their inverses."""
    x = _rand((2, 3, 50, 70), 1)
    t, j = tdt.Transform2d("near_sym_b", "qshift_b", device="cpu"), \
        jdt.Transform2d("near_sym_b", "qshift_b")
    got = t.forward(torch.from_numpy(x), 4, layout=layout)
    want = j.forward(x, 4, layout=layout)
    _check_pyramid(got, want)
    assert _err(t.inverse(got), j.inverse(want)) < TOL


def test_include_scale_matches_jax():
    x = _rand((2, 36, 44), 2)
    got = tdt.Transform2d(device="cpu").forward(torch.from_numpy(x), 3,
                                    include_scale=True)
    want = jdt.Transform2d().forward(x, 3, include_scale=True)
    assert len(got.scales) == 3
    _check_pyramid(got, want)


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_gain_mask_matches_jax(layout):
    x = _rand((40, 48), 3)
    gm = np.linspace(0.1, 1.5, 18).reshape(6, 3)
    t, j = tdt.Transform2d(device="cpu"), jdt.Transform2d()
    got = t.inverse(t.forward(torch.from_numpy(x), 3, layout=layout), gm)
    want = j.inverse(j.forward(x, 3, layout=layout), gm)
    assert _err(got, want) < TOL


def test_bandpass_family_matches_jax():
    x = _rand((40, 60), 4)
    t = tdt.Transform2d("near_sym_b_bp", "qshift_b_bp",
                          device="cpu")
    j = jdt.Transform2d("near_sym_b_bp", "qshift_b_bp")
    for layout in ("interleaved", "planes"):
        got = t.forward(torch.from_numpy(x), 3, layout=layout)
        want = j.forward(x, 3, layout=layout)
        _check_pyramid(got, want)
        assert _err(t.inverse(got), j.inverse(want)) < TOL


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_bandpass_odd_size_scales_and_gain_mask_match_jax(layout):
    """The bandpass families as explicit 6- and 12-tuples on an odd-sized
    batch (edge duplication, pads before levels 2-4, crops after their
    inverses), with include_scale and a gain mask: every leaf and the
    inverse against JAX at 1e-12."""
    x = _rand((2, 37, 75), 13)
    fams = ("near_sym_b_bp", "qshift_b_bp")
    t = tdt.Transform2d(tuple(np.array(h) for h in jdt.biort(fams[0])),
                        tuple(np.array(h) for h in jdt.qshift(fams[1])),
                        device="cpu")
    j = jdt.Transform2d(*fams)
    got = t.forward(torch.from_numpy(x), 4, include_scale=True, layout=layout)
    want = j.forward(x, 4, include_scale=True, layout=layout)
    _check_pyramid(got, want)
    gm = np.linspace(0.2, 1.4, 24).reshape(6, 4)
    assert _err(t.inverse(got, gm), j.inverse(want, gm)) < TOL


def test_explicit_coefficient_tuples():
    """Filters given as tuples of numpy arrays act as the named family."""
    x = torch.from_numpy(_rand((32, 32), 5))
    named = tdt.Transform2d("near_sym_b", "qshift_c", device="cpu")
    explicit = tdt.Transform2d(
        tuple(np.array(h) for h in jdt.biort("near_sym_b")),
        tuple(np.array(h) for h in jdt.qshift("qshift_c")), device="cpu")
    got, want = explicit.forward(x, 3), named.forward(x, 3)
    assert torch.equal(got.lowpass, want.lowpass)
    assert all(torch.equal(a, b)
               for a, b in zip(got.highpasses, want.highpasses))
    with pytest.raises(ValueError):
        tdt.Transform2d(biort=(np.ones(3),) * 3)


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def _bf16_planes(x, *fams):
    """The port's and JAX's bfloat16 plane pyramids of *x*, the leaves held
    to each other at storage grade (1e-2 of the larger of 1 and the leaf's
    largest value)."""
    import jax.numpy as jnp
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tdt.Transform2d(*fams, device="cpu").forward(xt, 3,
                                                       layout="planes")
    want = jdt.Transform2d(*fams).forward(jnp.asarray(x, jnp.bfloat16), 3,
                                          layout="planes")
    assert got.lowpass.dtype == torch.bfloat16
    assert all(r.dtype == torch.bfloat16 for r in got.highpasses_re)
    for a, b in zip((got.lowpass,) + got.highpasses_re + got.highpasses_im,
                    (want.lowpass,) + want.highpasses_re
                    + want.highpasses_im):
        scale = max(float(np.abs(_f32(b)).max()), 1.0)
        assert np.abs(_f32(a) - _f32(b)).max() < 1e-2 * scale
    return xt, got, want


def test_bf16_planes_match_jax_at_storage_grade():
    x = _rand((2, 64, 96), 6).astype(np.float32)
    xt, got, _ = _bf16_planes(x)
    rec = tdt.Transform2d(device="cpu").inverse(got)
    assert rec.dtype == torch.bfloat16
    assert float((rec.float() - xt.float()).abs().max()) < BF16_TOL_2D


def test_bandpass_bf16_planes_match_jax_at_storage_grade():
    """The bandpass families do not reconstruct perfectly, so the bfloat16
    inverse is held to JAX's, at the round trip's storage grade."""
    fams = ("near_sym_b_bp", "qshift_b_bp")
    x = _rand((2, 64, 96), 14).astype(np.float32)
    _, got, want = _bf16_planes(x, *fams)
    rec = tdt.Transform2d(*fams, device="cpu").inverse(got)
    assert rec.dtype == torch.bfloat16
    rec_j = jdt.Transform2d(*fams).inverse(want)
    assert np.abs(_f32(rec) - _f32(rec_j)).max() < BF16_TOL_2D


@pytest.mark.parametrize("biort,qshift", [
    ("near_sym_a", "qshift_a"), ("near_sym_b", "qshift_b"),
    ("antonini", "qshift_d"), ("legall", "qshift_06")])
@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_perfect_reconstruction(biort, qshift, layout):
    x = torch.from_numpy(_rand((2, 64, 80), 7))
    t = tdt.Transform2d(biort, qshift, device="cpu")
    assert float((t.inverse(t.forward(x, 3, layout=layout)) - x).abs()
                 .max()) < TOL


def test_plane_pyramid_conversions_round_trip():
    x = torch.from_numpy(_rand((24, 32), 8))
    p = tdt.Transform2d(device="cpu").forward(x, 2)
    pp = tdt.PlanePyramid.from_interleaved(p)
    back = pp.interleaved()
    for a, b in zip(back.highpasses, p.highpasses):
        assert torch.equal(a, b)
    want = tdt.Transform2d(device="cpu").forward(x, 2, layout="planes")
    for a, b in zip(pp.highpasses_re, want.highpasses_re):
        assert torch.equal(a, b)


def test_zero_levels_and_input_errors():
    x = torch.from_numpy(_rand((9, 12), 9))
    p = tdt.Transform2d(device="cpu").forward(x, 0)
    assert p.highpasses == () and p.lowpass.shape == (10, 12)
    assert torch.equal(tdt.Transform2d(device="cpu").inverse(p), p.lowpass)
    with pytest.raises(ValueError):
        tdt.Transform2d(device="cpu").forward(torch.zeros(8), 1)
    with pytest.raises(ValueError):
        tdt.Transform2d(device="cpu").forward(x, 1, layout="bands")


def test_runs_on_the_card_unless_asked_for_the_cpu():
    """The default device is CUDA: a numpy image goes to the card, and where
    there is none the call raises instead of running on the CPU.  With
    ``device="cpu"`` every input and pyramid leaf lands on the CPU."""
    x = _rand((16, 24), 10)
    t = tdt.Transform2d()
    assert t.device.type == "cuda"
    if torch.cuda.is_available():
        assert t.forward(x, 2).lowpass.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            t.forward(x, 2)
    c = tdt.Transform2d(device="cpu")
    p = c.forward(x, 2, layout="planes")
    assert p.lowpass.device.type == "cpu"
    pn = tdt.PlanePyramid(p.lowpass.numpy(), [r.numpy() for r in
                                              p.highpasses_re],
                          [i.numpy() for i in p.highpasses_im])
    assert torch.equal(c.inverse(pn), c.inverse(p))


# --- the channel/batch layout adapters --------------------------------------

_FORMAT_SHAPES = {"nhw": (3, 20, 24), "chw": (2, 20, 24),
                  "hwn": (20, 24, 3), "hwc": (20, 24, 2),
                  "nchw": (2, 3, 20, 24), "nhwc": (2, 20, 24, 3)}


@pytest.mark.parametrize("fmt", sorted(_FORMAT_SHAPES))
def test_channel_adapters_match_jax(fmt):
    """forward_channels / inverse_channels in every data format: the batch
    and channel axes stay where the input has them, every leaf (scales
    included) and the inverse match JAX at 1e-12, and an upper-case format
    name is accepted."""
    x = _rand(_FORMAT_SHAPES[fmt], 11)
    t, j = tdt.Transform2d(device="cpu"), jdt.Transform2d()
    got = t.forward_channels(torch.from_numpy(x), fmt.upper(), 3,
                             include_scale=True)
    want = j.forward_channels(x, fmt.upper(), 3, include_scale=True)
    _check_pyramid(got, want)
    rec = t.inverse_channels(got, fmt)
    assert _err(rec, j.inverse_channels(want, fmt)) < TOL
    assert _err(rec, x) < TOL


def test_channel_adapter_format_errors_match_jax():
    t, j = tdt.Transform2d(device="cpu"), jdt.Transform2d()
    x = _rand((2, 8, 8, 3), 12)
    for fmt, arr in (("nwhc", x), ("nhw", x), ("nchw", x[0])):
        with pytest.raises(ValueError) as want:
            j.forward_channels(arr, fmt)
        with pytest.raises(ValueError) as got:
            t.forward_channels(torch.from_numpy(arr), fmt)
        assert str(got.value) == str(want.value)
    p = t.forward_channels(torch.from_numpy(x), "nhwc", 2)
    with pytest.raises(ValueError, match="expects a 3-D input"):
        t.inverse_channels(p, "hwc")
