"""The port's ``sampling`` against ``dtcwt_tpu.sampling`` (float64, x64) on
the CPU: the gather samplers with every method on real and complex images
with trailing channels and coordinates out of range on every side, the
separable rescale up and down, the highpass forms with and without a
subband selection, the factor-two upsamplers, the result dtypes and the
errors.  Inputs are made with numpy from a seed and fed to both packages.

Tolerance: float64 1e-12 relative to the largest value of the JAX result.
"""

import numpy as np
import pytest
import torch

from dtcwt_tpu import sampling as JS
from dtcwt_tpu_torch import sampling as TS

TOL = 1e-12
METHODS = ["nearest", "bilinear", "lanczos"]

RNG = np.random.RandomState(5)
IM = RNG.randn(13, 17)
IMC = RNG.randn(12, 10, 2, 3) + 1j * RNG.randn(12, 10, 2, 3)
HP = RNG.randn(14, 11, 6) + 1j * RNG.randn(14, 11, 6)
# coordinates past every edge: x over [-9, 27), y over [-8, 22)
XS = RNG.rand(9, 8) * 36 - 9
YS = RNG.rand(9, 8) * 30 - 8


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    return float(np.abs(got - want).max()) / scale


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("image", ["real", "complex channels"])
def test_sample_matches_jax(method, image):
    im = IM if image == "real" else IMC
    got = TS.sample(_t(im), _t(XS), _t(YS), method)
    want = JS.sample(im, XS, YS, method)
    assert got.dtype == torch.from_numpy(np.array(want)).dtype
    assert _rel(got, want) < TOL


def test_sample_integer_coordinates_and_default_method():
    xs = np.arange(-3, 20).reshape(1, -1)
    ys = np.arange(-5, 18).reshape(1, -1)
    got = TS.sample(_t(IM), _t(xs), _t(ys))
    want = JS.sample(IM, xs, ys)
    assert _rel(got, want) < TOL


def test_sample_numpy_inputs_with_device_cpu():
    got = TS.sample(IM, XS, YS, "bilinear", device="cpu")
    assert got.device.type == "cpu"
    assert _rel(got, JS.sample(IM, XS, YS, "bilinear")) < TOL


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", [(29, 40), (6, 5), (13, 9)])
@pytest.mark.parametrize("image", ["real", "complex channels"])
def test_rescale_matches_jax(method, shape, image):
    im = IM if image == "real" else IMC
    got = TS.rescale(_t(im), shape, method)
    want = JS.rescale(im, shape, method)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("sbs", [None, [0, 2, 5], [4, 1]])
def test_sample_highpass_matches_jax(method, sbs):
    xs = RNG.rand(7, 6) * 18 - 3
    ys = RNG.rand(7, 6) * 22 - 4
    got = TS.sample_highpass(_t(HP), _t(xs), _t(ys), method, sbs=sbs)
    want = JS.sample_highpass(HP, xs, ys, method, sbs=sbs)
    assert got.shape[-1] == (6 if sbs is None else len(sbs))
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("sbs", [None, [5, 0, 3]])
@pytest.mark.parametrize("shape", [(28, 22), (9, 7)])
def test_rescale_highpass_matches_jax(method, sbs, shape):
    got = TS.rescale_highpass(_t(HP), shape, method, sbs=sbs)
    want = JS.rescale_highpass(HP, shape, method, sbs=sbs)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("image", ["real", "complex channels"])
def test_upsample_matches_jax(method, image):
    im = IM if image == "real" else IMC
    got = TS.upsample(_t(im), method)
    want = JS.upsample(im, method)
    assert got.shape == (2 * im.shape[0], 2 * im.shape[1]) + im.shape[2:]
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("method", METHODS)
def test_upsample_highpass_matches_jax(method):
    got = TS.upsample_highpass(_t(HP), method)
    want = JS.upsample_highpass(HP, method)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("method,dtype", [
    ("lanczos", torch.float64), ("bilinear", torch.float32),
    ("nearest", torch.float32)])
def test_result_dtype_of_a_float32_image_at_float64_coordinates(method,
                                                                dtype):
    """As in JAX with x64: lanczos promotes to the coordinates' float64,
    bilinear casts back to the image's dtype, nearest gathers it."""
    im = IM.astype(np.float32)
    got = TS.sample(_t(im), _t(XS), _t(YS), method)
    want = np.asarray(JS.sample(im, XS, YS, method))
    assert got.dtype == dtype
    assert want.dtype == torch.empty((), dtype=dtype).numpy().dtype
    assert _rel(got.double(), want.astype(np.float64)) < 1e-6


def test_result_dtypes_of_complex64_stacks():
    hp = HP.astype(np.complex64)
    xs, ys = XS.astype(np.float32), YS.astype(np.float32)
    assert TS.sample_highpass(_t(hp), _t(xs), _t(ys)).dtype == \
        torch.complex64
    assert TS.sample_highpass(_t(hp), _t(XS), _t(YS)).dtype == \
        torch.complex128
    assert TS.rescale_highpass(_t(hp), (9, 9)).dtype == torch.complex64
    assert TS.upsample_highpass(_t(hp)).dtype == torch.complex64
    assert TS.rescale(_t(IM.astype(np.float32)), (5, 5)).dtype == \
        torch.float32


def test_float32_highpass_forms_against_float64():
    """The float64 phase keeps a float32 stack's ramps accurate."""
    hp32 = _t(HP.astype(np.complex64))
    for got, want in ((TS.rescale_highpass(hp32, (28, 22), "bilinear"),
                       TS.rescale_highpass(_t(HP), (28, 22), "bilinear")),
                      (TS.upsample_highpass(hp32, "lanczos"),
                       TS.upsample_highpass(_t(HP), "lanczos"))):
        assert _rel(got.to(torch.complex128), want.numpy()) < 1e-5


def test_errors():
    with pytest.raises(ValueError, match="Shape of xs and ys must match"):
        TS.sample(_t(IM), _t(XS), _t(YS[:, :3]))
    with pytest.raises(NotImplementedError, match="cubic"):
        TS.sample(_t(IM), _t(XS), _t(YS), "cubic")
    with pytest.raises(NotImplementedError, match="cubic"):
        TS.rescale(_t(IM), (5, 5), "cubic")
    with pytest.raises(ValueError, match="Unknown interpolation mode"):
        TS.upsample(_t(IM), "cubic")
    with pytest.raises(ValueError, match="Shape of xs and ys must match"):
        TS.sample_highpass(_t(HP), _t(XS), _t(YS[:3]))


def test_numpy_input_without_a_card_raises_naming_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TS.sample(IM, XS, YS),
                 lambda: TS.rescale(IM, (4, 4)),
                 lambda: TS.upsample_highpass(HP)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
