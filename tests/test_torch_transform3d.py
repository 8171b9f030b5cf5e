"""The port's ``Transform3d`` against ``dtcwt_tpu.Transform3d`` (XLA engine,
float64) on the CPU: every pyramid leaf and the inverse at 1e-12 across
levels, layouts, ``ext_mode`` 4 and 8 with pads and crops at levels 2 and
3 (the crop chain through the inverse), ``include_scale``,
``discard_level_1``, a batch, a custom even-length biort pair, the bfloat16
plane layout at storage grade, pyramids carried both ways through
``convert``, and the 3-D band order pinned from theory.  Inputs are made
with numpy from a seed and fed to both packages."""

import itertools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import dtcwt_tpu as jdt
from dtcwt_tpu.ops import engine
from dtcwt_tpu.transforms.pyramid import (
    PlanePyramid as JPlanePyramid, Pyramid as JPyramid)
import dtcwt_tpu_torch as tdt
from dtcwt_tpu_torch.convert import pyramid_from_numpy, pyramid_to_numpy

TOL = 1e-12
BF16_TOL_3D = 0.08      # tests/test_bf16.py, round trip in bfloat16 storage
W_LO = np.pi / 2.15     # tests/test_analytic.py's octant-centre frequencies
W_HI = 3 * np.pi / 2.15


@pytest.fixture(autouse=True)
def _xla_engine():
    with engine.engine("xla"):
        yield


def _err(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.complex128) - want).max())


def _rand(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape)


def _leaves(p):
    if hasattr(p, "highpasses_re"):
        return p.highpasses_re + p.highpasses_im
    return p.highpasses


def _check_pyramid(got, want, tol=TOL):
    assert _err(got.lowpass, want.lowpass) < tol
    assert len(_leaves(got)) == len(_leaves(want))
    for a, b in zip(_leaves(got), _leaves(want)):
        if b is None:
            assert a is None
        else:
            assert _err(a, b) < tol
    if want.scales is None:
        assert got.scales is None
    else:
        assert len(got.scales) == len(want.scales)
        for a, b in zip(got.scales, want.scales):
            assert _err(a, b) < tol


@pytest.mark.parametrize("nlevels", [0, 1, 2, 3])
def test_matches_jax_per_level(nlevels):
    x = _rand((16, 20, 24))
    t, j = tdt.Transform3d(device="cpu"), jdt.Transform3d()
    got = t.forward(torch.from_numpy(x), nlevels)
    want = j.forward(x, nlevels)
    _check_pyramid(got, want)
    assert _err(t.inverse(got), j.inverse(want)) < TOL


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
@pytest.mark.parametrize("ext_mode,shape,fams", [
    (4, (18, 22, 26), ("near_sym_b", "qshift_b")),
    (8, (20, 28, 36), ("near_sym_a", "qshift_a"))])
def test_ext_modes_pad_and_crop_at_levels_2_and_3(ext_mode, shape, fams,
                                                  layout):
    """Every axis is padded before level 2 and again before level 3 (mode 4
    repeats 1 sample a side, mode 8 two), and the inverse crops the same
    samples after each of those levels: the crop chain through the fused
    level >= 2 inverse, which the JAX package's tests never ran."""
    x = _rand(shape, 1)
    t = tdt.Transform3d(*fams, ext_mode=ext_mode, device="cpu")
    j = jdt.Transform3d(*fams, ext_mode=ext_mode)
    got = t.forward(torch.from_numpy(x), 3, layout=layout)
    want = j.forward(x, 3, layout=layout)
    _check_pyramid(got, want)
    rec = t.inverse(got)
    assert _err(rec, j.inverse(want)) < TOL
    assert _err(rec, x) < TOL        # perfect reconstruction


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_batched_include_scale_matches_jax(layout):
    x = _rand((2, 16, 16, 20), 2)
    t, j = tdt.Transform3d(device="cpu"), jdt.Transform3d()
    got = t.forward(torch.from_numpy(x), 3, include_scale=True, layout=layout)
    want = j.forward(x, 3, include_scale=True, layout=layout)
    assert len(got.scales) == 3
    _check_pyramid(got, want)
    assert _err(t.inverse(got), j.inverse(want)) < TOL


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_discard_level_1_matches_jax(layout):
    x = _rand((16, 16, 16), 3)
    t, j = tdt.Transform3d(device="cpu"), jdt.Transform3d()
    got = t.forward(torch.from_numpy(x), 2, discard_level_1=True,
                    layout=layout)
    want = j.forward(x, 2, discard_level_1=True, layout=layout)
    assert _leaves(got)[0] is None
    _check_pyramid(got, want)
    assert _err(t.inverse(got), j.inverse(want)) < TOL


def _haar():
    """tests/test_transform3d.py's even-length (Haar) biort pair."""
    h0 = np.array((0.5, 0.5))
    h1 = h0 * np.cumprod(-np.ones_like(h0))
    g1 = -h0 * np.cumprod(-np.ones_like(h0))
    return (h0, h0, h1, g1)


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_even_length_biort_matches_jax(layout):
    """Even-length level-1 filters take the separable tree (the lowpass
    keeps the extra trailing sample, the highpasses drop it)."""
    x = _rand((2, 8, 10, 12), 4)
    t = tdt.Transform3d(biort=_haar(), device="cpu")
    j = jdt.Transform3d(biort=_haar())
    got = t.forward(torch.from_numpy(x), 1, layout=layout)
    want = j.forward(x, 1, layout=layout)
    assert tuple(got.lowpass.shape) == (2, 9, 11, 13)
    _check_pyramid(got, want)
    assert _err(t.inverse(got), j.inverse(want)) < TOL


def test_bf16_planes_match_jax_at_storage_grade():
    x = _rand((16, 32, 32), 5).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tdt.Transform3d(device="cpu").forward(xt, 2, layout="planes")
    want = jdt.Transform3d().forward(jnp.asarray(x, jnp.bfloat16), 2,
                                     layout="planes")
    assert got.lowpass.dtype == torch.bfloat16
    assert all(r.dtype == torch.bfloat16 for r in _leaves(got))
    f32 = lambda a: a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)
    for a, b in zip((got.lowpass,) + _leaves(got),
                    (want.lowpass,) + _leaves(want)):
        scale = max(float(np.abs(f32(b)).max()), 1.0)
        assert np.abs(f32(a) - f32(b)).max() < 1e-2 * scale
    rec = tdt.Transform3d(device="cpu").inverse(got)
    assert rec.dtype == torch.bfloat16
    assert float((rec.float() - xt.float()).abs().max()) < BF16_TOL_3D
    # the interleaved layout has no bfloat16 complex dtype: it promotes
    p = tdt.Transform3d(device="cpu").forward(xt, 1)
    assert p.highpasses[0].dtype == torch.complex64


def test_input_errors():
    t = tdt.Transform3d(device="cpu")
    with pytest.raises(ValueError, match="3-D"):
        t.forward(torch.zeros(8, 8), 1)
    with pytest.raises(ValueError, match="multiple of 2"):
        t.forward(torch.zeros(8, 8, 9), 1)
    with pytest.raises(ValueError, match="multiple of 4"):
        tdt.Transform3d(ext_mode=8, device="cpu").forward(
            torch.zeros(8, 8, 6), 1)
    with pytest.raises(ValueError, match="ext_mode"):
        tdt.Transform3d(ext_mode=6)
    with pytest.raises(ValueError, match="layout"):
        t.forward(torch.zeros(8, 8, 8), 1, layout="bands")
    with pytest.raises(ValueError, match="odd-length"):
        tdt.Transform3d(biort=_haar(), device="cpu").forward(
            torch.zeros(8, 8, 8), 1, discard_level_1=True)


def test_plane_pyramid_conversions_keep_kind_and_none_levels():
    x = torch.from_numpy(_rand((8, 12, 16), 6))
    t = tdt.Transform3d(device="cpu")
    for discard in (False, True):
        p = t.forward(x, 2, discard_level_1=discard)
        pp = tdt.PlanePyramid.from_interleaved(p, kind="3d")
        assert pp.kind == "3d"
        want = t.forward(x, 2, discard_level_1=discard, layout="planes")
        for a, b in zip(_leaves(pp), _leaves(want)):
            assert (a is None and b is None) or torch.equal(a, b)
        back = pp.interleaved()
        for a, b in zip(back.highpasses, p.highpasses):
            assert (a is None and b is None) or torch.equal(a, b)
        assert "None" in repr(pp) or not discard


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_jax_pyramid_into_port_inverse(layout):
    """A JAX pyramid (with the ``None`` level of ``discard_level_1``)
    through ``pyramid_from_numpy`` into the port's inverse."""
    x = _rand((16, 16, 20), 7)
    for discard in (False, True):
        pj = jdt.Transform3d().forward(x, 2, include_scale=True,
                                       discard_level_1=discard,
                                       layout=layout)
        pt = pyramid_from_numpy(pj, device="cpu")
        if layout == "planes":
            assert isinstance(pt, tdt.PlanePyramid) and pt.kind == "3d"
        assert (_leaves(pt)[0] is None) == discard
        assert _err(tdt.Transform3d(device="cpu").inverse(pt),
                    jdt.Transform3d().inverse(pj)) < TOL


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_port_pyramid_into_jax_inverse(layout):
    x = _rand((2, 12, 16, 16), 8)
    t = tdt.Transform3d(device="cpu")
    for discard in (False, True):
        pn = pyramid_to_numpy(t.forward(torch.from_numpy(x), 2,
                                        discard_level_1=discard,
                                        layout=layout))
        if layout == "planes":
            assert pn.kind == "3d"
            pj = JPlanePyramid(pn.lowpass, pn.highpasses_re,
                               pn.highpasses_im, kind=pn.kind)
        else:
            pj = JPyramid(pn.lowpass, pn.highpasses)
        assert (_leaves(pn)[0] is None) == discard
        assert _err(t.inverse(pn), jdt.Transform3d().inverse(pj)) < TOL


def test_3d_band_indices_match_equations():
    """tests/test_analytic.py::test_3d_band_indices_match_equations run on
    the port: a plane-wave probe with per-axis frequency signs (s1, s2, s3)
    at the level-2 octant centre lands in band 4 m + c of octant m, c =
    2 [s1 < 0] + [s2 < 0] after normalising s3 = +1 (Chen & Kingsbury 2012,
    eqs. (6)-(9)); the octant order is the storage contract."""
    octant_order = [(0, 1, 0), (1, 0, 0), (1, 1, 0), (0, 0, 1),
                    (0, 1, 1), (1, 0, 1), (1, 1, 1)]
    n = np.arange(48)
    X, Y, Z = np.meshgrid(n, n, n, indexing="ij")
    t3 = tdt.Transform3d(device="cpu")
    wlo, whi = W_LO / 4.0, W_HI / 4.0
    for pat in itertools.product((0, 1), repeat=3):
        if not any(pat):
            continue
        m = octant_order.index(pat)
        mags = [whi if h else wlo for h in pat]
        for s2, s3 in itertools.product((1, -1), (1, -1)):
            ph = mags[0] * X + s2 * mags[1] * Y + s3 * mags[2] * Z
            z2 = t3.forward(torch.from_numpy(np.cos(ph)), 2).highpasses[1]
            e = (z2.abs() ** 2).sum(dim=(0, 1, 2)).numpy()
            s1n, s2n = (1, s2) if s3 > 0 else (-1, -s2)
            c = 2 * (s1n < 0) + (s2n < 0)
            assert int(np.argmax(e)) == 4 * m + c, (pat, s2, s3)


def test_runs_on_the_card_unless_asked_for_the_cpu():
    """The default device is CUDA: a numpy volume goes to the card, and
    where there is none the call raises instead of running on the CPU;
    ``discard_level_1`` runs there too (on the single-stream filter
    kernel).  With ``device="cpu"`` every leaf lands on the CPU."""
    x = _rand((8, 8, 12), 9)
    t = tdt.Transform3d()
    assert t.device.type == "cuda"
    if torch.cuda.is_available():
        assert t.forward(x, 2).lowpass.device.type == "cuda"
        p = t.forward(x, 2, discard_level_1=True)
        assert p.highpasses[0] is None
        assert p.lowpass.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            t.forward(x, 2)
    p = tdt.Transform3d(device="cpu").forward(x, 2, layout="planes")
    assert p.lowpass.device.type == "cpu"
    assert all(r.device.type == "cpu" for r in _leaves(p))
