"""The port's ``registration`` against ``dtcwt_tpu.registration`` (float64,
x64) on the CPU: every public function and the box filter, the 6x6 solve
on a singular block, ``estimatereg`` and its batched form on a seeded
smooth field and its shift, plane pyramids, the shallow-pyramid errors,
the reference's behavioural gate, and the Qtilde grid at widths where the
JAX package's fails.  Both packages take the same pyramid: the JAX
package's transform, moved to the port with ``convert.pyramid_from_numpy``.

Tolerances, relative to the largest value of the JAX result: 1e-12 without
a solve (phases compared modulo 2 pi), 1e-10 through the 6x6 solve (the
bound of ``tests/test_registration.py``).
"""

import functools

import numpy as np
import pytest
import torch

import dtcwt_tpu as jdt
from dtcwt_tpu import registration as JR
import dtcwt_tpu_torch as tdt
from dtcwt_tpu_torch import registration as TR
from dtcwt_tpu_torch.convert import pyramid_from_numpy

TOL = 1e-12
SOLVE_TOL = 1e-10


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-300)
    return float(np.abs(got - want).max()) / scale


def _rel_phase(got, want):
    """The wrapped difference of two angle maps, relative to the largest."""
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape
    d = np.angle(np.exp(1j * (got - want)))
    return float(np.abs(d).max()) / float(np.abs(want).max())


def smooth_pair(h, w, seed=3, shift=(3, 2)):
    """A smooth random field and its roll by *shift* pixels (the pair of
    ``bench.py``), in [0, 1]."""
    rs = np.random.RandomState(seed)
    spec = np.fft.rfft2(rs.rand(h, w))
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    spec *= np.exp(-((fy ** 2 + fx ** 2) / (2 * 0.04 ** 2)))
    f1 = np.fft.irfft2(spec, s=(h, w))
    f1 = (f1 - f1.min()) / (f1.max() - f1.min())
    return f1, np.roll(f1, shift, axis=(0, 1))


@functools.lru_cache(maxsize=None)
def _pyramids(h=128, w=160, nlevels=4):
    """(JAX pyramids, the port's copies on the CPU) of the smooth pair."""
    f1, f2 = smooth_pair(h, w)
    t = jdt.Transform2d()
    j1, j2 = t.forward(f1, nlevels=nlevels), t.forward(f2, nlevels=nlevels)
    return (j1, j2), (pyramid_from_numpy(j1, "cpu"),
                      pyramid_from_numpy(j2, "cpu"))


def _bands(level=2, band=1):
    (j1, j2), _ = _pyramids()
    return (np.array(j1.highpasses[level][:, :, band]),
            np.array(j2.highpasses[level][:, :, band]))


@pytest.mark.parametrize("band", range(6))
def test_phasegradient_matches_jax(band):
    sb1, sb2 = _bands(2, band)
    w = JR.EXPECTED_SHIFTS[band, :]
    got = TR.phasegradient(torch.from_numpy(sb1), torch.from_numpy(sb2), w)
    want = JR.phasegradient(sb1, sb2, w)
    for g, wt in zip(got, want):
        assert _rel_phase(g, wt) < TOL


def test_phasegradient_default_shift_numpy_on_cpu():
    sb1, sb2 = _bands(1, 3)
    got = TR.phasegradient(sb1, sb2, device="cpu")
    want = JR.phasegradient(sb1, sb2)
    for g, wt in zip(got, want):
        assert g.device.type == "cpu"
        assert _rel_phase(g, wt) < TOL


@pytest.mark.parametrize("band", [0, 4])
def test_confidence_matches_jax(band):
    sb1, sb2 = _bands(2, band)
    got = TR.confidence(torch.from_numpy(sb1), torch.from_numpy(sb2))
    assert _rel(got, JR.confidence(sb1, sb2)) < TOL


def test_subband_shape_mismatch_errors():
    sb1, sb2 = _bands()
    for f in (TR.phasegradient, TR.confidence):
        with pytest.raises(ValueError, match="identical size"):
            f(torch.from_numpy(sb1), torch.from_numpy(sb2[:, :-1]))


def test_qtildematrices_match_jax():
    (j1, j2), (t1, t2) = _pyramids()
    got = TR.qtildematrices(t1, t2, [1, 2, 3])
    want = JR.qtildematrices(j1, j2, [1, 2, 3])
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL


def test_qtilde_grid_where_the_jax_package_fails():
    """``np.arange(0, 1, 1 / 49)`` has 50 points, so the JAX package's
    ``_qtilde_level`` raises on a 49-wide band; the port's grid is
    ``arange(49) / 49``, and its sum equals the one assembled in numpy from
    JAX's public ``confidence`` and ``phasegradient`` on that grid."""
    rng = np.random.RandomState(7)
    hp1 = rng.randn(16, 49, 6) + 1j * rng.randn(16, 49, 6)
    hp2 = hp1 * np.exp(0.3j) + 0.1 * (rng.randn(16, 49, 6)
                                      + 1j * rng.randn(16, 49, 6))
    assert len(np.arange(0, 1, 1 / 49)) == 50
    with pytest.raises(TypeError):
        JR._qtilde_level(hp1, hp2)
    h, w = 16, 49
    xs, ys = np.meshgrid(np.arange(w) / w, np.arange(h) / h)
    want = 0.0
    for sb in range(6):
        C = np.asarray(JR.confidence(hp1[:, :, sb], hp2[:, :, sb]))
        dy, dx, dt = (np.asarray(a) for a in JR.phasegradient(
            hp1[:, :, sb], hp2[:, :, sb], JR.EXPECTED_SHIFTS[sb, :]))
        dx, dy = dx * w, dy * h
        tmp = np.stack((dx, dy, xs * dx, xs * dy, ys * dx, ys * dy, -dt), -1)
        r, c = np.triu_indices(6)
        qt = np.concatenate((tmp[..., r] * tmp[..., c],
                             tmp[..., :6] * tmp[..., 6:]), -1)
        want = want + qt * (C ** 2)[..., None]
    got = TR._qtilde_level(torch.from_numpy(hp1), torch.from_numpy(hp2))
    assert _rel(got, want) < TOL


def _qtilde_vectors(shape, seed):
    rng = np.random.RandomState(seed)
    vecs = []
    for _ in range(int(np.prod(shape))):
        M = rng.randn(6, 6)
        Q = M @ M.T + 6 * np.eye(6)
        vecs.append(np.concatenate([Q[np.triu_indices(6)], rng.randn(6)]))
    return np.stack(vecs).reshape(tuple(shape) + (27,))


@pytest.mark.parametrize("shape", [(), (5,), (3, 4)])
def test_solvetransform_matches_jax(shape):
    vecs = _qtilde_vectors(shape, 9)
    got = TR.solvetransform(torch.from_numpy(vecs))
    assert got.shape == tuple(shape) + (6,)
    assert _rel(got, JR.solvetransform(vecs)) < SOLVE_TOL


def test_solvetransform_singular_block_gives_nonfinite_without_raising():
    vecs = _qtilde_vectors((3,), 2)
    vecs[1] = 0.0           # a flat region: zero confidence, zero Qtilde
    got = _np(TR.solvetransform(torch.from_numpy(vecs)))
    want = np.asarray(JR.solvetransform(vecs))
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert not np.isfinite(got[1]).any()
    assert _rel(got[[0, 2]], want[[0, 2]]) < SOLVE_TOL


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("shape", [(16, 12, 3), (9, 7, 27)])
def test_boxfilter_matches_jax(size, shape):
    X = np.random.RandomState(size).randn(*shape)
    got = TR._boxfilter(torch.from_numpy(X), size)
    assert _rel(got, JR._boxfilter(X, size)) < TOL


def test_boxfilter_even_size_errors():
    with pytest.raises(ValueError, match="Kernel size must be odd"):
        TR._boxfilter(torch.zeros(4, 4), 4)


AVECS = np.random.RandomState(4).randn(8, 10, 6) * 0.01


@pytest.mark.parametrize("method", ["bilinear", "lanczos", "nearest"])
def test_velocityfield_and_warp_match_jax(method):
    f1, _ = smooth_pair(128, 160)
    got = TR.velocityfield(torch.from_numpy(AVECS), f1.shape, method)
    want = JR.velocityfield(AVECS, f1.shape, method)
    for g, w in zip(got, want):
        assert _rel(g, w) < TOL
    got = TR.warp(torch.from_numpy(f1), torch.from_numpy(AVECS), method)
    assert _rel(got, JR.warp(f1, AVECS, method)) < TOL


def test_warphighpass_and_normsamplers_match_jax():
    (j1, _), (t1, _) = _pyramids()
    Yh = np.array(j1.highpasses[1])
    got = TR.warphighpass(t1.highpasses[1], torch.from_numpy(AVECS),
                          "bilinear")
    assert _rel(got, JR.warphighpass(Yh, AVECS, "bilinear")) < TOL
    rng = np.random.RandomState(8)
    xs, ys = rng.rand(5, 7) * 1.2 - 0.1, rng.rand(5, 7) * 1.2 - 0.1
    got = TR.normsamplehighpass(t1.highpasses[1], xs, ys, "lanczos")
    assert _rel(got, JR.normsamplehighpass(Yh, xs, ys, "lanczos")) < TOL
    got = TR.normsample(t1.lowpass, xs, ys)
    want = JR.normsample(np.asarray(j1.lowpass), xs, ys)
    assert _rel(got, want) < TOL


def test_warptransform_matches_jax():
    (j1, _), (t1, _) = _pyramids()
    got = TR.warptransform(t1, torch.from_numpy(AVECS), [1, 3], "bilinear")
    want = JR.warptransform(j1, AVECS, [1, 3], "bilinear")
    assert got.lowpass is t1.lowpass
    for level, (g, w) in enumerate(zip(got.highpasses, want.highpasses)):
        assert _rel(g, w) < TOL
        assert (g is t1.highpasses[level]) == (level not in (1, 3))


@functools.lru_cache(maxsize=None)
def _estimatereg_jax():
    (j1, j2), _ = _pyramids()
    return np.asarray(JR.estimatereg(j1, j2))


def test_estimatereg_matches_jax():
    _, (t1, t2) = _pyramids()
    got = TR.estimatereg(t1, t2)
    want = _estimatereg_jax()
    assert got.shape == (8, 10, 6) and want.shape == (8, 10, 6)
    assert np.isfinite(want).all()
    assert _rel(got, want) < SOLVE_TOL


def test_estimatereg_levels_and_regshape_match_jax():
    (j1, j2), (t1, t2) = _pyramids()
    levels = [[3, 2], [2, 1]]
    got = TR.estimatereg(t1, t2, regshape=(12, 9), levels=levels)
    want = np.asarray(JR.estimatereg(j1, j2, regshape=(12, 9),
                                     levels=levels))
    assert _rel(got, want) < SOLVE_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_estimatereg_plane_pyramids_give_the_interleaved_result(dtype):
    f1, f2 = smooth_pair(128, 160)
    t = tdt.Transform2d(device="cpu")
    q1 = t.forward(torch.from_numpy(f1).to(dtype), 4, layout="planes")
    q2 = t.forward(torch.from_numpy(f2).to(dtype), 4, layout="planes")
    got = TR.estimatereg(q1, q2)
    want = TR.estimatereg(q1.interleaved(), q2.interleaved())
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    # and near the float64 estimate (bfloat16 storage costs accuracy)
    tol = 2e-3 if dtype == torch.float32 else 0.1
    assert _rel(got.double(), _estimatereg_jax()) < tol


def _frame_pyramids():
    """JAX and port pyramids of a [4, 96, 128] stack of shifted fields."""
    f1, _ = smooth_pair(96, 128, seed=11)
    frames = np.stack([np.roll(f1, (k, 2 * k), axis=(0, 1))
                       for k in range(4)])
    jp = jdt.Transform2d().forward(frames, nlevels=4)
    return jp, pyramid_from_numpy(jp, "cpu")


def _take(p, sl):
    return tdt.Pyramid(p.lowpass[sl], tuple(h[sl] for h in p.highpasses))


def test_estimatereg_batched_matches_jax_and_the_loop():
    import jax
    jp, tp = _frame_pyramids()
    jtake = lambda sl: jax.tree_util.tree_map(lambda x: x[sl], jp)
    want = np.asarray(JR.estimatereg_batched(jtake(slice(None, -1)),
                                             jtake(slice(1, None))))
    got = TR.estimatereg_batched(_take(tp, slice(None, -1)),
                                 _take(tp, slice(1, None)))
    assert got.shape == want.shape == (3, 6, 8, 6)
    assert _rel(got, want) < SOLVE_TOL
    loop = torch.stack([TR.estimatereg(_take(tp, i), _take(tp, i + 1))
                        for i in range(3)])
    assert _rel(got, loop.numpy()) < SOLVE_TOL


def test_estimatereg_batched_plane_pyramids():
    f1, _ = smooth_pair(96, 128, seed=11)
    frames = torch.from_numpy(np.stack([f1, np.roll(f1, (1, 2), (0, 1))]))
    t = tdt.Transform2d(device="cpu")
    q = t.forward(frames.float(), 4, layout="planes")
    planes = lambda sl: tdt.PlanePyramid(
        q.lowpass[sl], tuple(r[sl] for r in q.highpasses_re),
        tuple(i[sl] for i in q.highpasses_im))
    got = TR.estimatereg_batched(planes(slice(0, 1)), planes(slice(1, 2)))
    p = q.interleaved()
    want = TR.estimatereg(_take(p, 0), _take(p, 1))
    assert got.shape == (1,) + tuple(want.shape)
    assert _rel(got[0], want.numpy()) < 1e-5


def test_shallow_pyramid_errors():
    _, (t1, t2) = _pyramids()
    shallow = tdt.Pyramid(t1.lowpass, t1.highpasses[:3])
    with pytest.raises(ValueError) as e:
        TR.estimatereg(shallow, shallow)
    assert str(e.value) == (
        "estimatereg's default registration grid is the level-4 subband "
        "shape, but the pyramid has only 3 levels; either transform with "
        "nlevels >= 4 or pass regshape explicitly.")
    one = tdt.Pyramid(t1.lowpass[None], (t1.highpasses[0][None],))
    with pytest.raises(ValueError) as e:
        TR.estimatereg_batched(one, one)
    assert str(e.value) == (
        "estimatereg_batched's default registration grid is the level-4 "
        "subband shape, but the pyramid has only 1 level; either transform "
        "with nlevels >= 4 or pass regshape explicitly.")
    # with regshape given, three levels register
    got = TR.estimatereg(shallow, tdt.Pyramid(t2.lowpass, t2.highpasses[:3]),
                         regshape=(8, 10), levels=[[2, 1], [2, 1]])
    assert got.shape == (8, 10, 6) and bool(torch.isfinite(got).all())


def test_behavioural_gate_on_the_port():
    """``tests/test_registration.py``'s gate, the port alone: warping the
    source by the estimate brings it closer to the reference."""
    f1, f2 = smooth_pair(192, 256, seed=5)
    t = tdt.Transform2d(device="cpu")
    p1, p2 = t.forward(f1, nlevels=6), t.forward(f2, nlevels=6)
    avecs = TR.estimatereg(p1, p2)
    warped = TR.warp(torch.from_numpy(f1), avecs, method="bilinear").numpy()
    assert np.mean(np.abs(warped - f2)) < np.mean(np.abs(f1 - f2))


def test_numpy_pyramid_without_a_card_raises_naming_device_cpu(monkeypatch):
    (j1, j2), _ = _pyramids()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.estimatereg(j1, j2)
    got = TR.estimatereg(j1, j2, device="cpu")
    assert _rel(got, _estimatereg_jax()) < SOLVE_TOL
