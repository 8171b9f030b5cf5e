"""The port's ``keypoint.find_keypoints`` against ``dtcwt_tpu.keypoint``
(float64, x64) on the CPU: every energy method with position refinement on
and off, with and without ``max_points`` and ``threshold``; the two
upsampling options; ``skip_levels`` 0, 1 and 2; the empty result and the
unknown-method error.  Both packages take the same highpasses: the JAX
package's transform of a seeded textured field.

Rows are compared as sets: ``lax.top_k`` and the JAX package's host
``argsort`` may order ties differently from the port, so both results are
sorted by (energy, x, y, scale) first.  Where ties could straddle the
``max_points`` cut (the blocky energies of ``nearest`` upsampling), every
candidate is compared.  ``nearest`` upsampling of the highpasses is not
compared: it makes 2 x 2 plateaus whose energies are equal only up to the
last bit of the phase re-wrap, and the maxima test ``maxima == X`` decides
them by that bit.  Tolerance: float64 1e-12 relative to each
column's largest value.
"""

import functools

import numpy as np
import pytest
import torch

import dtcwt_tpu as jdt
from dtcwt_tpu import keypoint as JK
from dtcwt_tpu_torch import keypoint as TK

TOL = 1e-12
METHODS = ["fauqueur", "bendale", "kingsbury"]
# per method, an energy between the weak and the strong maxima
THRESHOLDS = {"fauqueur": 1e-3, "bendale": 1e-2, "kingsbury": 5e-2}


@functools.lru_cache(maxsize=None)
def _highpasses():
    """The JAX highpasses of a textured 96 x 128 field, 4 levels, and the
    port's copies on the CPU."""
    rs = np.random.RandomState(21)
    spec = np.fft.rfft2(rs.rand(96, 128))
    fy = np.fft.fftfreq(96)[:, None]
    fx = np.fft.rfftfreq(128)[None, :]
    spec *= np.exp(-((fy ** 2 + fx ** 2) / (2 * 0.12 ** 2)))
    im = np.fft.irfft2(spec, s=(96, 128))
    hps = tuple(np.array(h) for h in
                jdt.Transform2d().forward(im, nlevels=4).highpasses)
    return hps, tuple(torch.from_numpy(h) for h in hps)


def _rows(kps):
    kps = kps.numpy() if isinstance(kps, torch.Tensor) else np.asarray(kps)
    return kps[np.lexsort((kps[:, 2], kps[:, 1], kps[:, 0], kps[:, 3]))]


def _same_rows(got, want):
    g, w = _rows(got), _rows(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    for c in range(4):
        scale = max(float(np.abs(w[:, c]).max(initial=0.0)), 1e-300)
        assert float(np.abs(g[:, c] - w[:, c]).max(initial=0.0)) / scale \
            < TOL, c


def _order_by_energy(kps):
    e = kps[:, 3]
    assert bool((e[1:] <= e[:-1]).all())


@pytest.mark.parametrize("threshold", [None, "value"])
@pytest.mark.parametrize("max_points", [None, 50])
@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("method", METHODS)
def test_find_keypoints_matches_jax(method, refine, max_points, threshold):
    jh, th = _highpasses()
    thr = None if threshold is None else THRESHOLDS[method]
    kw = dict(method=method, refine_positions=refine, max_points=max_points,
              threshold=thr)
    got = TK.find_keypoints(th, **kw)
    want = JK.find_keypoints(jh, **kw)
    assert got.dtype == torch.float64 and got.shape[1] == 4
    assert len(want) > 0
    if max_points is not None:
        assert len(want) <= max_points
    _same_rows(got, want)
    _order_by_energy(got)


def test_max_points_cuts_and_threshold_filters():
    jh, th = _highpasses()
    everything = TK.find_keypoints(th)
    assert len(everything) > 50
    assert len(TK.find_keypoints(th, max_points=50)) == 50
    thr = THRESHOLDS["fauqueur"]
    above = TK.find_keypoints(th, threshold=thr)
    assert 0 < len(above) < len(everything)
    assert bool((above[:, 3] >= thr).all())


@pytest.mark.parametrize("uhp,uke,max_points", [
    ("bilinear", None, 80), (None, "lanczos", 80),
    ("lanczos", "bilinear", None), (None, "nearest", None)])
def test_upsampling_options_match_jax(uhp, uke, max_points):
    jh, th = _highpasses()
    kw = dict(method="kingsbury", upsample_highpasses=uhp,
              upsample_keypoint_energy=uke, max_points=max_points)
    _same_rows(TK.find_keypoints(th, **kw), JK.find_keypoints(jh, **kw))


@pytest.mark.parametrize("skip_levels", [0, 1, 2])
def test_skip_levels_match_jax(skip_levels):
    jh, th = _highpasses()
    got = TK.find_keypoints(th, method="bendale", skip_levels=skip_levels)
    want = JK.find_keypoints(jh, method="bendale", skip_levels=skip_levels)
    _same_rows(got, want)
    scales = set(np.unique(got[:, 2].numpy()).tolist())
    assert scales <= {2.0 ** (s + 1) for s in range(skip_levels, 4)}


def test_empty_results_and_unknown_method():
    jh, th = _highpasses()
    got = TK.find_keypoints(th, skip_levels=4)
    assert got.shape == (0, 4) and got.device.type == "cpu"
    assert JK.find_keypoints(jh, skip_levels=4).shape == (0, 4)
    for mp in (None, 10):
        got = TK.find_keypoints(th, threshold=1e6, max_points=mp)
        want = JK.find_keypoints(jh, threshold=1e6, max_points=mp)
        assert got.shape == want.shape == (0, 4)
    with pytest.raises(ValueError, match="Unknown method: sift"):
        TK.find_keypoints(th, method="sift")


def test_numpy_highpasses(monkeypatch):
    jh, th = _highpasses()
    got = TK.find_keypoints(jh, device="cpu", max_points=20)
    _same_rows(got, TK.find_keypoints(th, max_points=20))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TK.find_keypoints(jh)
