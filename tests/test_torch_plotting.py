"""The port's ``overlay_quiver`` against ``dtcwt_tpu.plotting`` on the
inputs of ``tests/test_plotting.py``, headless on the Agg backend: every
quiver it draws has the same ``U``, ``V``, offsets and colours, from a
tensor or an array; the caller's coefficients are not mutated.  Importing
the module needs no matplotlib."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dtcwt_tpu as jdt
from dtcwt_tpu.plotting import overlay_quiver as jax_overlay_quiver
from dtcwt_tpu_torch.plotting import overlay_quiver

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs():
    rng = np.random.RandomState(0)
    img = rng.rand(64, 64) * 255.0
    pyr = jdt.Transform2d().forward(img.astype(np.float32) / 255.0, nlevels=3)
    hp = np.asarray(pyr.highpasses[2].real) + 1j * np.asarray(
        pyr.highpasses[2].imag)
    return img, hp


def _quivers(fn, img, hp):
    import matplotlib.pyplot as plt
    from matplotlib.quiver import Quiver
    fig = plt.figure()
    try:
        hq = fn(img, hp, level=3, offset=0.5)
        qs = [c for c in fig.axes[0].collections if isinstance(c, Quiver)]
        assert qs and qs[-1] is hq
        return [(np.array(q.U), np.array(q.V), np.array(q.get_offsets()),
                 np.array(q.get_facecolor())) for q in qs]
    finally:
        plt.close(fig)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["array", "tensor"])
def test_overlay_quiver_matches_jax(as_tensor):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    img, hp = _inputs()
    want = _quivers(jax_overlay_quiver, img, hp)
    keep = hp.copy()
    args = ((torch.from_numpy(img), torch.from_numpy(hp)) if as_tensor
            else (img, hp))
    got = _quivers(overlay_quiver, *args)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(hp, keep)


def test_import_needs_no_matplotlib():
    code = ("import sys\n"
            "sys.modules['matplotlib'] = None\n"
            "import dtcwt_tpu_torch.plotting as p\n"
            "assert p.__all__ == ('overlay_quiver',)\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
