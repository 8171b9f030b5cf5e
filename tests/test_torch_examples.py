"""The port's examples on the CPU (``--device cpu``).

The GOP pipeline ``examples/register_video_torch.py`` runs as
``tests/test_multiprocess.py`` runs the JAX one: synthetic 9 x 64 x 64
frames, ``--gop-size 4``, ``--nlevels 4``, in one process and in two local
processes joined by ``torch.distributed`` (gloo).  The ranks take
disjoint GOPs, a re-run skips the finished parts, the merged two-process
output equals the single-process one exactly, each GOP equals the port's
``estimatereg_batched`` in-process, and the first GOP's ``register_gop``
equals the JAX example's (float64 frames, within the 6x6 solve's
tolerance of ``tests/test_torch_registration.py``).

``register_images_torch.py`` runs on two ``.npy`` frames, the resampling
and 3-D examples through their functions on small synthetic inputs, each
against the port's own functions.
"""

import glob
import importlib.util
import logging
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import dtcwt_tpu_torch as tdt
from dtcwt_tpu_torch import registration as TR
from dtcwt_tpu_torch import sampling as TS

REPO = os.path.realpath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLES = os.path.join(REPO, "examples")
SOLVE_TOL = 1e-10       # tests/test_torch_registration.py: through the solve


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small transforms: the suite's workers
    share the cores, and under that contention threads cost more than
    they give."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _frames(T=9, N=64):
    rng = np.random.RandomState(0)
    base = rng.rand(N, N).astype(np.float32)
    return np.stack([np.roll(base, t, axis=1) for t in range(T)])


def _env():
    # the ranks' intra-op threads as this process's (one), so that their
    # sums run in the same order as the in-process ones
    return dict(os.environ, PYTHONPATH=REPO,
                OMP_NUM_THREADS=str(torch.get_num_threads()))


def _main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__] + argv)
    mod.main()


def _rel(got, want):
    scale = max(float(np.abs(want).max()), 1e-300)
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale


def test_gop_pipeline_two_processes(tmp_path, monkeypatch, caplog):
    caplog.set_level(logging.INFO)
    video = str(tmp_path / "video.npz")
    frames = _frames()
    np.savez(video, frames=frames)
    rv = _example("register_video_torch")
    args = ["--gop-size", "4", "--nlevels", "4", "--device", "cpu"]

    # one process: this one
    out1 = str(tmp_path / "single.npz")
    _main(rv, [video, out1] + args, monkeypatch)
    _main(rv, [video, out1, "--merge"], monkeypatch)

    # two ranks on gloo
    out2 = str(tmp_path / "multi.npz")
    common = [sys.executable, os.path.join(EXAMPLES,
                                           "register_video_torch.py"),
              video, out2] + args + [
        "--coordinator", "localhost:%d" % _free_port(),
        "--num-processes", "2"]
    procs = [subprocess.Popen(common + ["--process-id", str(i)], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]

    # 3 GOPs (starts 0, 3, 6) round-robin: rank 0 -> 0 and 2, rank 1 -> 1
    parts = sorted(os.path.basename(p) for p in glob.glob(out2 + ".gop*"))
    assert parts == ["multi.npz.gop%04d.npz" % g for g in range(3)]
    logs = [err for _, err in outs]
    assert "registering GOP 0" in logs[0] and "registering GOP 2" in logs[0]
    assert "registering GOP 1" in logs[1]
    assert "registering GOP 1" not in logs[0]
    assert "GOP 0" not in logs[1] and "GOP 2" not in logs[1]
    assert all("device cpu" in err for err in logs)

    # resume: a re-run over the same parts registers nothing
    caplog.clear()
    _main(rv, [video, out2] + args, monkeypatch)
    assert caplog.text.count("skipping (resume)") == 3
    assert "registering" not in caplog.text
    _main(rv, [video, out2, "--merge"], monkeypatch)

    with np.load(out1) as f1, np.load(out2) as f2:
        for k in ("frame_idx_pairs", "affine_parameters"):
            np.testing.assert_array_equal(f1[k], f2[k])
        assert str(f2["videopath"]) == video
        pairs, avecs = f2["frame_idx_pairs"], f2["affine_parameters"]
    assert pairs.tolist() == [[i, i + 1] for i in range(8)]
    assert avecs.shape == (8, 4, 4, 6) and avecs.dtype == np.float32

    # each GOP against the port's estimatereg_batched in this process
    t = tdt.Transform2d(device="cpu")
    for gi, s in enumerate((0, 3, 6)):
        p = t.forward(frames[s:s + 4], nlevels=4)
        take = lambda sl: tdt.Pyramid(p.lowpass[sl],
                                      tuple(h[sl] for h in p.highpasses))
        want = TR.estimatereg_batched(take(slice(None, -1)),
                                      take(slice(1, None))).numpy()
        with np.load("%s.gop%04d.npz" % (out2, gi)) as f:
            np.testing.assert_array_equal(f["affine_parameters"], want)


def test_gop_against_the_jax_example():
    """The slice as a whole: the port's ``register_gop`` against the JAX
    example's on the first GOP, float64 frames."""
    frames = _frames()[:4].astype(np.float64)
    want = _example("register_video").register_gop(frames, 4)
    got = _example("register_video_torch").register_gop(frames, 4, "cpu")
    assert got.shape == want.shape == (3, 4, 4, 6)
    assert got.dtype == np.float64
    assert _rel(got, want) < SOLVE_TOL


def test_register_video_no_card_raises(tmp_path):
    """``--device cuda`` without a card raises; it never carries on on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rv = _example("register_video_torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rv.rank_device("cuda", 0)


def _smooth(h, w, seed=3):
    rs = np.random.RandomState(seed)
    spec = np.fft.rfft2(rs.rand(h, w))
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    spec *= np.exp(-((fy ** 2 + fx ** 2) / (2 * 0.04 ** 2)))
    f = np.fft.irfft2(spec, s=(h, w))
    return ((f - f.min()) / (f.max() - f.min())).astype(np.float32)


def test_register_images(tmp_path):
    f1 = _smooth(96, 128)
    f2 = np.roll(f1, (3, 2), axis=(0, 1))
    np.save(tmp_path / "a.npy", f1)
    np.save(tmp_path / "b.npy", f2)
    out = str(tmp_path / "reg.npz")
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "register_images_torch.py"),
         str(tmp_path / "a.npy"), str(tmp_path / "b.npy"), out,
         "--nlevels", "5", "--device", "cpu"], env=_env(),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    t = tdt.Transform2d(device="cpu")
    avecs = TR.estimatereg(t.forward(f1, nlevels=5), t.forward(f2, nlevels=5))
    vxs, vys = TR.velocityfield(avecs, avecs.shape[:2], method="bilinear")
    with np.load(out) as f:
        np.testing.assert_array_equal(f["avecs"], avecs.numpy())
        np.testing.assert_array_equal(f["vxs"], vxs.numpy())
        np.testing.assert_array_equal(f["vys"], vys.numpy())
    # the estimate undoes most of the shift: the warped source is nearer
    warped = TR.warp(torch.from_numpy(f1), avecs, method="bilinear")
    assert float((warped - torch.from_numpy(f2)).abs().mean()) < float(
        np.abs(f1 - f2).mean())


def test_resampling_example():
    img = _smooth(128, 96, seed=5)
    out = _example("resampling_highpass_coefficients_torch").resample(
        img, "cpu")
    t = tdt.Transform2d(device="cpu")
    small = t.forward(img[::2, ::2], nlevels=3).highpasses[2]
    big = t.forward(img, nlevels=3).highpasses[2]
    shape = tuple(big.shape[:2])
    np.testing.assert_array_equal(out["reference"], big.numpy())
    np.testing.assert_array_equal(
        out["naive"], TS.rescale(small, shape, "lanczos").numpy())
    np.testing.assert_array_equal(
        out["phase_aware"],
        TS.rescale_highpass(small, shape, "lanczos").numpy())
    assert out["naive"].shape == (16, 12, 6)


def test_3d_directionality_example():
    dirs, waves = _example("dtcwt_3d_directionality_torch").directions(
        16, 2, "cpu")
    assert dirs.shape == (28, 3) and waves.shape == (28, 16, 16, 16)
    np.testing.assert_allclose(np.linalg.norm(dirs, axis=1), 1.0, atol=1e-12)
    # every wavelet is the inverse of one unit coefficient
    t = tdt.Transform3d(device="cpu")
    pyr = t.forward(np.zeros((16,) * 3, np.float32), nlevels=2)
    for band in (0, 13, 27):
        hp = torch.zeros_like(pyr.highpasses[1])
        hp[2, 2, 2, band] = 1.0      # the centre of the 4^3 level
        want = t.inverse(tdt.Pyramid(pyr.lowpass, (pyr.highpasses[0], hp)))
        np.testing.assert_array_equal(waves[band], want.numpy())
    # 28 oriented wavelets: no two point the same way
    assert len({tuple(np.round(d, 6)) for d in dirs}) == 28
