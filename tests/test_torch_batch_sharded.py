"""The port's batch data-parallelism (``dtcwt_tpu_torch.parallel.batch``)
on a mesh of eight CPU devices, against the unsharded port and the JAX
package's ``BatchSharded`` on the eight virtual devices of
``tests/conftest.py``: the 1-D, 2-D and 3-D transforms, every leaf at
float64 within 1e-12, and ``shard_batch`` on tensors and pyramids."""

import numpy as np
import pytest
import jax
import torch

import dtcwt_tpu as jdt
from dtcwt_tpu.parallel import make_mesh as jax_mesh
from dtcwt_tpu.parallel.batch import BatchSharded as JaxBatch
import dtcwt_tpu_torch as dt
from dtcwt_tpu_torch.parallel import BatchSharded, make_mesh, shard_batch

TOL64 = 1e-12


def _mesh():
    return make_mesh((8,), ("data",), ["cpu"] * 8)


def _np(a):
    if isinstance(a, torch.Tensor):
        a = torch.view_as_real(a) if a.is_complex() else a
        return a.double().numpy()
    a = np.asarray(a)
    if np.iscomplexobj(a):
        a = np.stack([a.real, a.imag], axis=-1)
    return a.astype(np.float64)


def _leaves(p):
    if hasattr(p, "highpasses_re"):
        out = [p.lowpass] + list(p.highpasses_re) + list(p.highpasses_im)
    else:
        out = [p.lowpass] + list(p.highpasses)
    return out + list(p.scales or ())


def _err(got, want):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max())


# name -> (JAX transform, port transform, input, forward arguments)
_CASES = {
    "2d": (jdt.Transform2d, dt.Transform2d, (16, 64, 96),
           {"nlevels": 3, "include_scale": True}),
    "2d-planes": (jdt.Transform2d, dt.Transform2d, (8, 64, 64),
                  {"nlevels": 3, "layout": "planes"}),
    "1d": (jdt.Transform1d, dt.Transform1d, (8, 64, 2), {"nlevels": 3}),
    "3d": (jdt.Transform3d, dt.Transform3d, (8, 16, 16, 16), {"nlevels": 2}),
}


@pytest.mark.parametrize("name", list(_CASES))
def test_batch_sharded_matches_unsharded_and_jax(name):
    jt, tt, shape, kw = _CASES[name]
    x = np.random.RandomState(len(shape)).rand(*shape)
    bt = BatchSharded(tt(device="cpu"), _mesh())
    p = bt.forward(x, **kw)
    want = tt(device="cpu").forward(torch.from_numpy(x), **kw)
    for g, w in zip(_leaves(p), _leaves(want)):
        assert _err(g, w) == 0.0
    jb = JaxBatch(jt(), jax_mesh((8,), ("data",), jax.devices()[:8]))
    jp = jb.forward(x, **kw)
    got, ref = _leaves(p), _leaves(jp)
    assert len(got) == len(ref)
    for g, w in zip(got, ref):
        assert _err(g, w) < TOL64
    rec = bt.inverse(p)
    assert _err(rec, jb.inverse(jp)) < TOL64
    assert _err(rec, x) < 1e-11


def test_each_slice_runs_on_its_device(monkeypatch):
    """Every slice goes through a transform on its own device (copies of
    the wrapped one, cached per device); the results join on the first."""
    devices = []
    t = dt.Transform2d(device="cpu")
    bt = BatchSharded(t, _mesh())
    real = dt.Transform2d.forward

    def spy(self, X, *a, **k):
        devices.append((self.device, X.device, X.shape[0]))
        return real(self, X, *a, **k)
    monkeypatch.setattr(dt.Transform2d, "forward", spy)
    p = bt.forward(np.random.RandomState(0).rand(16, 32, 32), nlevels=2)
    assert devices == [(torch.device("cpu"), torch.device("cpu"), 2)] * 8
    assert p.lowpass.shape[0] == 16
    assert bt._on(torch.device("cpu")) is t


def test_inverse_takes_a_pyramid_of_numpy_leaves():
    t = dt.Transform2d(device="cpu")
    bt = BatchSharded(t, _mesh())
    p = t.forward(torch.from_numpy(np.random.RandomState(4).rand(8, 32, 32)),
                  2)
    q = dt.Pyramid(p.lowpass.numpy(), tuple(h.numpy() for h in p.highpasses))
    assert _err(bt.inverse(q), t.inverse(p)) == 0.0


def test_batch_divisibility_error():
    bt = BatchSharded(dt.Transform2d(device="cpu"), _mesh())
    with pytest.raises(ValueError, match="not divisible"):
        bt.forward(np.zeros((3, 32, 32)), nlevels=2)


def test_shard_batch_tensor_and_pyramid():
    m = make_mesh((2, 4), ("data", "rows"), ["cpu"] * 8)
    x = torch.from_numpy(np.random.RandomState(3).rand(8, 32, 32))
    parts = shard_batch(x, m)
    assert len(parts) == 2
    assert torch.equal(torch.cat(parts), x)
    p = dt.Transform2d(device="cpu").forward(x, nlevels=2)
    sp = shard_batch(p, _mesh())
    assert len(sp) == 8
    for i, q in enumerate(sp):
        assert type(q) is type(p)
        assert torch.equal(q.lowpass, p.lowpass[i:i + 1])
        assert torch.equal(q.highpasses[1], p.highpasses[1][i:i + 1])
    pp = dt.Transform2d(device="cpu").forward(x, 2, layout="planes")
    sp = shard_batch(pp, m, "rows")
    assert len(sp) == 4 and sp[0].kind == "2d"
    assert torch.equal(sp[3].highpasses_im[0], pp.highpasses_im[0][6:])
