"""The port's sharded 1-D transform (``dtcwt_tpu_torch.parallel``) on meshes
of CPU devices, against the JAX package's ``ShardedTransform1d`` on the
eight virtual devices of ``tests/conftest.py``.

Every leaf and the reconstruction agree at float64 within 1e-12, on the
meshes (2, 4), (1, 8) and (4, 2), with deep levels that gather, the
multiple-of-4 pad of a gathered level (328 samples: 82 at level 4), both
layouts and the gain mask.  The JAX class lane-folds long narrow signals
on the TPU; the port takes the wide-halo route at every sharded level,
which JAX's tests hold equal to the folded one.  bfloat16 planes agree
within one bfloat16 step (1e-2 of the largest value).  Each JAX program is
compiled once per module.
"""

import collections
import logging

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dtcwt_tpu.parallel import ShardedTransform1d as JaxSharded
from dtcwt_tpu.parallel import make_mesh as jax_mesh
import dtcwt_tpu_torch as dt
from dtcwt_tpu_torch.ops import dual
from dtcwt_tpu_torch.parallel import ShardedTransform1d, make_mesh

TOL64 = 1e-12
TOL_BF16 = 1e-2

_ROWS = ("data", "rows")
# name -> (mesh shape, signal, nlevels, constructor and forward keywords);
# the shapes are those of tests/test_sharded1d.py
_CONFIGS = {
    "2x4": ((2, 4), (4, 256, 3), 4, {}, {}),
    # levels 1-4 sharded, 5-6 gathered; the inverse re-shards
    "1x8-deep": ((1, 8), (2, 512, 2), 6,
                 {"biort": "near_sym_b", "qshift": "qshift_b"}, {}),
    "4x2": ((4, 2), (8, 256, 3), 4, {}, {}),
    # 328 / 4 = 82 local samples: level 1 sharded, levels 2-4 gathered,
    # level 4 pads its 82 samples to 84
    "2x4-pad": ((2, 4), (2, 328, 2), 4, {}, {}),
    "2x4-planes": ((2, 4), (2, 512, 4), 3, {}, {"layout": "planes"}),
}
_RUNS = {}


def _meshes(mshape):
    n = int(np.prod(mshape))
    return (jax_mesh(mshape, _ROWS, jax.devices()[:n]),
            make_mesh(mshape, _ROWS, ["cpu"] * n))


def _run(name, bf16=False):
    """(JAX forward, JAX inverse, port forward, port inverse, input) of one
    configuration, computed once per module."""
    key = (name, bf16)
    if key not in _RUNS:
        mshape, shape, nlevels, ckw, fkw = _CONFIGS[name]
        x = np.random.RandomState(5).rand(*shape)
        jm, tm = _meshes(mshape)
        js, ts = JaxSharded(jm, **ckw), ShardedTransform1d(tm, **ckw)
        if bf16:
            jx = jnp.asarray(x.astype(np.float32), jnp.bfloat16)
            tx = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        else:
            jx, tx = x, torch.from_numpy(x)
        jp = js.forward(jx, nlevels, **fkw)
        tp = ts.forward(tx, nlevels, **fkw)
        _RUNS[key] = (jp, js.inverse(jp), tp, ts.inverse(tp), x)
    return _RUNS[key]


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
        return [p.lowpass] + list(p.highpasses_re) + list(p.highpasses_im)
    return [p.lowpass] + list(p.highpasses)


def _err(got, want):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g - w).max())


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_forward_matches_jax_every_leaf(name):
    jp, _, tp, _, _ = _run(name)
    assert type(tp).__name__ == type(jp).__name__
    got, want = _leaves(tp), _leaves(jp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _err(g, w) < TOL64


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_inverse_matches_jax(name):
    _, jr, _, tr, x = _run(name)
    assert tr.dtype == torch.float64
    assert _err(tr, jr) < TOL64
    assert _err(tr, x) < 1e-11


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_matches_transform1d_on_the_cpu(name):
    mshape, shape, nlevels, ckw, fkw = _CONFIGS[name]
    _, _, tp, tr, x = _run(name)
    t = dt.Transform1d(device="cpu", **ckw)
    p = t.forward(torch.from_numpy(x), nlevels, **fkw)
    for g, w in zip(_leaves(tp), _leaves(p)):
        assert _err(g, w) == 0.0
    assert _err(tr, t.inverse(p)) == 0.0


@pytest.mark.parametrize("name", ["2x4", "2x4-planes", "1x8-deep"])
def test_inverse_gain_mask_matches_jax(name):
    mshape, _, nlevels, ckw, _ = _CONFIGS[name]
    jp, _, tp, _, _ = _run(name)
    gm = np.linspace(0.25, 1.5, nlevels)
    jm, tm = _meshes(mshape)
    want = JaxSharded(jm, **ckw).inverse(jp, gm)
    assert _err(ShardedTransform1d(tm, **ckw).inverse(tp, gm), want) < TOL64


def test_bf16_planes_match_jax_within_one_step():
    jp, jr, tp, tr, x = _run("2x4-planes", bf16=True)
    assert tp.lowpass.dtype == torch.bfloat16
    assert tp.highpasses_re[0].dtype == torch.bfloat16
    assert tr.dtype == torch.bfloat16
    for g, w in zip(_leaves(tp) + [tr], _leaves(jp) + [jr]):
        assert _err(g, w) <= TOL_BF16 * float(np.abs(_np(w)).max())
    assert float(np.abs(_np(tr) - x).max()) < 0.05


def test_plan_gathers_deep_levels():
    st = ShardedTransform1d(make_mesh((1, 8), _ROWS, ["cpu"] * 8))
    assert st._plan(512, 6) == [True] * 4 + [False] * 2
    # 41 samples a shard: odd, no level shards
    assert st._plan(328, 3) == [False] * 3
    st4 = ShardedTransform1d(make_mesh((2, 4), _ROWS, ["cpu"] * 8))
    assert st4._plan(328, 4) == [True] + [False] * 3
    # one shard on the rows axis shards nothing
    st1 = ShardedTransform1d(make_mesh((8, 1), _ROWS, ["cpu"] * 8))
    assert st1._plan(512, 3) == [False] * 3


def test_degraded_plan_warns_and_runs_replicated(caplog):
    """41 samples a shard (odd): the rows axis carries no level, a warning
    says so, and the result is the unsharded transform's."""
    st = ShardedTransform1d(make_mesh((1, 8), _ROWS, ["cpu"] * 8))
    x = torch.from_numpy(np.random.RandomState(11).rand(1, 328, 2))
    with caplog.at_level(
            logging.WARNING,
            logger="dtcwt_tpu_torch.parallel.transform1d_dist"):
        p = st.forward(x, 3)
    assert any("rows axis" in r.message and "unused" in r.message
               for r in caplog.records)
    want = dt.Transform1d(device="cpu").forward(x, 3)
    for g, w in zip(_leaves(p), _leaves(want)):
        assert _err(g, w) == 0.0
    assert _err(st.inverse(p), x) < 1e-11


def test_nlevels0_is_the_identity():
    st = ShardedTransform1d(make_mesh((2, 4), _ROWS, ["cpu"] * 8))
    x = np.random.RandomState(31).rand(2, 64, 2)
    p = st.forward(x, nlevels=0)
    assert p.highpasses == ()
    assert np.abs(p.lowpass.numpy() - x).max() == 0.0
    assert np.abs(st.inverse(p).numpy() - x).max() == 0.0


def test_bandpass_and_input_checks():
    m = make_mesh((2, 4), _ROWS, ["cpu"] * 8)
    with pytest.raises(ValueError, match="bandpass"):
        ShardedTransform1d(m, biort="near_sym_b_bp")
    with pytest.raises(ValueError, match="bandpass"):
        ShardedTransform1d(m, qshift="qshift_b_bp")
    with pytest.raises(ValueError, match="must define"):
        ShardedTransform1d(m, rows_axis="r")
    st = ShardedTransform1d(m)
    with pytest.raises(ValueError, match=r"\[B, N, C\]"):
        st.forward(np.zeros((64, 2)), 2)
    with pytest.raises(ValueError, match="multiple of 2"):
        st.forward(np.zeros((2, 65, 2)), 2)
    with pytest.raises(ValueError, match="data axis"):
        st.forward(np.zeros((3, 64, 2)), 2)


def test_routes_of_each_level(monkeypatch):
    """[1, 256, 2] on four shards, 4 levels, every level sharded: one
    from-extension call per shard and level each way."""
    st = ShardedTransform1d(make_mesh((1, 4), _ROWS, ["cpu"] * 4))
    x = torch.from_numpy(np.random.RandomState(9).rand(1, 256, 2))
    calls = collections.Counter()
    for name in dual.__all__:
        if name.endswith("_reference"):
            continue
        fn = getattr(dual, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(dual, name, spy)
    st.inverse(st.forward(x, 4))
    assert dict(calls) == {"filter2_fromext_axis": 4,
                           "dfilt2_fromext_axis": 12,
                           "ifilt2_sum_fromext_axis": 12,
                           "filter2_sum_fromext_axis": 4}
