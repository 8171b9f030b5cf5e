"""The port's sharded 2-D transform (``dtcwt_tpu_torch.parallel``) on meshes
of CPU devices, against the JAX package's ``ShardedTransform2d`` on the
eight virtual devices of ``tests/conftest.py``.

Every leaf (lowpass, each level's subbands, each ``include_scale`` image)
and the reconstruction agree at float64 within 1e-12, on the rows meshes
(2, 4) and (1, 8) and the cols meshes (2, 2, 2) and (1, 4, 2), in both
layouts, with the bandpass families, a plan that gathers mid-pyramid (6
levels on 256 rows over 4 shards), a width crop (W = 102) and inverses
that re-shard; the gain mask in both layouts.  bfloat16 planes agree
within one bfloat16 step (1e-2 of the largest value): the port's per-axis
passes sum in another order than JAX's.  Each JAX program is compiled once
per module.  The routes (which kernel entry each level calls) are counted
on the CPU; on the card ``test_torch_cuda.py`` and ``chip_smoke.py`` count
the launches.
"""

import collections
import logging

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dtcwt_tpu.parallel import ShardedTransform2d as JaxSharded
from dtcwt_tpu.parallel import make_mesh as jax_mesh
import dtcwt_tpu_torch as dt
from dtcwt_tpu_torch.ops import dual, single
from dtcwt_tpu_torch.parallel import ShardedTransform2d, make_mesh

TOL64 = 1e-12
TOL_BF16 = 1e-2

_ROWS = ("data", "rows")
_COLS = ("data", "rows", "cols")
_BP = {"biort": "near_sym_b_bp", "qshift": "qshift_b_bp"}
# name -> (mesh shape, axis names, image, nlevels, constructor and forward
# keywords); the shapes are those of tests/test_sharded2d.py
_CONFIGS = {
    "2x4": ((2, 4), _ROWS, (4, 256, 128), 3, {}, {}),
    "1x8": ((1, 8), _ROWS, (2, 64, 64), 3, {}, {}),
    "2x4-planes-scale": ((2, 4), _ROWS, (2, 256, 128), 3, {},
                         {"layout": "planes", "include_scale": True}),
    # levels 1-4 sharded, 5-6 gathered; the inverse re-shards
    "2x4-gather-scale": ((2, 4), _ROWS, (2, 256, 256), 6, {},
                         {"include_scale": True}),
    # W = 102 pads before level 3, so the inverse crops the cols
    "2x4-crop": ((2, 4), _ROWS, (2, 256, 102), 3, {}, {}),
    "2x2x2-cols": ((2, 2, 2), _COLS, (2, 256, 256), 3,
                   {"cols_axis": "cols"}, {}),
    # both axes gather mid-pyramid, independently; both re-shard in the
    # inverse
    "1x4x2-cols-bp-deep": ((1, 4, 2), _COLS, (1, 256, 128), 5,
                           dict(_BP, cols_axis="cols"), {}),
}
_RUNS = {}


def _meshes(mshape, names):
    n = int(np.prod(mshape))
    return (jax_mesh(mshape, names, jax.devices()[:n]),
            make_mesh(mshape, names, ["cpu"] * n))


def _run(name, bf16=False):
    """(JAX forward, JAX inverse, port forward, port inverse, input) of one
    configuration, computed once per module; *bf16*: its image as bfloat16
    planes."""
    key = (name, bf16)
    if key not in _RUNS:
        mshape, names, shape, nlevels, ckw, fkw = _CONFIGS[name]
        if bf16:
            fkw = {"layout": "planes"}
        x = np.random.RandomState(5).rand(*shape)
        jm, tm = _meshes(mshape, names)
        js, ts = JaxSharded(jm, **ckw), ShardedTransform2d(tm, **ckw)
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
        return a.detach().double().numpy()
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
    _, jr, tp, tr, x = _run(name)
    assert tr.dtype == torch.float64 and tr.device == torch.device("cpu")
    assert _err(tr, jr) < TOL64
    if "biort" not in _CONFIGS[name][4]:
        # the bandpass families do not reconstruct perfectly
        assert _err(tr, x) < 1e-11


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_matches_transform2d_on_the_cpu(name):
    """The sharded plain path is the unsharded one's to the bit: the same
    plain filters on the same samples, halos in place of reflections; with
    a gain mask too."""
    mshape, names, shape, nlevels, ckw, fkw = _CONFIGS[name]
    _, _, tp, tr, x = _run(name)
    t = dt.Transform2d(ckw.get("biort", "near_sym_a"),
                       ckw.get("qshift", "qshift_a"), device="cpu")
    p = t.forward(torch.from_numpy(x), nlevels, **fkw)
    for g, w in zip(_leaves(tp), _leaves(p)):
        assert _err(g, w) == 0.0
    assert _err(tr, t.inverse(p)) == 0.0
    gm = np.linspace(0.0, 1.5, 6 * nlevels).reshape(6, nlevels)
    st = ShardedTransform2d(make_mesh(mshape, names,
                                      ["cpu"] * int(np.prod(mshape))), **ckw)
    assert _err(st.inverse(tp, gm), t.inverse(p, gm)) == 0.0


@pytest.mark.parametrize("name", ["2x4", "2x4-planes-scale"])
def test_inverse_gain_mask_matches_jax(name):
    """Gains scale each subband before any filtering; planes permute the
    gain rows to the plane order."""
    mshape, names, _, nlevels, ckw, _ = _CONFIGS[name]
    jp, _, tp, _, _ = _run(name)
    gm = np.linspace(0.0, 1.5, 6 * nlevels).reshape(6, nlevels)
    jm, tm = _meshes(mshape, names)
    want = JaxSharded(jm, **ckw).inverse(jp, gm)
    assert _err(ShardedTransform2d(tm, **ckw).inverse(tp, gm), want) < TOL64


def test_planes_match_the_interleaved_layout():
    _, _, tp, tr, _ = _run("2x4-planes-scale")
    mshape, names, shape, nlevels, _, _ = _CONFIGS["2x4-planes-scale"]
    st = ShardedTransform2d(make_mesh(mshape, names, ["cpu"] * 8))
    x = torch.from_numpy(np.random.RandomState(5).rand(*shape))
    pi = st.forward(x, nlevels)
    for a, b in zip(pi.highpasses, tp.interleaved().highpasses):
        assert _err(a, b) == 0.0
    assert _err(st.inverse(pi), tr) < TOL64


def test_bf16_planes_match_jax_within_one_step():
    jp, jr, tp, tr, x = _run("2x2x2-cols", bf16=True)
    assert tp.lowpass.dtype == torch.bfloat16
    assert tp.highpasses_re[0].dtype == torch.bfloat16
    assert tr.dtype == torch.bfloat16
    for g, w in zip(_leaves(tp) + [tr], _leaves(jp) + [jr]):
        assert _err(g, w) <= TOL_BF16 * float(np.abs(_np(w)).max())
    assert float(np.abs(_np(tr) - x).max()) < 0.05


def test_degraded_plan_warns_and_runs_replicated(caplog):
    """A rows axis no level can use logs a warning, in both directions, and
    the result is the single-device transform's."""
    st = ShardedTransform2d(make_mesh((1, 8), _ROWS, ["cpu"] * 8))
    t = dt.Transform2d(device="cpu")
    x = torch.from_numpy(np.random.RandomState(6).randn(1, 100, 64))
    with caplog.at_level(
            logging.WARNING,
            logger="dtcwt_tpu_torch.parallel.transform2d_dist"):
        p = st.forward(x, nlevels=2)
        rec = st.inverse(p)
    assert any("rows axis" in r.message and "unused" in r.message
               for r in caplog.records)
    assert any("cannot be sharded" in r.message for r in caplog.records)
    want = t.forward(x, nlevels=2)
    for g, w in zip(_leaves(p), _leaves(want)):
        assert _err(g, w) < TOL64
    assert _err(rec, x) < 1e-11


def test_nlevels0_is_the_identity():
    st = ShardedTransform2d(make_mesh((2, 4), _ROWS, ["cpu"] * 8))
    x = np.random.RandomState(7).rand(2, 64, 64)
    p = st.forward(x, nlevels=0)
    assert p.highpasses == ()
    assert np.abs(p.lowpass.numpy() - x).max() == 0.0
    assert np.abs(st.inverse(p).numpy() - x).max() == 0.0
    pp = st.forward(x, nlevels=0, layout="planes")
    assert pp.highpasses_re == () and pp.highpasses_im == ()


def test_constructor_and_input_checks():
    m = make_mesh((2, 4), _ROWS, ["cpu"] * 8)
    with pytest.raises(ValueError, match="must define"):
        ShardedTransform2d(m, rows_axis="r")
    with pytest.raises(ValueError, match="cols axis"):
        ShardedTransform2d(m, cols_axis="cols")
    st = ShardedTransform2d(m)
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        st.forward(np.zeros((64, 64)), 2)
    with pytest.raises(ValueError, match="layout"):
        st.forward(np.zeros((2, 64, 64)), 2, layout="nchw")
    with pytest.raises(ValueError, match="data axis"):
        st.forward(np.zeros((3, 64, 64)), 2)


def test_autograd_on_a_cpu_mesh():
    """On a CPU mesh autograd runs through the plain versions: the gradient
    of a loss over every leaf is finite, non-zero and the unsharded
    transform's."""
    st = ShardedTransform2d(make_mesh((2, 4), _ROWS, ["cpu"] * 8))
    t = dt.Transform2d(device="cpu")
    x = np.random.RandomState(8).randn(2, 128, 64)

    def grad(fwd):
        xg = torch.from_numpy(x).requires_grad_(True)
        p = fwd(xg)
        loss = (sum((h.abs() ** 2).sum() for h in p.highpasses)
                + (p.lowpass ** 2).sum())
        (g,) = torch.autograd.grad(loss, xg)
        return g.numpy()

    g = grad(lambda v: st.forward(v, 2))
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    assert np.abs(g - grad(lambda v: t.forward(v, 2))).max() < TOL64


def _count(monkeypatch, entries):
    """Count the calls of each (module, name) entry."""
    calls = collections.Counter()
    for mod, name in entries:
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return calls


_ENTRIES = ([(dual, n) for n in dual.__all__ if not n.endswith("_reference")]
            + [(single, n + s) for n in ("filter", "dfilt", "ifilt")
               for s in ("_axis", "_fromext_axis")])


def test_routes_of_each_level(monkeypatch):
    """[1, 128, 64] on four rows shards, 3 levels, every level sharded:
    per shard a level's column pass reads the halos and its two row passes
    reflect; the inverse merges the columns from the halos (two a level)
    and the rows by reflection."""
    st = ShardedTransform2d(make_mesh((1, 4), _ROWS, ["cpu"] * 4))
    x = torch.from_numpy(np.random.RandomState(9).rand(1, 128, 64))
    calls = _count(monkeypatch, _ENTRIES)
    p = st.forward(x, 3)
    assert dict(calls) == {"filter2_fromext_axis": 4, "filter2_axis": 8,
                           "dfilt2_fromext_axis": 8, "dfilt2_axis": 16}
    calls.clear()
    st.inverse(p)
    assert dict(calls) == {"ifilt2_sum_fromext_axis": 16,
                           "ifilt2_sum_axis": 8,
                           "filter2_sum_fromext_axis": 8,
                           "filter2_sum_axis": 4}


def test_routes_bandpass_and_cols(monkeypatch):
    """The bandpass families on a (1, 2, 2) cols mesh, 2 levels: every pass
    reads the halos; per shard and level the two-branch passes and the
    single-stream third stream and q05 pass (filter / dfilt forward,
    filter / ifilt inverse)."""
    st = ShardedTransform2d(make_mesh((1, 2, 2), _COLS, ["cpu"] * 4),
                            cols_axis="cols", **_BP)
    x = torch.from_numpy(np.random.RandomState(10).rand(1, 128, 128))
    calls = _count(monkeypatch, _ENTRIES)
    st.inverse(st.forward(x, 2))
    assert dict(calls) == {
        "filter2_fromext_axis": 4 * 2, "filter_fromext_axis": 4 * 3 * 2,
        "dfilt2_fromext_axis": 4 * 2, "dfilt_fromext_axis": 4 * 3,
        "ifilt2_sum_fromext_axis": 4 * 2, "ifilt_fromext_axis": 4 * 3,
        "filter2_sum_fromext_axis": 4 * 2}
