"""The port's sharded 3-D transform (``dtcwt_tpu_torch.parallel``) on a
mesh of eight CPU devices, against the JAX package's ``ShardedTransform3d``
on the eight virtual devices of ``tests/conftest.py``.

Every leaf (lowpass, each level's subbands, each ``include_scale`` volume
and the reconstruction) agrees at float64 within 1e-12, on the meshes
(1, 8), (2, 4) and (2, 2, 2) with a rows axis, in both layouts, with
``ext_mode=8`` pads and crops, ``discard_level_1`` and ``include_scale``,
with plans that gather mid-pyramid and an inverse that re-shards; the
shapes are those of ``tests/test_sharded3d.py``.  bfloat16 planes agree
within one bfloat16 step (1e-2 of the largest value): not bit parity, as
the port's routes sum in another order.  Each JAX program is compiled once
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

from dtcwt_tpu.parallel import ShardedTransform3d as JaxSharded
from dtcwt_tpu.parallel import make_mesh as jax_mesh
import dtcwt_tpu_torch as dt
from dtcwt_tpu_torch.ops import dual, fb, hw, pack3d, single
from dtcwt_tpu_torch.parallel import (
    ShardedTransform3d, halo_exchange, make_mesh)

TOL64 = 1e-12
TOL_BF16 = 1e-2

_DEPTH = ("data", "depth")
_ROWS = ("data", "depth", "rows")
# name -> (mesh shape, axis names, volume, nlevels, constructor and forward
# keywords)
_CONFIGS = {
    # levels 1-2 depth-sharded, level 3 gathered; the inverse re-shards
    "1x8": ((1, 8), _DEPTH, (1, 128, 16, 16), 3, {}, {}),
    # two sharded levels, then two replicated ones, planes, include_scale
    "2x4-planes-scale": ((2, 4), _DEPTH, (2, 64, 16, 16), 4, {},
                         {"layout": "planes", "include_scale": True}),
    "2x4-ext8": ((2, 4), _DEPTH, (2, 64, 24, 24), 2, {"ext_mode": 8}, {}),
    "2x4-discard": ((2, 4), _DEPTH, (2, 64, 16, 16), 2, {},
                    {"discard_level_1": True}),
    "2x2x2-rows": ((2, 2, 2), _ROWS, (2, 32, 32, 16), 2,
                   {"rows_axis": "rows"}, {}),
    # the rows plan falls off mid-pyramid, depth shards only at level 1
    "2x2x2-rows-deep": ((2, 2, 2), _ROWS, (2, 16, 64, 16), 4,
                        {"rows_axis": "rows"}, {}),
    "2x2x2-rows-discard-scale": ((2, 2, 2), _ROWS, (2, 16, 64, 16), 3,
                                 {"rows_axis": "rows"},
                                 {"discard_level_1": True,
                                  "include_scale": True}),
    "2x2x2-rows-ext8": ((2, 2, 2), _ROWS, (2, 16, 40, 16), 2,
                        {"rows_axis": "rows", "ext_mode": 8}, {}),
}
_RUNS = {}


def _run(name, bf16=False):
    """(JAX forward, JAX inverse, port forward, port inverse, input) of one
    configuration, computed once per module; *bf16*: its volume as bfloat16
    planes, 2 levels."""
    key = (name, bf16)
    if key not in _RUNS:
        mshape, names, vol, nlevels, ckw, fkw = _CONFIGS[name]
        if bf16:
            nlevels, fkw = 2, {"layout": "planes"}
        n = int(np.prod(mshape))
        x = np.random.RandomState(5).rand(*vol)
        js = JaxSharded(jax_mesh(mshape, names, jax.devices()[:n]), **ckw)
        ts = ShardedTransform3d(make_mesh(mshape, names, ["cpu"] * n), **ckw)
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
    """Every leaf of a pyramid, a discarded level as None."""
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
        if w is None:
            assert g is None
        else:
            assert _err(g, w) < TOL64


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_inverse_matches_jax(name):
    _, jr, tp, tr, x = _run(name)
    assert tr.dtype == torch.float64
    assert _err(tr, jr) < TOL64
    if not _CONFIGS[name][5].get("discard_level_1"):
        assert _err(tr, x) < 1e-11


@pytest.mark.parametrize("name", ["2x4-planes-scale", "2x2x2-rows"])
def test_bf16_planes_match_jax_within_one_step(name):
    jp, jr, tp, tr, x = _run(name, bf16=True)
    assert tp.highpasses_re[0].dtype == torch.bfloat16
    assert tr.dtype == torch.bfloat16
    for g, w in zip(_leaves(tp) + [tr], _leaves(jp) + [jr]):
        assert _err(g, w) <= TOL_BF16 * float(np.abs(_np(w)).max())
    assert float(np.abs(_np(tr) - x).max()) < 0.1


def test_depth_degrade_warns_and_runs_replicated(caplog):
    """A depth axis no level can use logs a warning, in both directions,
    and the result is the single-device transform's."""
    st = ShardedTransform3d(make_mesh((2, 4), _DEPTH, ["cpu"] * 8))
    t = dt.Transform3d(device="cpu")
    x = torch.from_numpy(np.random.RandomState(6).rand(2, 6, 16, 16))
    with caplog.at_level(logging.WARNING,
                         logger="dtcwt_tpu_torch.parallel.transform3d_dist"):
        p = st.forward(x, nlevels=1)
        rec = st.inverse(p)
    assert any("depth axis" in r.message for r in caplog.records)
    assert any("cannot be sharded" in r.message for r in caplog.records)
    want = t.forward(x, nlevels=1)
    assert _err(p.lowpass, want.lowpass) < TOL64
    assert _err(p.highpasses[0], want.highpasses[0]) < TOL64
    assert _err(rec, t.inverse(want)) < TOL64


def test_nlevels0_is_the_identity():
    st = ShardedTransform3d(make_mesh((2, 4), _DEPTH, ["cpu"] * 8))
    v = np.random.RandomState(7).rand(2, 16, 16, 16)
    p = st.forward(v, nlevels=0)
    assert p.highpasses == ()
    assert np.abs(p.lowpass.numpy() - v).max() == 0.0
    assert np.abs(st.inverse(p).numpy() - v).max() == 0.0


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


_ENTRIES = ([(hw, n) for n in hw.__all__ if not n.endswith("_reference")]
            + [(dual, n) for n in dual.__all__
               if not n.endswith("_reference")]
            + [(pack3d, n) for n in ("fwd_level1_pack", "fwd_level2_pack",
                                     "inv_level1_pack", "inv_level2_pack")]
            + [(single, "filter_axis"), (single, "filter_fromext_axis")])


def test_routes_of_each_level(monkeypatch):
    """[1, 64, 16, 16] on four depth shards, 3 levels: levels 1-2 run the
    (H, W) pair on each shard and the depth stage from the halos, level 3
    gathers and runs the level kernel; the inverse runs level 3 replicated
    (depth merges, then ifilt_sum_hw22), re-shards, and merges levels 2-1
    from the halos."""
    st = ShardedTransform3d(make_mesh((1, 4), _DEPTH, ["cpu"] * 4))
    x = torch.from_numpy(np.random.RandomState(8).rand(1, 64, 16, 16))
    calls = _count(monkeypatch, _ENTRIES)
    p = st.forward(x, 3)
    assert dict(calls) == {"filter_hw22": 4, "filter2_fromext_axis": 16,
                           "dfilt_hw22": 4, "dfilt2_fromext_axis": 16,
                           "fwd_level2_pack": 1}
    calls.clear()
    st.inverse(p)
    assert dict(calls) == {"ifilt2_sum_axis": 4, "ifilt_sum_hw22": 5,
                           "ifilt2_sum_fromext_axis": 16,
                           "filter2_sum_fromext_axis": 16,
                           "filter_sum_hw22": 4}


def test_routes_rows_sharded_and_discard(monkeypatch):
    """On a rows axis each axis runs alone (W on the dual kernels, H and D
    from the halos); discard_level_1 runs the single-stream filter.  Four
    shards, both levels sharded on both axes; per shard: the level-1 W
    pass and its inverse, 2 + 2 H and D passes from the halos; at level 2
    one W split, then 2 H and 4 D splits; its inverse 4 H and 2 D merges
    from the halos and one W merge."""
    st = ShardedTransform3d(make_mesh((1, 2, 2), _ROWS, ["cpu"] * 4),
                            rows_axis="rows")
    x = torch.from_numpy(np.random.RandomState(9).rand(1, 32, 32, 16))
    calls = _count(monkeypatch, _ENTRIES)
    st.inverse(st.forward(x, 2, discard_level_1=True))
    assert dict(calls) == {
        "filter_axis": 4 * 2, "filter_fromext_axis": 4 * 4,
        "dfilt2_axis": 4, "dfilt2_fromext_axis": 4 * (2 + 4),
        "ifilt2_sum_fromext_axis": 4 * (4 + 2), "ifilt2_sum_axis": 4}


# --- the mesh and the halo exchange -----------------------------------------

def test_make_mesh():
    m = make_mesh((2, 4), _DEPTH, ["cpu"] * 8)
    assert m.shape == {"data": 2, "depth": 4} and m.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    with pytest.raises(ValueError, match="does not match"):
        make_mesh((2, 2), _DEPTH, ["cpu"] * 8)
    with pytest.raises(ValueError, match="axis names"):
        make_mesh((2, 2, 2), _DEPTH, ["cpu"] * 8)


def test_make_mesh_defaults_to_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((1, 1), _DEPTH)


@pytest.mark.parametrize("n,axis", [(3, -2), (8, -3), (5, 0)])
def test_halo_exchange_is_the_global_extension(n, axis):
    x = torch.from_numpy(np.random.RandomState(10).rand(32, 24, 3))
    shards = list(x.split(8, dim=axis))
    ext = fb.symmetric_extend(x, n, axis)
    for i, e in enumerate(halo_exchange(shards, n, axis)):
        assert torch.equal(e, ext.narrow(axis, 8 * i, 8 + 2 * n))
    assert halo_exchange(shards, 0, axis) == shards
    assert torch.equal(halo_exchange(shards[:1], n, axis)[0],
                       fb.symmetric_extend(shards[0], n, axis))
    with pytest.raises(ValueError, match="exceeds local extent"):
        halo_exchange(shards, 9, axis)


def test_constructor_checks():
    m = make_mesh((2, 4), _DEPTH, ["cpu"] * 8)
    with pytest.raises(ValueError, match="bandpass"):
        ShardedTransform3d(m, biort="near_sym_b_bp")
    with pytest.raises(ValueError, match="ext_mode"):
        ShardedTransform3d(m, ext_mode=6)
    with pytest.raises(ValueError, match="must define"):
        ShardedTransform3d(m, depth_axis="z")
    with pytest.raises(ValueError, match="rows axis"):
        ShardedTransform3d(m, rows_axis="rows")
