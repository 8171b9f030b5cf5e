"""The port's row-split registration (``dtcwt_tpu_torch.parallel.
registration_dist``) on meshes of CPU devices, against the JAX package's
``estimatereg_sharded`` on the eight virtual devices of
``tests/conftest.py`` and the port's own ``estimatereg``, float64 within
1e-10 of the largest value (the bound of ``tests/test_registration.py``
through the 6x6 solves).  The pairs are ``smooth_pair`` of
``tests/test_torch_registration.py`` at sides the JAX package's Qtilde
grid takes.  JAX's jit of the estimator is compiled once per module."""

import functools
import logging

import numpy as np
import pytest
import jax
import torch

import dtcwt_tpu as jdt
from dtcwt_tpu.parallel import estimatereg_sharded as jax_estimatereg
from dtcwt_tpu.parallel import make_mesh as jax_mesh
import dtcwt_tpu_torch as dt
from dtcwt_tpu_torch import registration as TR
from dtcwt_tpu_torch.convert import pyramid_from_numpy
from dtcwt_tpu_torch.parallel import (
    estimatereg_sharded, make_mesh, shard_pyramid_rows)
from dtcwt_tpu_torch.parallel.registration_dist import _qtilde_rows
from dtcwt_tpu_torch.transforms.pyramid import PlanePyramid, Pyramid

from tests.test_torch_registration import smooth_pair

SOLVE_TOL = 1e-10
TOL = 1e-12


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = (want.numpy() if isinstance(want, torch.Tensor)
            else np.asarray(want))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _pyramids(h, w, nlevels=6):
    """(JAX pyramids, the port's copies on the CPU) of the smooth pair."""
    f1, f2 = smooth_pair(h, w)
    t = jdt.Transform2d()
    j1, j2 = t.forward(f1, nlevels=nlevels), t.forward(f2, nlevels=nlevels)
    return (j1, j2), (pyramid_from_numpy(j1, "cpu"),
                      pyramid_from_numpy(j2, "cpu"))


def _mesh(shape, names):
    return make_mesh(shape, names, ["cpu"] * int(np.prod(shape)))


def test_matches_jax_estimatereg_sharded():
    (j1, j2), (t1, t2) = _pyramids(128, 160)
    want = jax_estimatereg(j1, j2, jax_mesh((8,), ("rows",),
                                            jax.devices()[:8]))
    got = estimatereg_sharded(t1, t2, _mesh((8,), ("rows",)))
    assert got.device == torch.device("cpu") and got.dtype == torch.float64
    assert _rel(got, want) < SOLVE_TOL


@pytest.mark.parametrize("shape,names,side", [
    ((8,), ("rows",), (128, 160)),
    ((4,), ("rows",), (128, 160)),
    ((2, 4), ("data", "rows"), (128, 160)),
    # the subbands of levels 4-6 (12, 6 and 3 rows) do not divide the 8
    # shards: they run replicated while levels 1-3 split
    ((8,), ("rows",), (192, 160)),
])
def test_matches_estimatereg(shape, names, side):
    _, (t1, t2) = _pyramids(*side)
    want = TR.estimatereg(t1, t2)
    got = estimatereg_sharded(t1, t2, _mesh(shape, names))
    assert _rel(got, want) < SOLVE_TOL


def test_regshape_and_levels():
    _, (t1, t2) = _pyramids(128, 160)
    kw = {"regshape": (12, 16), "levels": [[3, 2], [2, 1]]}
    want = TR.estimatereg(t1, t2, **kw)
    got = estimatereg_sharded(t1, t2, _mesh((4,), ("rows",)), **kw)
    assert tuple(got.shape) == (12, 16, 6)
    assert _rel(got, want) < SOLVE_TOL


@pytest.mark.parametrize("level,shards", [(1, 4), (2, 8), (3, 8)])
def test_qtilde_of_the_shards_is_the_whole_levels(level, shards):
    """A shard's field from its rows and one neighbour row a side, joined:
    the whole level's ``qtildematrices`` (8 rows on 8 shards: blocks of
    one row between two neighbours)."""
    _, (t1, t2) = _pyramids(128, 160)
    a, b = t1.highpasses[level], t2.highpasses[level]
    want = TR.qtildematrices(t1, t2, [level])[0]
    split = lambda t: list(t.split(t.shape[0] // shards))
    got = torch.cat(_qtilde_rows(split(a), split(b), a.shape[0]))
    assert _rel(got, want) < TOL


def test_plane_pyramids_give_the_interleaved_result():
    f1, f2 = smooth_pair(128, 160)
    t = dt.Transform2d(device="cpu")
    on = lambda f: torch.from_numpy(f)
    p1, p2 = t.forward(on(f1), 6), t.forward(on(f2), 6)
    q1 = t.forward(on(f1), 6, layout="planes")
    q2 = t.forward(on(f2), 6, layout="planes")
    m = _mesh((8,), ("rows",))
    assert _rel(estimatereg_sharded(q1, q2, m),
                estimatereg_sharded(p1, p2, m)) < TOL


def test_shallow_pyramid_errors():
    _, (t1, _) = _pyramids(128, 160)
    shallow = Pyramid(t1.lowpass, t1.highpasses[:3])
    m = _mesh((8,), ("rows",))
    with pytest.raises(ValueError, match="nlevels >= 4"):
        estimatereg_sharded(shallow, shallow, m)
    with pytest.raises(ValueError, match="estimatereg_sharded"):
        estimatereg_sharded(shallow, shallow, m)
    avecs = estimatereg_sharded(shallow, shallow, m, regshape=(12, 16),
                                levels=[[2, 1]])
    assert tuple(avecs.shape) == (12, 16, 6)


def test_shard_pyramid_rows_places_and_warns(caplog):
    """Leaves whose rows divide the axis split, the others replicate; a
    replicated level of at least 4 R rows warns, a tiny one does not."""
    m = _mesh((2, 4), ("data", "rows"))
    _, (t1, _) = _pyramids(128, 160)
    parts = shard_pyramid_rows(t1, m)
    assert len(parts) == 4
    for level in range(6):
        hp = t1.highpasses[level]
        if hp.shape[0] % 4:
            assert all(torch.equal(p.highpasses[level], hp) for p in parts)
        else:
            assert torch.equal(torch.cat([p.highpasses[level]
                                          for p in parts]), hp)
    qp = shard_pyramid_rows(PlanePyramid.from_interleaved(t1), m)
    assert torch.equal(qp[1].highpasses[0], parts[1].highpasses[0])
    m8 = _mesh((8,), ("rows",))
    hp = (np.zeros((100, 64, 6), np.complex64),)
    with caplog.at_level(
            logging.WARNING,
            logger="dtcwt_tpu_torch.parallel.registration_dist"):
        shard_pyramid_rows(Pyramid(np.zeros((200, 128), np.float32), hp), m8)
    assert any("degraded sharding" in r.message for r in caplog.records)
    caplog.clear()
    small = (np.zeros((12, 16, 6), np.complex64),)
    with caplog.at_level(
            logging.WARNING,
            logger="dtcwt_tpu_torch.parallel.registration_dist"):
        shard_pyramid_rows(Pyramid(np.zeros((24, 32), np.float32), small),
                           m8)
    assert not any("degraded sharding" in r.message for r in caplog.records)
