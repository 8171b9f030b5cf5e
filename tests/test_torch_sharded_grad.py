"""Gradients of the port's sharded transforms (``dtcwt_tpu_torch.parallel``)
through the card's route, on meshes of CPU devices, float64, against
``jax.vjp`` of the JAX package's sharded classes on the eight virtual
devices of ``tests/conftest.py``, at 1e-12 relative to each leaf's largest
value.

On the card every filter pass of a sharded transform whose operand
requires grad runs as one ``linear_vjp`` Function over its shard grid
(``parallel/_grid.py``).  The tests reach that route here through
``linearize.needs_vjp`` patched to hold for CPU tensors, so the Functions
run their explicit adjoints (the opposite sharded pass) on the plain
versions, or the plain pass's vjp where the configuration chooses it.
PyTorch's gradient of a complex leaf is the conjugate of JAX's cotangent:
JAX gets the conjugates of the port's output gradients, and the port's
complex input gradients are held against the conjugates of JAX's.  Inputs
are made with numpy from a seed; each JAX program is compiled once per
module.  Besides: the dot-product identity of each pass Function alone
on 2, 3 and 4 shards (an end shard at the fold's minimum extent), the
route each pass takes, ``BatchSharded`` against the whole batch and a
Function node that keeps no tensor alive.
"""

import collections
import contextlib
import gc
import weakref

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import dtcwt_tpu as jdt
from dtcwt_tpu.parallel import ShardedTransform1d as Jax1d
from dtcwt_tpu.parallel import ShardedTransform2d as Jax2d
from dtcwt_tpu.parallel import ShardedTransform3d as Jax3d
from dtcwt_tpu.parallel import make_mesh as jax_mesh
import dtcwt_tpu_torch as tdt
from dtcwt_tpu_torch.coeffs import biort, qshift
from dtcwt_tpu_torch.ops import dual, hw, linearize
from dtcwt_tpu_torch.parallel import (
    BatchSharded, ShardedTransform1d, ShardedTransform2d, ShardedTransform3d,
    make_mesh)
from dtcwt_tpu_torch.parallel._grid import GridShards

TOL = 1e-12

_ROWS = ("data", "rows")
_COLS = ("data", "rows", "cols")
_DEPTH = ("data", "depth")
_DROWS = ("data", "depth", "rows")
_BP = {"biort": "near_sym_b_bp", "qshift": "qshift_b_bp"}
_CLASSES = {"2d": (ShardedTransform2d, Jax2d), "1d": (ShardedTransform1d,
                                                       Jax1d),
            "3d": (ShardedTransform3d, Jax3d)}
# name -> (class, mesh shape, axis names, input, nlevels, constructor and
# forward keywords)
_CONFIGS = {
    "2d-2x4-rows": ("2d", (2, 4), _ROWS, (2, 128, 64), 3, {}, {}),
    "2d-2x2x2-cols-planes": ("2d", (2, 2, 2), _COLS, (2, 128, 128), 3,
                             {"cols_axis": "cols"}, {"layout": "planes"}),
    # levels 1-3 sharded, level 4 gathered; the inverse re-shards
    "2d-1x4-gather": ("2d", (1, 4), _ROWS, (1, 128, 32), 4, {}, {}),
    # the plain route: every pass of the bandpass families
    "2d-1x4-bandpass": ("2d", (1, 4), _ROWS, (1, 128, 64), 2, _BP, {}),
    "1d-2x4": ("1d", (2, 4), _ROWS, (2, 256, 3), 4, {}, {}),
    "1d-2x4-planes": ("1d", (2, 4), _ROWS, (2, 256, 3), 3, {},
                      {"layout": "planes"}),
    # both levels depth-sharded: the hw kernels and the depth passes
    "3d-2x4-depth": ("3d", (2, 4), _DEPTH, (2, 64, 16, 16), 2, {}, {}),
    # level 1 sharded over depth and rows, level 2 replicated
    "3d-2x2x2-rows-planes": ("3d", (2, 2, 2), _DROWS, (2, 16, 16, 16), 2,
                             {"rows_axis": "rows"}, {"layout": "planes"}),
}
_GRADS = {}


@contextlib.contextmanager
def _vjp_route():
    """The sharded passes take the card's route on CPU tensors: each runs
    as one ``linear_vjp`` Function."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(linearize, "needs_vjp", lambda _: True)
        yield


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape)


def _like(leaves, seed):
    """Random arrays in the shapes of *leaves*, complex where a leaf is."""
    out = []
    for i, a in enumerate(leaves):
        v = _rand(tuple(a.shape), seed + i)
        if a.is_complex():
            v = v + 1j * _rand(tuple(a.shape), seed + 50 + i)
        out.append(v)
    return out


def _jax_vjp(f, primal, cots):
    """The leaves of ``jax.vjp`` of *f* at *primal* on the port's output
    gradients *cots*, given to JAX conjugated, as one compiled program."""
    out = jax.eval_shape(f, primal)
    ct = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(out),
                                      [jnp.asarray(np.conj(c)) for c in cots])
    grads = jax.jit(lambda p, c: jax.vjp(f, p)[1](c)[0])(primal, ct)
    return [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


def _pyramids(leaves, spec, vals):
    """The port pyramid of *spec* holding *vals* (its leaves require grad)
    and the same pyramid for JAX."""
    ts = [torch.from_numpy(v).requires_grad_() for v in vals]
    js = [jnp.asarray(v) for v in vals]
    p = linearize._fill(spec, ts)
    if isinstance(p, tdt.PlanePyramid):
        n = len(p.highpasses_re)
        jp = jdt.PlanePyramid(js[0], tuple(js[1:n + 1]),
                              tuple(js[n + 1:2 * n + 1]), None, kind=p.kind)
    else:
        jp = jdt.Pyramid(js[0], tuple(js[1:]))
    return p, ts, jp


def _grads(name):
    """(port forward gradient, JAX's; port inverse gradients, JAX's) of
    one configuration, computed once per module."""
    if name not in _GRADS:
        kind, mshape, names, shape, nl, ckw, fkw = _CONFIGS[name]
        tcls, jcls = _CLASSES[kind]
        n = int(np.prod(mshape))
        ts = tcls(make_mesh(mshape, names, ["cpu"] * n), **ckw)
        js = jcls(jax_mesh(mshape, names, jax.devices()[:n]), **ckw)
        x = _rand(shape, 7)
        xt = torch.from_numpy(x).requires_grad_()
        with _vjp_route():
            p = ts.forward(xt, nl, **fkw)
        leaves, spec = linearize._tree(p)
        cots = _like(leaves, 11)
        (gx,) = torch.autograd.grad(leaves, xt, [torch.from_numpy(c)
                                                 for c in cots])
        jx = _jax_vjp(lambda v: js.forward(v, nl, **fkw), jnp.asarray(x),
                      cots)
        pt, pl, jp = _pyramids(leaves, spec, _like(leaves, 23))
        with _vjp_route():
            z = ts.inverse(pt)
        v = _rand(tuple(z.shape), 31)
        gp = torch.autograd.grad(z, pl, torch.from_numpy(v))
        jpg = _jax_vjp(js.inverse, jp, [v])
        _GRADS[name] = ([gx], jx, list(gp), jpg)
    return _GRADS[name]


def _check(got, want):
    """Port gradients against JAX's, complex leaves conjugated, each
    within TOL of the leaf's largest value."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy()
        w = np.conj(w) if np.iscomplexobj(w) else w
        assert g.shape == w.shape, (g.shape, w.shape)
        assert np.abs(g - w).max() <= TOL * np.abs(w).max()


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_forward_grad_matches_jax(name):
    gx, jx, _, _ = _grads(name)
    _check(gx, jx)


@pytest.mark.parametrize("name", list(_CONFIGS))
def test_inverse_grads_match_jax(name):
    _, _, gp, jp = _grads(name)
    _check(gp, jp)


# --- each pass Function alone -----------------------------------------------

def _grid(shape, R, seed):
    """A random (R, 1) grid of float64 shards of *shape*, requiring grad."""
    return [[torch.from_numpy(_rand(shape, seed + r)).requires_grad_()]
            for r in range(R)]


def _dot(a, b):
    la, lb = linearize._tree(a)[0], linearize._tree(b)[0]
    return sum(float((x.detach() * y.detach()).sum())
               for x, y in zip(la, lb))


def _norm(a):
    return float(sum((x * x).sum() for x in linearize._tree(a)[0])) ** 0.5


def _adjoint_identity(call, operand):
    """``<A x, y> - <x, A^T y>`` over the Cauchy-Schwarz bound ``|A x|
    |y|`` of the pass *call* through the card's route at the grid
    *operand*, and the route's adjoint (None: the plain route)."""
    seen = []
    real = linearize.linear_vjp

    def spy(impl, adjoint, plain):
        seen.append(adjoint)
        return real(impl, adjoint, plain)
    with _vjp_route(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(linearize, "linear_vjp", spy)
        out = call(operand)
    leaves = linearize._tree(out)[0]
    ys = [torch.from_numpy(_rand(tuple(t.shape), 90 + i))
          for i, t in enumerate(leaves)]
    xs = linearize._tree(operand)[0]
    back = torch.autograd.grad(leaves, xs, ys)
    y = linearize._fill(linearize._tree(out)[1], ys)
    lhs, rhs = _dot(out, y), _dot(operand, linearize._fill(
        linearize._tree(operand)[1], back))
    assert len(seen) == 1
    return abs(lhs - rhs) / (_norm(out) * _norm(y)), seen[0]


_NB, _QB = biort("near_sym_b"), qshift("qshift_b")
_P1 = max(_NB[0].size, _NB[2].size) // 2        # the fold's width, 9


def _pass_cases():
    """(label, R, call builder, shard shape) of each pass on R shards of
    axis -2 of a (1, R) rows mesh (near_sym_b / qshift_b): every shard at
    the least extent its adjoint takes."""
    ana, syn = ((_QB[1], _QB[0]), (_QB[5], _QB[4])), ((_QB[3], _QB[2]),
                                                      (_QB[7], _QB[6]))
    cases = []
    for R in (2, 3, 4):
        cases += [
            # the level-1 passes at the fold's minimum extent, the halo
            # the filters' own reach
            ("filter2 sharded", R, lambda st: lambda g: st._pass(
                g, -2, True, _P1, "filter2", dual, _NB[0], _NB[2]),
             (2, _P1, 5)),
            ("filter2_sum sharded", R, lambda st: lambda g: st._merge(
                *(_half(g)), -2, True, _P1, "filter2_sum", _NB[1], _NB[3]),
             (2, _P1, 5)),
            # the qshift passes at the forward's halo 16: an adjoint's
            # local extent 8, the inverse's halo
            ("dfilt2 sharded", R, lambda st: lambda g: st._pass(
                g, -2, True, 16, "dfilt2", dual, *ana), (2, 16, 5)),
            ("ifilt2_sum sharded", R, lambda st: lambda g: st._merge(
                *(_half(g)), -2, True, 8, "ifilt2_sum", *syn), (2, 8, 5))]
    # the unsharded axis: its own reflection, the fold at both ends
    cases += [
        ("filter2 local", 2, lambda st: lambda g: st._pass(
            g, -1, False, 0, "filter2", dual, _NB[0], _NB[2]), (2, 4, _P1)),
        ("filter2_sum local", 2, lambda st: lambda g: st._merge(
            *(_half(g)), -1, False, 0, "filter2_sum", _NB[1], _NB[3]),
         (2, 4, _P1))]
    return cases


def _half(g):
    """A grid of shard pairs as two grids: the first and second half of
    each shard's leading axis."""
    return ([[t[:1]] for (t,) in g], [[t[1:]] for (t,) in g])


@pytest.mark.parametrize("case", range(len(_pass_cases())))
def test_pass_function_is_its_adjoints_transpose(case):
    """``<A x, y> = <x, A^T y>`` to 1e-12 of each sharded pass and merge
    Function alone, its backward the explicit adjoint (the opposite
    sharded pass; the zero-end exchange and the fold at the whole axis's
    ends at level 1)."""
    label, R, build, shape = _pass_cases()[case]
    st = ShardedTransform2d(make_mesh((1, R), _ROWS, ["cpu"] * R),
                            "near_sym_b", "qshift_b")
    err, adj = _adjoint_identity(build(st), _grid(shape, R, 3 * case))
    assert adj is not None, label
    assert err <= TOL, (label, R, err)


@pytest.mark.parametrize("level1", [True, False])
@pytest.mark.parametrize("merge", [False, True])
def test_hw_stage_function_is_its_adjoints_transpose(level1, merge):
    """The 3-D (H, W) stage pair of each shard as one Function: its
    explicit adjoint (the per-axis level-1 adjoints, or the opposite hw
    kernel) is its transpose to 1e-12."""
    st = ShardedTransform3d(make_mesh((1, 2), _DEPTH, ["cpu"] * 2),
                            "near_sym_b", "qshift_b")
    shape = (1, 4, 12, 20) if level1 else (1, 4, 16, 24)
    if merge:
        grids = [_grid(shape, 2, 10 * i) for i in range(4)]
        op = [[tuple(g[r][0] for g in grids)] for r in range(2)]
        call = lambda o: st._hw_merge([[[t[i]] for (t,) in o]
                                       for i in range(4)], level1)
    else:
        op = _grid(shape, 2, 5)
        call = lambda o: st._hw_split(o, level1)
    err, adj = _adjoint_identity(call, op)
    assert adj is not None
    assert err <= TOL, err


# --- which route each pass takes ---------------------------------------------

def _routes(monkeypatch, run):
    """Count the (pass name, explicit) of every pass and merge that *run*
    makes through the card's route."""
    counts = collections.Counter()
    real = GridShards._adjoint_of

    def spy(self, name, *a):
        adj = real(self, name, *a)
        counts[(name, adj is not None)] += 1
        return adj
    monkeypatch.setattr(GridShards, "_adjoint_of", spy)
    with _vjp_route():
        run()
    return dict(counts)


def test_routes_of_the_passes(monkeypatch):
    """Every dual pass of a default-family 2-D round trip takes the
    explicit adjoint, as does a bfloat16 planes one (its passes run at
    float32); the bandpass families' passes all take the plain route; a
    1-D qshift_d level whose decimated shard is shorter than the
    inverse's halo takes the plain route alone."""
    mesh = make_mesh((1, 4), _ROWS, ["cpu"] * 4)
    x = torch.from_numpy(_rand((1, 64, 64), 40)).requires_grad_()
    st = ShardedTransform2d(mesh)
    got = _routes(monkeypatch, lambda: st.inverse(st.forward(x, 2)))
    assert got == {("filter2", True): 3, ("dfilt2", True): 3,
                   ("ifilt2_sum", True): 3, ("filter2_sum", True): 3}
    xb = x.detach().float().to(torch.bfloat16).requires_grad_()
    got = _routes(monkeypatch, lambda: st.inverse(st.forward(
        xb, 2, layout="planes")))
    assert got == {("filter2", True): 3, ("dfilt2", True): 3,
                   ("ifilt2_sum", True): 3, ("filter2_sum", True): 3}
    sb = ShardedTransform2d(mesh, **_BP)
    got = _routes(monkeypatch, lambda: sb.inverse(sb.forward(x, 2)))
    assert got == {("filter2", False): 2, ("filter", False): 6,
                   ("dfilt2", False): 2, ("dfilt", False): 3,
                   ("ifilt2_sum", False): 2, ("ifilt", False): 3,
                   ("filter2_sum", False): 2}
    # 96 samples on four shards: level 2's 24 a shard decimate to 12,
    # under the inverse's halo 16 for 18 taps; level 3 gathers
    s1 = ShardedTransform1d(mesh, "near_sym_a", "qshift_d")
    x1 = torch.from_numpy(_rand((1, 96, 2), 41)).requires_grad_()
    got = _routes(monkeypatch, lambda: s1.forward(x1, 3))
    assert got == {("filter2", True): 1, ("dfilt2", False): 1,
                   ("dfilt2", True): 1}


@pytest.mark.parametrize("case", ["1d-qshift_d", "3d-replicated",
                                  "3d-1x4-three-levels"])
def test_route_grads_match_the_cpu_autograd(case):
    """The forward's gradient through the card's route against the CPU
    mesh's own autograd (the plain versions) at 1e-12: the 1-D qshift_d
    level that takes the plain route, a 3-D volume too shallow to shard
    (every level replicated, level 1 on Transform3d's own adjoint piece),
    and the 3-level 3-D depth-sharded route of the card's main path."""
    mesh = make_mesh((1, 4), _ROWS if case[:2] == "1d" else _DEPTH,
                     ["cpu"] * 4)
    if case == "1d-qshift_d":
        tr, shape, nl = (ShardedTransform1d(mesh, "near_sym_a", "qshift_d"),
                         (1, 96, 2), 3)
    else:
        tr, (shape, nl) = ShardedTransform3d(mesh), {
            "3d-replicated": ((1, 16, 16, 16), 2),
            "3d-1x4-three-levels": ((1, 128, 16, 16), 3)}[case]
    x = _rand(shape, 42)
    out = []
    for route in (True, False):
        xt = torch.from_numpy(x).requires_grad_()
        with _vjp_route() if route else contextlib.nullcontext():
            p = tr.forward(xt, nl)
        leaves = linearize._tree(p)[0]
        cots = [torch.from_numpy(c) for c in _like(leaves, 43)]
        out.append(torch.autograd.grad(leaves, xt, cots)[0])
    assert float((out[0] - out[1]).abs().max()) <= TOL * float(
        out[1].abs().max())


# --- BatchSharded and the Function's node ------------------------------------

def test_batch_sharded_grad_is_the_whole_batchs():
    """BatchSharded(Transform2d()) over four CPU devices through the card's
    route: the forward's input gradient and the inverse's pyramid
    gradients equal Transform2d's on the whole batch."""
    t = tdt.Transform2d(device="cpu")
    bt = BatchSharded(t, make_mesh((4,), ("data",), ["cpu"] * 4))
    x = _rand((8, 32, 48), 50)
    out = []
    for tr in (bt, t):
        xt = torch.from_numpy(x).requires_grad_()
        with _vjp_route():
            p = tr.forward(xt, 3)
        leaves, spec = linearize._tree(p)
        cots = [torch.from_numpy(c) for c in _like(leaves, 51)]
        gx = torch.autograd.grad(leaves, xt, cots)
        pt, pl, _ = _pyramids(leaves, spec, _like(leaves, 52))
        with _vjp_route():
            z = tr.inverse(pt)
        gp = torch.autograd.grad(z, pl, torch.from_numpy(
            _rand(tuple(z.shape), 53)))
        out.append(gx + gp)
    for a, b in zip(*out):
        assert torch.allclose(a, b, rtol=0, atol=TOL * float(b.abs().max()))


def test_pass_node_keeps_no_tensor_alive():
    """A sharded pass's Function node keeps neither its operand grid nor
    its result: with the garbage collector off, dropping the last
    reference frees each, and the backward runs after both are gone; a
    whole sharded forward's pyramid is freed likewise."""
    st = ShardedTransform2d(make_mesh((1, 2), _ROWS, ["cpu"] * 2))
    b = st.biort
    xs = _grid((1, 32, 16), 2, 60)
    gc.disable()
    try:
        with _vjp_route():
            op = [[2 * t for t in row] for row in xs]
            dead_in = [weakref.ref(t) for row in op for t in row]
            out = st._pass(op, -2, True, 8, "filter2", dual, b[0], b[2])
            del op
            assert all(r() is None for r in dead_in)
            loss = sum(u.sum() + v.sum() for row in out for u, v in row)
            dead_out = [weakref.ref(t) for t in linearize._tree(out)[0]]
            del out
            assert all(r() is None for r in dead_out)
            loss.backward()
            x = torch.from_numpy(_rand((1, 64, 32), 61)).requires_grad_()
            p = st.forward(x, 3)
            dead = [weakref.ref(t) for t in linearize._tree(p)[0]]
            del p
            assert all(r() is None for r in dead)
    finally:
        gc.enable()
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for row in xs for t in row)


def test_hw_entries_run_under_no_grad_inside_the_route():
    """Through the card's route the sharded 3-D forward calls each hw
    entry inside its Function, where grad mode is off: the entries' own
    refusal of inputs that need grad (``_build.check_no_grad``, held on
    the card by ``tests/test_torch_cuda.py``) stays for direct calls."""
    st = ShardedTransform3d(make_mesh((1, 2), _DEPTH, ["cpu"] * 2))
    seen = []
    real = hw.filter_hw22

    def spy(v, *f):
        seen.append(torch.is_grad_enabled())
        return real(v, *f)
    x = torch.from_numpy(_rand((1, 32, 16, 16), 62)).requires_grad_()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hw, "filter_hw22", spy)
        with _vjp_route():
            st.forward(x, 1)
    assert seen == [False, False]
