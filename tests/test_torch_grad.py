"""Gradients of the port's transforms through ``ops.linearize`` on the CPU,
float64, against ``jax.vjp`` of ``dtcwt_tpu``'s transforms (XLA engine) at
1e-12 relative to each leaf's largest value.

On the card a transform whose input requires grad runs its level chain as
one ``linear_vjp`` Function; the tests reach that route here through the
entry the card uses, ``linearize.needs_vjp``, patched to hold for CPU
tensors (:func:`_vjp_route`).  The Function's backward runs the explicit
adjoint (on the plain versions here) or the plain chain's vjp, as the
configuration chooses.  PyTorch's gradient of a
complex leaf is the conjugate of JAX's cotangent: the tests give JAX the
conjugates of the port's output gradients and compare the port's complex
input gradients with the conjugates of JAX's.  Inputs are made with numpy
from a seed.
"""

import contextlib
import gc
import weakref

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import dtcwt_tpu as jdt
from dtcwt_tpu.ops import engine
import dtcwt_tpu_torch as tdt
from dtcwt_tpu_torch import compat
from dtcwt_tpu_torch.ops import dual, ilevel2, linearize

TOL = 1e-12
FAMS = [("near_sym_a", "qshift_a"), ("near_sym_b", "qshift_b")]


@pytest.fixture(autouse=True)
def _xla_engine():
    with engine.engine("xla"):
        yield


@contextlib.contextmanager
def _vjp_route():
    """Transforms called inside take the card's route on CPU tensors:
    their level chain runs as one ``linear_vjp`` Function."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(linearize, "needs_vjp", lambda _: True)
        yield


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape)


def _leaves(p):
    """A pyramid's tensors in the order of JAX's pytree (None left out)."""
    return linearize._tree(p)[0]


def _cots(leaves, seed):
    """Random output gradients, complex where the leaf is."""
    out = []
    for i, a in enumerate(leaves):
        c = _rand(tuple(a.shape), seed + i)
        if a.is_complex():
            c = c + 1j * _rand(tuple(a.shape), seed + 100 + i)
        out.append(c)
    return out


def _jax_vjp(f, primal, cots):
    """The leaves of ``jax.vjp`` of *f* at *primal*, applied to the port's
    output gradients *cots* in JAX's convention, as one compiled program."""
    out = jax.eval_shape(f, primal)
    ct = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(out),
                                      [jnp.asarray(np.conj(c)) for c in cots])
    grads = jax.jit(lambda p, c: jax.vjp(f, p)[1](c)[0])(primal, ct)
    return jax.tree_util.tree_leaves(grads)


def _check(got, want):
    """Port gradients against JAX's, complex leaves conjugated."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy()
        w = np.asarray(w)
        if np.iscomplexobj(w):
            w = np.conj(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        assert np.abs(g - w).max() <= TOL * np.abs(w).max()


def _fwd_check(t, jf, x, fwd, seed=1):
    """Gradient of ``fwd(t, input)`` through the card's route against
    jax.vjp of *jf* at the numpy input *x*."""
    xt = torch.from_numpy(x).requires_grad_()
    with _vjp_route():
        leaves = _leaves(fwd(t, xt))
    cots = _cots(leaves, seed)
    got = torch.autograd.grad(leaves, xt, [torch.from_numpy(c)
                                           for c in cots])
    _check(got, _jax_vjp(jf, jnp.asarray(x), cots))


def _pyramids(p, planes, kind, seed):
    """A port pyramid whose leaves require grad, with random values in the
    shapes of *p*, and the same pyramid for JAX."""
    vals = [_rand(tuple(a.shape), seed + i) + (
        1j * _rand(tuple(a.shape), seed + 50 + i) if a.is_complex() else 0)
        for i, a in enumerate(_leaves(p))]
    ts = [torch.from_numpy(v).requires_grad_() for v in vals]
    js = [jnp.asarray(v) for v in vals]
    if planes:
        n = (len(vals) - 1) // 2
        return (tdt.PlanePyramid(ts[0], ts[1:n + 1], ts[n + 1:], kind=kind),
                jdt.PlanePyramid(js[0], js[1:n + 1], js[n + 1:], None,
                                 kind=kind))
    return tdt.Pyramid(ts[0], ts[1:]), jdt.Pyramid(js[0], tuple(js[1:]))


def _inv_check(inv, jinv, pyr, jpyr, seed=7):
    """Gradient of the port's ``inv(pyr)`` through the card's route with
    respect to every leaf against jax.vjp of *jinv* at *jpyr*."""
    with _vjp_route():
        z = inv(pyr)
    v = _rand(tuple(z.shape), seed)
    got = torch.autograd.grad(z, _leaves(pyr), torch.from_numpy(v))
    _check(got, _jax_vjp(jinv, jpyr, [v]))


# --- Transform2d ------------------------------------------------------------

@pytest.mark.parametrize("fams", FAMS)
@pytest.mark.parametrize("layout", ["interleaved", "planes"])
@pytest.mark.parametrize("nlevels", [1, 2, 3])
def test_transform2d_grads_match_jax(fams, layout, nlevels):
    """Forward and inverse gradients through the explicit adjoints."""
    t, jt = tdt.Transform2d(*fams, device="cpu"), jdt.Transform2d(*fams)
    planes = layout == "planes"
    x = _rand((2, 32, 24), 0)
    assert t._fwd_adjoint_fn(x.shape, torch.float64, nlevels, False,
                             planes) is not None
    _fwd_check(t, lambda a: jt._forward_impl(
        a, nlevels=nlevels, include_scale=False, layout=layout), x,
        lambda tt, a: tt.forward(a, nlevels, layout=layout))
    p = t.forward(torch.from_numpy(x), nlevels, layout=layout)
    pyr, jpyr = _pyramids(p, planes, "2d", 3)
    assert t._inv_adjoint_fn(pyr) is not None
    _inv_check(t.inverse,
               lambda q: jt._inverse_impl(q, None), pyr, jpyr)


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_transform2d_plain_route_grads_match_jax(layout):
    """Configurations outside the explicit envelope take the plain route:
    an odd-sized image (pads and crops in the chain) with include_scale,
    the bandpass families, and a gain-masked inverse."""
    planes = layout == "planes"
    for fams in (FAMS[0], ("near_sym_b_bp", "qshift_b_bp")):
        t, jt = tdt.Transform2d(*fams, device="cpu"), jdt.Transform2d(*fams)
        x = _rand((21, 30), 1)
        assert t._fwd_adjoint_fn(x.shape, torch.float64, 2, True,
                                 planes) is None
        _fwd_check(t, lambda a: jt._forward_impl(
            a, nlevels=2, include_scale=True, layout=layout), x,
            lambda tt, a: tt.forward(a, 2, True, layout))
        p = t.forward(torch.from_numpy(x), 2, layout=layout)
        pyr, jpyr = _pyramids(p, planes, "2d", 5)
        gm = _rand((6, 2), 9)
        _inv_check(lambda q: t.inverse(q, gm),
                   lambda q: jt._inverse_impl(q, jnp.asarray(gm)), pyr, jpyr)


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_transform2d_gain_mask_inverse_grad(layout):
    """The gain mask is a multiply before the Function: the explicit
    adjoint runs gain-free, and autograd differentiates the gains."""
    t, jt = tdt.Transform2d(device="cpu"), jdt.Transform2d()
    planes = layout == "planes"
    p = t.forward(torch.from_numpy(_rand((16, 16), 2)), 3, layout=layout)
    pyr, jpyr = _pyramids(p, planes, "2d", 11)
    assert t._inv_adjoint_fn(pyr) is not None
    gm = _rand((6, 3), 12)
    _inv_check(lambda q: t.inverse(q, gm),
               lambda q: jt._inverse_impl(q, jnp.asarray(gm)), pyr, jpyr)


@pytest.mark.parametrize("shape,explicit", [((8, 8), False),
                                            ((10, 10), True),
                                            ((18, 10), True)])
def test_transform2d_short_image_border_fold(shape, explicit):
    """near_sym_b's 19-tap filters fold a 9-sample border: an 8 x 8
    level-1 image is shorter than that and takes the plain route, 10 x 10
    (and 10 wide) the explicit one; both give JAX's gradients."""
    fams = ("near_sym_b", "qshift_b")
    t, jt = tdt.Transform2d(*fams, device="cpu"), jdt.Transform2d(*fams)
    x = _rand(shape, 4)
    assert (t._fwd_adjoint_fn(shape, torch.float64, 1, False, False)
            is not None) == explicit
    _fwd_check(t, lambda a: jt._forward_impl(a, nlevels=1,
                                             include_scale=False), x,
               lambda tt, a: tt.forward(a, 1))
    pyr, jpyr = _pyramids(t.forward(torch.from_numpy(x), 1), False, "2d", 6)
    assert (t._inv_adjoint_fn(pyr) is not None) == explicit
    _inv_check(t.inverse,
               lambda q: jt._inverse_impl(q, None), pyr, jpyr)


def test_transform2d_longest_filters():
    """The longest filters the card's primal takes, a 31-tap biort pair
    (the level-1 kernels' bound) and qshift_32's 32 taps, take the
    explicit route too: the dual kernels' plans hold the reversed 31-tap
    filters and the inverse kernel's the synthesis pairs, and the
    gradients match JAX's."""
    rng = np.random.RandomState(13)
    b = tuple(rng.randn(n) for n in (31, 29, 29, 31))
    q = tdt.qshift("qshift_32")
    t, jt = tdt.Transform2d(b, q, device="cpu"), jdt.Transform2d(b, q)
    for name in ("filter2_sum", "filter2"):
        for h0, h1 in ((b[0], b[2]), (b[1], b[3])):
            dual._plan(name, (h0[::-1], h1[::-1]))
    ilevel2._plan(q[3], q[2], q[7], q[6], None, None)
    x = _rand((32, 32), 14)
    assert t._fwd_adjoint_fn(x.shape, torch.float64, 2, False,
                             False) is not None
    _fwd_check(t, lambda a: jt._forward_impl(a, nlevels=2,
                                             include_scale=False), x,
               lambda tt, a: tt.forward(a, 2))
    pyr, jpyr = _pyramids(t.forward(torch.from_numpy(x), 2), False, "2d", 15)
    assert t._inv_adjoint_fn(pyr) is not None
    _inv_check(t.inverse,
               lambda q_: jt._inverse_impl(q_, None), pyr, jpyr)


@pytest.mark.parametrize("shape", [(8, 8), (16, 16)])
@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_transform2d_gradcheck_explicit_route(shape, layout):
    """torch.autograd.gradcheck of the explicit route, forward and
    inverse, at 2 levels."""
    t = tdt.Transform2d(device="cpu")
    planes = layout == "planes"
    x = torch.from_numpy(_rand(shape, 16)).requires_grad_()
    assert t._fwd_adjoint_fn(shape, torch.float64, 2, False,
                             planes) is not None

    def forward(v):
        return tuple(torch.view_as_real(a) if a.is_complex() else a
                     for a in _leaves(t.forward(v, 2, layout=layout)))
    with _vjp_route():
        assert torch.autograd.gradcheck(forward, (x,), fast_mode=True)
    p = t.forward(x.detach(), 2, layout=layout)
    leaves = [a.detach().requires_grad_() for a in _leaves(p)]
    spec = linearize._tree(p)[1]
    assert t._inv_adjoint_fn(linearize._fill(spec, leaves)) is not None
    with _vjp_route():
        assert torch.autograd.gradcheck(
            lambda *ls: t.inverse(linearize._fill(spec, ls)),
            tuple(leaves), fast_mode=True)


def test_route_choice():
    """Which configurations take the explicit adjoint: the published
    odd biort / qshift pairs at crop-free shapes in float32 and float64,
    both layouts; not the bandpass families, include_scale, a pad in the
    chain, bfloat16, a non-orthogonal 8-tuple or even-length biort
    filters.  The choice reads the configuration only; the public entries
    keep PyTorch's own autograd on the CPU."""
    shape = (64, 64)
    fwd = lambda t, **kw: t._fwd_adjoint_fn(
        kw.get("shape", shape), kw.get("dtype", torch.float32),
        kw.get("nlevels", 3), kw.get("scale", False),
        kw.get("planes", False))
    for b in ("antonini", "legall", "near_sym_a", "near_sym_b"):
        for q in ("qshift_06", "qshift_a", "qshift_b", "qshift_c",
                  "qshift_d", "qshift_32"):
            t = tdt.Transform2d(b, q, device="cpu")
            for dtype in (torch.float32, torch.float64):
                for planes in (False, True):
                    assert fwd(t, dtype=dtype, planes=planes) is not None
    t = tdt.Transform2d(device="cpu")
    assert fwd(t, scale=True) is None
    assert fwd(t, shape=(60, 64)) is None
    assert fwd(t, shape=(64, 60), nlevels=3) is None
    assert fwd(t, shape=(64, 60), nlevels=2) is not None
    assert fwd(t, dtype=torch.bfloat16, planes=True) is None
    assert fwd(tdt.Transform2d("near_sym_b_bp", "qshift_b_bp",
                               device="cpu")) is None
    assert fwd(tdt.Transform2d("near_sym_b_bp", "qshift_b",
                               device="cpu")) is None
    q = [np.array(v) for v in tdt.qshift("qshift_a")]
    q[4] = q[4] * (1 + 1e-6)
    assert fwd(tdt.Transform2d("near_sym_a", q, device="cpu")) is None
    even = tuple(np.array(v) for v in ([1, 3, 3, 1], [1, 3, 3, 1],
                                       [-1, 3, -3, 1], [1, -3, 3, -1]))
    te = tdt.Transform2d(even, "qshift_a", device="cpu")
    assert fwd(te) is None
    p = t.forward(torch.zeros(shape), 3)
    assert t._inv_adjoint_fn(p) is not None
    assert te._inv_adjoint_fn(p) is None
    pl = t.forward(torch.zeros(shape, dtype=torch.bfloat16), 3,
                   layout="planes")
    assert t._inv_adjoint_fn(pl) is None
    x = torch.zeros(shape, dtype=torch.float64, requires_grad=True)
    assert not linearize.needs_vjp(x)
    assert "LinearMap" not in type(t.forward(x, 2).lowpass.grad_fn).__name__
    with _vjp_route():
        assert "LinearMap" in type(t.forward(x, 2).lowpass.grad_fn).__name__


def test_plain_route_differentiates_twice():
    """The plain route's backward (torch.func.vjp) keeps a graph: a
    second derivative through it equals PyTorch's own."""
    t = tdt.Transform2d("near_sym_b_bp", "qshift_b_bp", device="cpu")
    x = torch.from_numpy(_rand((16, 16), 17)).requires_grad_()
    grads = []
    for route in (_vjp_route, contextlib.nullcontext):
        with route():
            p = t.forward(x, 2)
        loss = sum((torch.view_as_real(a) if a.is_complex() else a).pow(3)
                   .sum() for a in _leaves(p))
        (g,) = torch.autograd.grad(loss, x, create_graph=True)
        grads.append(torch.autograd.grad(g.pow(2).sum(), x))
    assert torch.allclose(grads[0][0], grads[1][0], rtol=1e-12, atol=1e-12)


def test_compat_grads_equal_the_transform():
    """compat.dtwavexfm2 / dtwaveifm2 gradients equal Transform2d's through
    the explicit route."""
    x = _rand((16, 24), 18)
    t = tdt.Transform2d(device="cpu")
    grads = []
    for route in (True, False):
        xt = torch.from_numpy(x).requires_grad_()
        if route:
            with _vjp_route():
                p = t.forward(xt, 3)
            yl, yh = p.lowpass, p.highpasses
        else:
            yl, yh = compat.dtwavexfm2(xt, 3, device="cpu")
        yl2 = yl.detach().requires_grad_()
        yh2 = [h.detach().requires_grad_() for h in yh]
        if route:
            with _vjp_route():
                z = t.inverse(tdt.Pyramid(yl2, yh2))
        else:
            z = compat.dtwaveifm2(yl2, yh2, device="cpu")
        cots = _cots([yl] + list(yh), 19)
        g_fwd = torch.autograd.grad([yl] + list(yh), xt,
                                    [torch.from_numpy(c) for c in cots])
        g_inv = torch.autograd.grad(z, [yl2] + yh2,
                                    torch.from_numpy(_rand(z.shape, 20)))
        grads.append(g_fwd + g_inv)
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=1e-12, atol=1e-12)


def _scale3(p):
    """A linear map of a pyramid onto one of the same structure."""
    return tdt.Pyramid(p.lowpass * 3, tuple(h * 3 for h in p.highpasses))


def test_linear_vjp_keeps_no_tensor_alive():
    """The Function's node keeps neither its operand nor its result: with
    the garbage collector off, dropping the last reference frees each (a
    cycle through the node would keep a pyramid alive for every forward
    of a training loop).  The backward still runs after both are gone."""
    f = linearize.linear_vjp(_scale3, _scale3, _scale3)
    a = torch.from_numpy(_rand((8, 8), 30)).requires_grad_()
    h = torch.from_numpy(_rand((4, 4, 6), 31) + 1j * _rand((4, 4, 6), 32))
    h.requires_grad_()
    gc.disable()
    try:
        op = tdt.Pyramid(a * 2, (h * 2,))
        dead_in = [weakref.ref(x) for x in linearize._tree(op)[0]]
        out = f(op)
        del op
        assert all(r() is None for r in dead_in)
        loss = out.lowpass.sum() + out.highpasses[0].real.sum()
        dead_out = [weakref.ref(x) for x in linearize._tree(out)[0]]
        del out
        assert all(r() is None for r in dead_out)
        loss.backward()
    finally:
        gc.enable()
    assert torch.equal(a.grad, torch.full_like(a, 6.0))
    assert torch.equal(h.grad, torch.full_like(h, 6.0))


@pytest.mark.parametrize("fams", [FAMS[0], ("near_sym_b_bp", "qshift_b_bp")])
def test_transform2d_route_frees_its_pyramid(fams):
    """A forward through the route (explicit, or plain for the bandpass
    families) leaves no reference to its output pyramid once the caller
    drops it, the garbage collector off."""
    t = tdt.Transform2d(*fams, device="cpu")
    x = torch.from_numpy(_rand((16, 16), 33)).requires_grad_()
    gc.disable()
    try:
        with _vjp_route():
            p = t.forward(x, 3)
        dead = [weakref.ref(a) for a in _leaves(p)]
        del p
        assert all(r() is None for r in dead)
    finally:
        gc.enable()


def _scale3_views(p):
    """:func:`_scale3` through ``torch.view_as_real``, as the kernels'
    wrappers read complex bands: it refuses a conjugate-bit tensor."""
    return tdt.Pyramid(p.lowpass * 3, tuple(
        torch.view_as_complex(torch.view_as_real(h) * 3)
        for h in p.highpasses))


def test_linear_vjp_resolves_conjugate_cotangents():
    """A loss that reads a band through ``.conj()`` hands the backward a
    cotangent with the lazy conjugate bit; the adjoint gets it resolved."""
    f = linearize.linear_vjp(_scale3, _scale3_views, _scale3)
    a = torch.from_numpy(_rand((8, 8), 36)).requires_grad_()
    h = torch.from_numpy(_rand((4, 4, 6), 37) + 1j * _rand((4, 4, 6), 38))
    h.requires_grad_()
    w = torch.from_numpy(_rand((4, 4, 6), 39) + 1j * _rand((4, 4, 6), 40))
    out = f(tdt.Pyramid(a, (h,)))
    (out.highpasses[0].conj() * w).real.sum().backward()
    assert torch.allclose(h.grad, 3 * w, rtol=1e-15, atol=0)


def test_transform2d_grad_through_conj():
    """The same through the explicit route of Transform2d: a loss on the
    bands' conjugates gets PyTorch's own autograd's gradient."""
    t = tdt.Transform2d(device="cpu")
    x = torch.from_numpy(_rand((16, 16), 34))
    w = [torch.from_numpy(_rand((8 >> i, 8 >> i, 6), 35 + i)
                          + 1j * _rand((8 >> i, 8 >> i, 6), 41 + i))
         for i in range(3)]
    grads = []
    for route in (_vjp_route, contextlib.nullcontext):
        xt = x.clone().requires_grad_()
        with route():
            p = t.forward(xt, 3)
        loss = sum((h.conj() * v).real.sum() for h, v in
                   zip(p.highpasses, w))
        grads.append(torch.autograd.grad(loss, xt)[0])
    assert torch.allclose(grads[0], grads[1], rtol=1e-12, atol=1e-12)


# --- Transform1d ------------------------------------------------------------

@pytest.mark.parametrize("fams", FAMS)
@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_transform1d_plain_route_grads_match_jax(fams, layout):
    """The 1-D transform has no explicit adjoint (the JAX package has
    none): the plain route's gradients, 3 levels of [36, 3] (pads and
    crops), include_scale, and a gain-masked inverse."""
    t, jt = tdt.Transform1d(*fams, device="cpu"), jdt.Transform1d(*fams)
    planes = layout == "planes"
    x = _rand((36, 3), 25)
    _fwd_check(t, lambda a: jt._forward_impl(
        a, nlevels=3, include_scale=True, layout=layout), x,
        lambda tt, a: tt.forward(a, 3, True, layout))
    p = t.forward(torch.from_numpy(x), 3, layout=layout)
    pyr, jpyr = _pyramids(p, planes, "1d", 26)
    gm = _rand((3,), 27)
    _inv_check(lambda q: t.inverse(q, gm),
               lambda q: jt._inverse_impl(q, jnp.asarray(gm),
                                          ret_flat=False), pyr, jpyr)
