"""The 3-D level module of the port (``ops/pack3d``): the plain versions of
the four level kernels ``fwd_level1_pack``, ``inv_level1_pack``,
``fwd_level2_pack`` and ``inv_level2_pack``.

On the CPU each entry runs its plain version.  That is held against (a) the
JAX package's Pallas kernels of ``pallas_pack3d`` run in interpret mode, as
``tests/test_pack3d.py`` runs them, at float32 with 1e-4; and (b) the
composition ``tests/test_pack3d.py`` uses as its oracle (``dtcwt_tpu.ops.fb``
dual forms along W, H and D, then ``cube2c_planes`` per octant) under the
XLA engine at float64 with 1e-12, in both layouts.  The CUDA kernels are
held against these plain versions on the card by ``test_torch_cuda.py``.
Inputs are made with numpy from a seed and fed to both packages.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dtcwt_tpu.coeffs import biort, qshift
from dtcwt_tpu.ops import engine, pallas_pack3d
from dtcwt_tpu.ops import fb as jfb
from dtcwt_tpu.ops.packing import c2cube_planes, cube2c_planes
from dtcwt_tpu_torch.ops import pack3d

TOL = 1e-4       # tests/test_pack3d.py, float32 against Pallas
TOL64 = 1e-12
_OCT = pallas_pack3d._OCTANTS
_SHAPES = [(16, 16, 32), (2, 12, 16, 32)]


def _err(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    worst = 0.0
    for a, b in zip(got, want):
        a = a.numpy().astype(np.complex128)
        b = np.asarray(b).astype(np.complex128)
        assert a.shape == b.shape, (a.shape, b.shape)
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def _filters(fam):
    """(analysis pair, synthesis pair) in the transform's call order."""
    if fam.startswith("near"):
        b = biort(fam)
        return (b[0], b[2]), (b[1], b[3])
    q = qshift(fam)
    return ((q[1], q[0]), (q[5], q[4])), ((q[3], q[2]), (q[7], q[6]))


def _jax_split(fam):
    (a0, a1), _ = _filters(fam)
    if fam.startswith("near"):
        return lambda v, ax: jfb.filter2_axis(v, a0, a1, ax)
    return lambda v, ax: jfb.dfilt2_axis(v, a0, a1, ax)


def _jax_merge(fam):
    _, (s0, s1) = _filters(fam)
    if fam.startswith("near"):
        return lambda a, b, ax: jfb.filter2_sum_axis(a, b, s0, s1, ax)
    return lambda a, b, ax: jfb.ifilt2_sum_axis(a, b, s0, s1, ax)


def _oracle_fwd(x, fam):
    """tests/test_pack3d.py's oracle: the dual forms along W, H, D, then
    cube2c_planes per octant (XLA engine)."""
    split = _jax_split(fam)
    with engine.engine("xla"):
        octs = {}
        for k, v in enumerate(split(jnp.asarray(x), -1)):
            for j, vj in enumerate(split(v, -2)):
                octs[(0, j, k)], octs[(1, j, k)] = split(vj, -3)
        parts = [cube2c_planes(octs[o]) for o in _OCT]
        return (octs[(0, 0, 0)],
                jnp.concatenate([r for r, _ in parts], axis=-4),
                jnp.concatenate([i for _, i in parts], axis=-4))


def _oracle_inv(lll, re, im, fam):
    merge = _jax_merge(fam)
    with engine.engine("xla"):
        re, im = jnp.asarray(re), jnp.asarray(im)
        octs = {o: c2cube_planes(re[..., 4 * n:4 * n + 4, :, :, :],
                                 im[..., 4 * n:4 * n + 4, :, :, :])
                for n, o in enumerate(_OCT)}
        octs[(0, 0, 0)] = jnp.asarray(lll)
        V = {(j, k): merge(octs[(0, j, k)], octs[(1, j, k)], -3)
             for j in range(2) for k in range(2)}
        return merge(merge(V[(0, 0)], V[(1, 0)], -2),
                     merge(V[(0, 1)], V[(1, 1)], -2), -1)


def _port_fwd(fam):
    a, _ = _filters(fam)
    return pack3d.fwd_level1_pack if fam.startswith("near") else \
        pack3d.fwd_level2_pack, a


def _port_inv(fam):
    _, s = _filters(fam)
    return pack3d.inv_level1_pack if fam.startswith("near") else \
        pack3d.inv_level2_pack, s


def _inverse_inputs(shape, fam, seed, dtype=np.float64):
    """A lowpass and random band planes for one inverse level: level 1
    reads [..., D, H, W] at the volume's size, level 2 at half of it."""
    rng = np.random.RandomState(seed)
    if fam.startswith("q"):
        shape = tuple(shape[:-3]) + tuple(s // 2 for s in shape[-3:])
    D, H, W = shape[-3:]
    bshape = tuple(shape[:-3]) + (28, D // 2, H // 2, W // 2)
    return tuple(rng.randn(*s).astype(dtype) for s in (shape, bshape, bshape))


_FAMS = ["near_sym_a", "near_sym_b", "qshift_a", "qshift_b"]


@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("fam", _FAMS)
def test_forward_matches_oracle_f64(fam, shape):
    x = np.random.RandomState(0).randn(*shape)
    fn, pair = _port_fwd(fam)
    wl, wre, wim = _oracle_fwd(x, fam)
    lll, (re, im) = fn(torch.from_numpy(x), *pair)
    assert lll.dtype == re.dtype == torch.float64
    assert _err((lll, re, im), (wl, wre, wim)) < TOL64
    _, z = fn(torch.from_numpy(x), *pair, planes=False)
    assert z.dtype == torch.complex128
    assert _err(z.movedim(-1, -4), np.asarray(wre) + 1j * np.asarray(wim)) \
        < TOL64


@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("fam", _FAMS)
def test_inverse_matches_oracle_f64(fam, shape):
    lll, re, im = _inverse_inputs(shape, fam, 1)
    fn, pair = _port_inv(fam)
    want = _oracle_inv(lll, re, im, fam)
    t = [torch.from_numpy(a) for a in (lll, re, im)]
    assert _err(fn(*t, *pair), want) < TOL64
    z = torch.complex(t[1], t[2]).movedim(-4, -1).contiguous()
    assert _err(fn(t[0], z, None, *pair), want) < TOL64


# --- plain versions against the Pallas kernels (interpret mode), float32 ---
# near_sym_b at (20, 32, 32): the Pallas level-1 kernels decline extents
# shorter than twice the filter's half-length (pallas_pack3d._envelope3)

_PALLAS = [("near_sym_a", (16, 16, 32)), ("near_sym_a", (2, 12, 16, 32)),
           ("near_sym_b", (20, 32, 32)), ("qshift_a", (16, 16, 32)),
           ("qshift_b", (2, 12, 16, 32))]


@pytest.mark.parametrize("fam,shape", _PALLAS)
def test_plain_matches_pallas_kernels(fam, shape):
    """Forward against the Pallas forward, and inverse against the Pallas
    inverse on the Pallas forward's output."""
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    fwd, a = _port_fwd(fam)
    inv, s = _port_inv(fam)
    pfwd = pallas_pack3d.fwd_level1_pack if fam.startswith("near") else \
        pallas_pack3d.fwd_level2_pack
    pinv = pallas_pack3d.inv_level1_pack if fam.startswith("near") else \
        pallas_pack3d.inv_level2_pack
    out = pfwd(jnp.asarray(x), *a)
    assert out is not None
    wl, (wre, wim) = out
    lll, (re, im) = fwd(torch.from_numpy(x), *a)
    assert lll.dtype == torch.float32
    assert _err((lll, re, im), (wl, wre, wim)) < TOL
    want = pinv(wl, wre, wim, *s)
    assert want is not None
    got = inv(*(torch.from_numpy(np.asarray(v)) for v in (wl, wre, wim)), *s)
    assert _err(got, want) < TOL


def test_bf16_plain_runs_at_f32_and_stores_bf16():
    x = np.random.RandomState(3).rand(8, 8, 12).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    (h0, h1), (g0, g1) = _filters("near_sym_a")
    lll, (re, im) = pack3d.fwd_level1_pack(xb, h0, h1)
    wl, (wre, wim) = pack3d.fwd_level1_pack(xb.float(), h0, h1)
    assert lll.dtype == re.dtype == im.dtype == torch.bfloat16
    assert torch.equal(lll, wl.to(torch.bfloat16))
    assert torch.equal(re, wre.to(torch.bfloat16))
    y = pack3d.inv_level1_pack(lll, re, im, g0, g1)
    assert y.dtype == torch.bfloat16
    want = pack3d.inv_level1_pack(lll.float(), re.float(), im.float(), g0, g1)
    assert torch.equal(y, want.to(torch.bfloat16))
    with pytest.raises(TypeError, match="plane layout"):
        pack3d.fwd_level1_pack(xb, h0, h1, planes=False)


def test_input_errors_and_other_devices():
    (h0, h1), (g0, g1) = _filters("near_sym_a")
    p, s = _filters("qshift_a")
    x = torch.zeros(8, 8, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="D, H, W"):
        pack3d.fwd_level1_pack(x[:, :, :7], h0, h1)
    with pytest.raises(ValueError, match="multiples of 4"):
        pack3d.fwd_level2_pack(x[:6], *p)
    with pytest.raises(ValueError, match="volume"):
        pack3d.fwd_level1_pack(x[0], h0, h1)
    with pytest.raises(ValueError, match="odd-length"):
        pack3d.fwd_level1_pack(x, np.ones(4) / 4, np.ones(4) / 4)
    with pytest.raises(ValueError, match="subband planes"):
        pack3d.inv_level1_pack(x, torch.zeros(28, 4, 4, 3, dtype=x.dtype),
                               torch.zeros(28, 4, 4, 3, dtype=x.dtype), g0, g1)
    with pytest.raises(ValueError, match="subbands must be"):
        pack3d.inv_level2_pack(x, torch.zeros(4, 4, 4, 28), None, *s)
    m = torch.zeros(8, 8, 8, device="meta")
    zb = torch.zeros(28, 4, 4, 4, device="meta")
    for call in (lambda: pack3d.fwd_level1_pack(m, h0, h1),
                 lambda: pack3d.fwd_level2_pack(m, *p),
                 lambda: pack3d.inv_level1_pack(m, zb, zb, g0, g1),
                 lambda: pack3d.inv_level2_pack(m, zb, zb, *s)):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            call()
