"""The four level modules of the port (``ops/level1``, ``level2``,
``ilevel2``, ``ilevel1``).

On the CPU each wrapper runs its plain version.  That is held against
(a) the JAX package's Pallas kernel of the same level, run in interpret mode
as ``tests/test_pallas.py`` runs it, at float32 with test_pallas's 1e-4, and
(b) the XLA composition of ``dtcwt_tpu.ops.fb`` that test_pallas uses as its
reference, at float64 with 1e-12.  The CUDA kernels themselves are held
against these plain versions on the card by ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dtcwt_tpu.coeffs import biort, qshift
from dtcwt_tpu.ops import engine
from dtcwt_tpu.ops import fb as jfb
from dtcwt_tpu.ops.packing import c2q as jc2q, q2c as jq2c
from dtcwt_tpu_torch.ops import ilevel1, ilevel2, level1, level2
from dtcwt_tpu_torch.transforms.pyramid import PLANE_BAND_ORDER, _PLANE_POS

TOL = 1e-4       # test_pallas.TOL, for float32 against the Pallas kernels
TOL64 = 1e-12


def _err(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a.astype(np.complex128) - b).max())


def _deg(planes):
    """(re, im) planes in PLANE_BAND_ORDER -> complex [..., h, w, 6]."""
    re, im = (p.double() if isinstance(p, torch.Tensor) else
              torch.from_numpy(np.asarray(p, np.float64)) for p in planes)
    z = torch.complex(re, im)
    return torch.stack([z[..., _PLANE_POS[d], :, :] for d in range(6)], -1)


def _planes(yh):
    """complex [..., h, w, 6] -> (re, im) planes in PLANE_BAND_ORDER."""
    z = torch.stack([yh[..., d] for d in PLANE_BAND_ORDER], dim=-3)
    return z.real.contiguous(), z.imag.contiguous()


def _rand_yh(rng, shape, dtype=np.float64):
    return (rng.rand(*shape) + 1j * rng.rand(*shape)).astype(
        np.complex128 if dtype == np.float64 else np.complex64)


# --- the XLA compositions test_pallas.py holds the Pallas kernels to -------

def _xla_level1(x, h0o, h1o):
    with engine.engine("xla"):
        X = jnp.asarray(x)
        lo, hi = jfb.filter_axis(X, h0o, -2), jfb.filter_axis(X, h1o, -2)
        lolo = jfb.filter_axis(lo, h0o, -1)
        b05 = jq2c(jfb.filter_axis(hi, h0o, -1))
        b23 = jq2c(jfb.filter_axis(lo, h1o, -1))
        b14 = jq2c(jfb.filter_axis(hi, h1o, -1))
        return lolo, jnp.stack([b05[0], b14[0], b23[0], b23[1], b14[1],
                                b05[1]], axis=-1)


def _xla_level2(x, q):
    h0a, h0b, h1a, h1b = q[0], q[1], q[4], q[5]
    with engine.engine("xla"):
        X = jnp.asarray(x)
        lo = jfb.dfilt_axis(X, h0b, h0a, -2)
        hi = jfb.dfilt_axis(X, h1b, h1a, -2)
        lolo = jfb.dfilt_axis(lo, h0b, h0a, -1)
        b05 = jq2c(jfb.dfilt_axis(hi, h0b, h0a, -1))
        b23 = jq2c(jfb.dfilt_axis(lo, h1b, h1a, -1))
        b14 = jq2c(jfb.dfilt_axis(hi, h1b, h1a, -1))
        return lolo, jnp.stack([b05[0], b14[0], b23[0], b23[1], b14[1],
                                b05[1]], axis=-1)


def _xla_quads(yh):
    return (jc2q(yh[..., 0], yh[..., 5]), jc2q(yh[..., 2], yh[..., 3]),
            jc2q(yh[..., 1], yh[..., 4]))


def _xla_ilevel2(Z, yh, q):
    g0a, g0b, g1a, g1b = q[2], q[3], q[6], q[7]
    with engine.engine("xla"):
        Zj, yh = jnp.asarray(Z), jnp.asarray(yh)
        lh, hl, hh = _xla_quads(yh)
        y1 = jfb.ifilt_axis(Zj, g0b, g0a, -2) + jfb.ifilt_axis(lh, g1b, g1a,
                                                               -2)
        y2 = jfb.ifilt_axis(hl, g0b, g0a, -2) + jfb.ifilt_axis(hh, g1b, g1a,
                                                               -2)
        return (jfb.ifilt_axis(y1, g0b, g0a, -1)
                + jfb.ifilt_axis(y2, g1b, g1a, -1))


def _xla_ilevel1(Z, yh, g0o, g1o):
    with engine.engine("xla"):
        Zj, yh = jnp.asarray(Z), jnp.asarray(yh)
        lh, hl, hh = _xla_quads(yh)
        y1 = jfb.filter_axis(Zj, g0o, -2) + jfb.filter_axis(lh, g1o, -2)
        y2 = jfb.filter_axis(hl, g0o, -2) + jfb.filter_axis(hh, g1o, -2)
        return jfb.filter_axis(y1, g0o, -1) + jfb.filter_axis(y2, g1o, -1)


# --- plain versions against the Pallas kernels (interpret mode), float32 ---

def test_level1_plain_matches_pallas_kernel():
    from dtcwt_tpu.ops import pallas_level1
    h0o, _, h1o, _ = biort("near_sym_a")
    x = np.random.RandomState(7).rand(2, 128, 256).astype(np.float32)
    lolo_j, yh_j = pallas_level1.fwd_level1(jnp.asarray(x), h0o, h1o)
    _, (re_j, im_j) = pallas_level1.fwd_level1(jnp.asarray(x), h0o, h1o,
                                               as_planes=True)
    t = torch.from_numpy(x)
    lolo, yh = level1.fwd_level1(t, h0o, h1o)
    _, (re, im) = level1.fwd_level1(t, h0o, h1o, planes=True)
    assert yh.dtype == torch.complex64 and re.dtype == torch.float32
    assert _err(lolo, lolo_j) < TOL
    assert _err(yh, yh_j) < TOL
    assert _err(re, re_j) < TOL and _err(im, im_j) < TOL


def test_level2_plain_matches_pallas_kernel():
    from dtcwt_tpu.ops import pallas_level2
    q = qshift("qshift_a")
    x = np.random.RandomState(8).rand(2, 64, 384).astype(np.float32)
    lolo_j, (re_j, im_j) = pallas_level2.fwd_level2(
        jnp.asarray(x), q[0], q[1], q[4], q[5], as_planes=True)
    t = torch.from_numpy(x)
    lolo, yh = level2.fwd_level2(t, q[0], q[1], q[4], q[5])
    _, (re, im) = level2.fwd_level2(t, q[0], q[1], q[4], q[5], planes=True)
    assert _err(lolo, lolo_j) < TOL
    assert _err(re, re_j) < TOL and _err(im, im_j) < TOL
    assert _err(yh, _deg((re_j, im_j))) < TOL


def test_ilevel2_plain_matches_pallas_kernel():
    from dtcwt_tpu.ops import pallas_ilevel2
    q = qshift("qshift_a")
    rng = np.random.RandomState(9)
    Z = rng.rand(2, 64, 256).astype(np.float32)
    yh = _rand_yh(rng, (2, 32, 128, 6), np.float32)
    want = pallas_ilevel2.inv_level2(jnp.asarray(Z), jnp.asarray(yh),
                                     q[2], q[3], q[6], q[7])
    z, y = torch.from_numpy(Z), torch.from_numpy(yh)
    got = ilevel2.inv_level2(z, y, q[2], q[3], q[6], q[7])
    got_p = ilevel2.inv_level2(z, None, q[2], q[3], q[6], q[7],
                               bands=_planes(y))
    assert got.dtype == torch.float32
    assert _err(got, want) < TOL and _err(got_p, want) < TOL


def test_ilevel1_plain_matches_pallas_kernel():
    from dtcwt_tpu.ops import pallas_ilevel1
    b = biort("near_sym_a")
    rng = np.random.RandomState(10)
    Z = rng.rand(64, 256).astype(np.float32)
    yh = _rand_yh(rng, (32, 128, 6), np.float32)
    want = pallas_ilevel1.inv_level1(jnp.asarray(Z), jnp.asarray(yh),
                                     b[1], b[3])
    z, y = torch.from_numpy(Z), torch.from_numpy(yh)
    got = ilevel1.inv_level1(z, y, b[1], b[3])
    got_p = ilevel1.inv_level1(z, None, b[1], b[3], bands=_planes(y))
    assert _err(got, want) < TOL and _err(got_p, want) < TOL


# --- plain versions against the XLA compositions, float64 ------------------
# near_sym_b (19 taps) and qshift_32 (32 taps) also run on signals shorter
# than the filter, where the extension folds more than once.

@pytest.mark.parametrize("fam", ["near_sym_a", "near_sym_b", "antonini",
                                 "legall"])
@pytest.mark.parametrize("shape", [(2, 36, 52), (6, 10), (2, 4, 6)])
def test_level1_plain_matches_xla_f64(fam, shape):
    h0o, _, h1o, _ = biort(fam)
    x = np.random.RandomState(11).rand(*shape)
    lolo_j, yh_j = _xla_level1(x, h0o, h1o)
    lolo, yh = level1.fwd_level1(torch.from_numpy(x), h0o, h1o)
    _, planes = level1.fwd_level1(torch.from_numpy(x), h0o, h1o, planes=True)
    assert _err(lolo, lolo_j) < TOL64
    assert _err(yh, yh_j) < TOL64
    assert _err(_deg(planes), yh_j) < TOL64


@pytest.mark.parametrize("fam", ["qshift_a", "qshift_d", "qshift_32",
                                 "qshift_06"])
@pytest.mark.parametrize("shape", [(2, 40, 56), (8, 12)])
def test_level2_plain_matches_xla_f64(fam, shape):
    q = qshift(fam)
    x = np.random.RandomState(12).rand(*shape)
    lolo_j, yh_j = _xla_level2(x, q)
    t = torch.from_numpy(x)
    lolo, yh = level2.fwd_level2(t, q[0], q[1], q[4], q[5])
    _, planes = level2.fwd_level2(t, q[0], q[1], q[4], q[5], planes=True)
    assert _err(lolo, lolo_j) < TOL64
    assert _err(yh, yh_j) < TOL64
    assert _err(_deg(planes), yh_j) < TOL64


@pytest.mark.parametrize("fam", ["qshift_a", "qshift_b", "qshift_32"])
@pytest.mark.parametrize("hw", [(2, 20, 28), (6, 10)])
def test_ilevel2_plain_matches_xla_f64(fam, hw):
    q = qshift(fam)
    rng = np.random.RandomState(13)
    Z = rng.rand(*hw)
    yh = _rand_yh(rng, hw[:-2] + (hw[-2] // 2, hw[-1] // 2, 6))
    want = _xla_ilevel2(Z, yh, q)
    z, y = torch.from_numpy(Z), torch.from_numpy(yh)
    assert _err(ilevel2.inv_level2(z, y, q[2], q[3], q[6], q[7]),
                want) < TOL64
    assert _err(ilevel2.inv_level2(z, None, q[2], q[3], q[6], q[7],
                                   bands=_planes(y)), want) < TOL64


@pytest.mark.parametrize("fam", ["near_sym_a", "near_sym_b"])
@pytest.mark.parametrize("hw", [(2, 36, 52), (4, 6)])
def test_ilevel1_plain_matches_xla_f64(fam, hw):
    b = biort(fam)
    rng = np.random.RandomState(14)
    Z = rng.rand(*hw)
    yh = _rand_yh(rng, hw[:-2] + (hw[-2] // 2, hw[-1] // 2, 6))
    want = _xla_ilevel1(Z, yh, b[1], b[3])
    z, y = torch.from_numpy(Z), torch.from_numpy(yh)
    assert _err(ilevel1.inv_level1(z, y, b[1], b[3]), want) < TOL64
    assert _err(ilevel1.inv_level1(z, None, b[1], b[3], bands=_planes(y)),
                want) < TOL64


def test_stream_plans_reproduce_the_primitives():
    """The host-side stream plans the CUDA kernels read are the closed forms
    of fb.dfilt/ifilt: evaluating them in numpy gives the primitives."""
    from dtcwt_tpu_torch.ops import fb
    from dtcwt_tpu_torch.utils import reflect
    x = np.random.RandomState(15).rand(12)
    refl = lambda i: x[reflect(np.asarray(i, np.float64), -0.5,
                               x.size - 0.5).astype(int)]
    for fam in ("qshift_a", "qshift_d", "qshift_32", "qshift_06"):
        q = qshift(fam)
        for ha, hb in [(q[1], q[0]), (q[5], q[4])]:
            taps, offs = level2.dfilt_streams(ha, hb)
            y = np.zeros(x.size // 2)
            for s in range(2):
                for i in range(x.size // 4):
                    y[2 * i + s] = sum(taps[s][k] * refl(4 * i + offs[s]
                                                         + 2 * k)
                                       for k in range(taps.shape[1]))
            want = fb.dfilt_axis(torch.from_numpy(x), ha, hb, 0).numpy()
            assert np.abs(y - want).max() < TOL64
        for ha, hb in [(q[3], q[2]), (q[7], q[6])]:
            taps, offs = ilevel2.ifilt_streams(ha, hb)
            y = np.zeros(2 * x.size)
            for s in range(4):
                for i in range(x.size // 2):
                    y[4 * i + s] = sum(taps[s][k] * refl(2 * i + offs[s]
                                                         + 2 * k)
                                       for k in range(taps.shape[1]))
            want = fb.ifilt_axis(torch.from_numpy(x), ha, hb, 0).numpy()
            assert np.abs(y - want).max() < TOL64


def test_wrappers_refuse_other_devices():
    h0o, _, h1o, _ = biort("near_sym_a")
    x = torch.zeros(8, 8, device="meta")
    with pytest.raises(ValueError):
        level1.fwd_level1(x, h0o, h1o)
