"""The two-sided (H, W) stage-pair module of the port (``ops/hw``).

On the CPU each entry runs its plain version.  That is held against (a) the
JAX package's Pallas kernels of ``pallas_hw`` run in interpret mode, as
``tests/test_pallas_hw.py`` runs them, at float32 within 1e-4; and (b)
``dtcwt_tpu.ops.fb``'s single-stream filters composed along W, then H,
under the XLA engine, at float64 within 1e-12, also at shapes the Pallas
envelope refuses.  The CUDA kernels are held against these plain versions
on the card by ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dtcwt_tpu.coeffs import biort, qshift
from dtcwt_tpu.ops import engine, pallas_hw
from dtcwt_tpu.ops import fb as jfb
from dtcwt_tpu_torch.ops import hw

TOL = 1e-4       # test_pallas_hw.TOL, float32 against Pallas
TOL64 = 1e-12

# (H, W) branch filters of each kind and family: near_sym_b's are 13 and 19
# taps long; the qshift pairs in the transform's call order
_BIORTS = ["near_sym_a", "near_sym_b"]
_QSHIFTS = ["qshift_a", "qshift_d"]
_SHAPES = [(6, 32, 48), (2, 5, 24, 64)]
# shapes the Pallas envelope refuses: H or W off its grid, above its 512
# cap or shorter than the filters
_ODD_SHAPES = [(3, 12, 20), (2, 4, 520), (1, 8, 4)]
_PAIRS = [(0, 0), (0, 1), (1, 0), (1, 1)]


def _filters(kind, fam):
    if kind in ("filter", "filter_sum"):
        b = biort(fam)
        return (b[0], b[2]) if kind == "filter" else (b[1], b[3])
    q = qshift(fam)
    if kind == "dfilt":
        return (q[1], q[0]), (q[5], q[4])
    return (q[3], q[2]), (q[7], q[6])


def _jax_axis(kind, x, f, axis):
    """JAX fb's single-stream filter *f* (a filter or a pair) along axis."""
    if kind in ("filter", "filter_sum"):
        return jfb.filter_axis(x, f, axis)
    name = "dfilt_axis" if kind == "dfilt" else "ifilt_axis"
    return getattr(jfb, name)(x, *f, axis)


def _jax_composed(kind, xs, f):
    """The (H, W) map through JAX fb at float64: four outputs (analysis) or
    one (synthesis)."""
    with engine.engine("xla"):
        if kind in ("filter", "dfilt"):
            x = jnp.asarray(xs[0])
            return [_jax_axis(kind, _jax_axis(kind, x, f[k], -1), f[j], -2)
                    for j, k in _PAIRS]
        return [sum(_jax_axis(kind, _jax_axis(kind, jnp.asarray(v), f[k],
                                              -1), f[j], -2)
                    for v, (j, k) in zip(xs, _PAIRS))]


def _port(kind, xs, f):
    ts = [torch.from_numpy(x) for x in xs]
    if kind in ("filter", "dfilt"):
        u = getattr(hw, kind + "_hw22")(ts[0], *f)
        return [u[j][k] for j, k in _PAIRS]
    return [getattr(hw, kind + "_hw22")(*ts, *f)]


def _err(got, want):
    got = got.double().numpy()
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max())


def _inputs(kind, shape, seed, dtype=np.float64):
    rng = np.random.RandomState(seed)
    n = 1 if kind in ("filter", "dfilt") else 4
    return [rng.randn(*shape).astype(dtype) for _ in range(n)]


_CASES = ([(k, f) for k in ("filter", "filter_sum") for f in _BIORTS]
          + [(k, f) for k in ("dfilt", "ifilt_sum") for f in _QSHIFTS])


@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("kind,fam", _CASES)
def test_plain_matches_pallas_kernel(kind, fam, shape):
    xs = _inputs(kind, shape, 0, np.float32)
    f = _filters(kind, fam)
    want = getattr(pallas_hw, kind + "_hw22")(*(jnp.asarray(x) for x in xs),
                                               *f)
    assert want is not None
    if kind in ("filter", "dfilt"):
        want = [want[j][k] for j, k in _PAIRS]
    else:
        want = [want]
    got = _port(kind, xs, f)
    assert all(g.dtype == torch.float32 for g in got)
    for g, w in zip(got, want):
        assert _err(g, w) < TOL


@pytest.mark.parametrize("shape", _SHAPES + _ODD_SHAPES)
@pytest.mark.parametrize("kind,fam", _CASES)
def test_plain_matches_jax_fb_f64(kind, fam, shape):
    xs = _inputs(kind, shape, 1)
    f = _filters(kind, fam)
    for g, w in zip(_port(kind, xs, f), _jax_composed(kind, xs, f)):
        assert _err(g, w) < TOL64


def test_bf16_plain_runs_at_f32_and_stores_bf16():
    q = qshift("qshift_a")
    p = ((q[3], q[2]), (q[7], q[6]))
    vs = [torch.from_numpy(x).to(torch.bfloat16)
          for x in _inputs("ifilt_sum", (2, 8, 12), 2)]
    y = hw.ifilt_sum_hw22(*vs, *p)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (2, 16, 24)
    assert torch.equal(y, hw.ifilt_sum_hw22(*(v.float() for v in vs),
                                            *p).to(torch.bfloat16))


def test_contracts_raise():
    b, q = biort("near_sym_a"), qshift("qshift_a")
    haar = np.array([1.0, 1.0]) / np.sqrt(2.0)
    x = torch.zeros(2, 8, 12, dtype=torch.float64)
    with pytest.raises(ValueError, match="odd-length"):
        hw.filter_hw22(x, haar, haar)
    with pytest.raises(ValueError, match="odd-length"):
        hw.filter_sum_hw22(x, x, x, x, b[1], haar)
    with pytest.raises(ValueError, match="multiples of 4"):
        hw.dfilt_hw22(x[:, :6], (q[1], q[0]), (q[5], q[4]))
    with pytest.raises(ValueError, match="multiples of 2"):
        hw.ifilt_sum_hw22(*[x[:, :7]] * 4, (q[3], q[2]), (q[7], q[6]))
    with pytest.raises(ValueError, match="one length"):
        hw.dfilt_hw22(x, (q[1], q[0]), (q[5][:8], q[4][:8]))
    with pytest.raises(ValueError, match="one shape"):
        hw.filter_sum_hw22(x, x, x, x[:, :4], b[1], b[3])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        hw.filter_hw22(torch.zeros(2, 8, 8, device="meta"), b[0], b[2])
