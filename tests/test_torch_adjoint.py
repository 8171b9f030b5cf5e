"""The port's explicit adjoints (``dtcwt_tpu_torch.ops.adjoint``) on the CPU,
float64: each function against ``torch.func.vjp`` of its primal's plain
version and against its counterpart in ``dtcwt_tpu.ops.adjoint`` (XLA
engine) at 1e-12 relative to the largest value; the border fold down to
signals of ``len(h) // 2`` samples and its refusal below that; and the
qshift families' transpose check.  Inputs are made with numpy from a seed.

Complex band gradients: dtcwt_tpu's level-1 adjoint functions already take
and give them as PyTorch does (``dL/dRe + i dL/dIm``); its transforms
conjugate around them into JAX's cotangent convention.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dtcwt_tpu.ops import adjoint as jadj
from dtcwt_tpu.ops import engine
import dtcwt_tpu_torch as tdt
from dtcwt_tpu_torch.ops import adjoint, fb, ilevel1, level1

TOL = 1e-12
BIORTS = ["legall", "near_sym_a", "antonini", "near_sym_b"]


@pytest.fixture(autouse=True)
def _xla_engine():
    with engine.engine("xla"):
        yield


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape)


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax(fn, arrays, *consts):
    """dtcwt_tpu's *fn* of the numpy *arrays* and the Python constants
    *consts* (filters, axis), compiled as one program."""
    return jax.jit(lambda *a: fn(*a, *consts))(*map(jnp.asarray, arrays))


def _vjp(f, primals, cots):
    """torch.func.vjp of *f* at zero primals of the given shapes."""
    zeros = [torch.zeros(s, dtype=torch.float64) for s in primals]
    return torch.func.vjp(f, *zeros)[1](cots)


# (shape, axis): every axis of a volume, and axes whose length is the
# shortest the fold takes for near_sym_b's 19 taps (9) and 13 taps (6)
_CASES = [((6, 10, 12), -1), ((6, 10, 12), -2), ((10, 9, 4), -3),
          ((3, 9), -1), ((21, 2), 0)]


@pytest.mark.parametrize("fam", BIORTS)
@pytest.mark.parametrize("shape,axis", _CASES)
def test_filter_adjoints_match_vjp_and_jax(fam, shape, axis):
    """filter_adj_axis, filter2_sum_adj_axis and filter2_adj_axis against
    the vjp of fb.filter_axis / filter2_axis / filter2_sum_axis and against
    dtcwt_tpu's three adjoints, analysis and synthesis filters."""
    b = tdt.biort(fam)
    ya, yb = _rand(shape, 1), _rand(shape, 2)
    ta, tb = torch.from_numpy(ya), torch.from_numpy(yb)
    for h0, h1 in ((b[0], b[2]), (b[1], b[3])):
        got = adjoint.filter_adj_axis(ta, h0, axis)
        (want,) = _vjp(lambda x: fb.filter_axis(x, h0, axis), [shape], ta)
        assert _rel(got, want) < TOL
        assert _rel(got, _jax(jadj.filter_adj_axis, [ya], h0, axis)) < TOL
        got = adjoint.filter2_sum_adj_axis(ta, tb, h0, h1, axis)
        (want,) = _vjp(lambda x: fb.filter2_axis(x, h0, h1, axis), [shape],
                       (ta, tb))
        assert _rel(got, want) < TOL
        assert _rel(got, _jax(jadj.filter2_sum_adj_axis, [ya, yb], h0, h1,
                              axis)) < TOL
        got = adjoint.filter2_adj_axis(ta, h0, h1, axis)
        want = _vjp(lambda a, c: fb.filter2_sum_axis(a, c, h0, h1, axis),
                    [shape, shape], ta)
        jwant = _jax(jadj.filter2_adj_axis, [ya], h0, h1, axis)
        for g, w, j in zip(got, want, jwant):
            assert _rel(g, w) < TOL
            assert _rel(g, j) < TOL


def _bands(shape, seed, planes):
    """Random level-1 band gradients of a [..., h, w] grid: complex
    [..., h, w, 6] or (re, im) planes [..., 6, h, w]."""
    if planes:
        ph = shape[:-2] + (6,) + shape[-2:]
        return (torch.from_numpy(_rand(ph, seed)),
                torch.from_numpy(_rand(ph, seed + 1)))
    hw = shape + (6,)
    return torch.complex(torch.from_numpy(_rand(hw, seed)),
                         torch.from_numpy(_rand(hw, seed + 1)))


def _interleaved(bands):
    """The complex band-minor form of a band gradient."""
    if not isinstance(bands, tuple):
        return bands
    z = torch.complex(*bands)
    return torch.stack([z[..., tdt.PLANE_BAND_ORDER.index(d), :, :]
                        for d in range(6)], dim=-1)


@pytest.mark.parametrize("fam", ["near_sym_a", "near_sym_b"])
@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("shape", [(2, 12, 20), (18, 10)])
def test_level1_fwd_adj_matches_vjp_and_jax(fam, planes, shape):
    """level1_fwd_adj (and level1_fwd_adj_quads under it) against the vjp
    of level1.fwd_level1_reference in both layouts, and against
    dtcwt_tpu's level1_fwd_adj on the complex bands."""
    b = tdt.biort(fam)
    glow = torch.from_numpy(_rand(shape, 3))
    ybar = _bands(shape[:-2] + (shape[-2] // 2, shape[-1] // 2), 4, planes)
    got = adjoint.level1_fwd_adj(glow, ybar, b[0], b[2])
    (want,) = _vjp(lambda x: level1.fwd_level1_reference(x, b[0], b[2],
                                                         planes),
                   [shape], (glow, ybar))
    assert _rel(got, want) < TOL
    assert _rel(got, _jax(jadj.level1_fwd_adj, [glow.numpy(), _interleaved(
        ybar).numpy()], b[0], b[2])) < TOL


@pytest.mark.parametrize("fam", ["near_sym_a", "near_sym_b"])
@pytest.mark.parametrize("planes", [False, True])
@pytest.mark.parametrize("shape", [(2, 12, 20), (18, 10)])
def test_level1_inv_adj_matches_vjp_and_jax(fam, planes, shape):
    """level1_inv_adj against the vjp of ilevel1.inv_level1_reference in
    both layouts, and against dtcwt_tpu's level1_inv_adj."""
    b = tdt.biort(fam)
    xbar = torch.from_numpy(_rand(shape, 5))
    z, ybar = adjoint.level1_inv_adj(xbar, b[1], b[3], planes)
    bshape = shape[:-2] + (shape[-2] // 2, shape[-1] // 2)
    key = "bands" if planes else "yh"
    zeros = _bands(bshape, 0, planes)
    zeros = tuple(0 * a for a in zeros) if planes else 0 * zeros
    _, vjp = torch.func.vjp(
        lambda lo, bands: ilevel1.inv_level1_reference(
            lo, g0o=b[1], g1o=b[3], **{key: bands}),
        torch.zeros(shape, dtype=torch.float64), zeros)
    want_z, want_b = vjp(xbar)
    assert _rel(z, want_z) < TOL
    if planes:
        assert max(_rel(g, w) for g, w in zip(ybar, want_b)) < TOL
    else:
        assert _rel(torch.view_as_real(ybar), torch.view_as_real(want_b)) \
            < TOL
    jz, jb = _jax(jadj.level1_inv_adj, [xbar.numpy()], b[1], b[3])
    assert _rel(z, jz) < TOL
    assert _rel(_interleaved(ybar), jb) < TOL


@pytest.mark.parametrize("n", [8, 5, 1])
def test_fold_refuses_signals_shorter_than_its_border(n):
    """near_sym_b's 19-tap filter folds a 9-sample border: a shorter
    signal raises ValueError instead of folding wrongly (the transforms
    keep such shapes off the explicit route)."""
    h = tdt.biort("near_sym_b")[2]
    with pytest.raises(ValueError, match="border fold"):
        adjoint.filter_adj_axis(torch.zeros(n, 3, dtype=torch.float64), h, 0)


def test_adjoints_refuse_even_filters():
    """The level-1 adjoints hold only for odd-length filters."""
    y = torch.zeros(8, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="odd-length"):
        adjoint.filter_adj_axis(y, np.ones(4) / 4, -1)


def _orthogonality(qshift) -> float:
    """``||A^T A - I||``, the max norm, of one 1-D qshift analysis level
    (both branches' ``dfilt`` with its symmetric extension) at the lengths
    ``adjoint.qshift_adjoint_error`` checks."""
    h0a, h0b, _, _, h1a, h1b, _, _ = (np.asarray(v) for v in qshift)
    err = 0.0
    for n in range(4, 4 * -(-3 * h0a.size // 4) + 1, 4):
        eye = torch.eye(n, dtype=torch.float64)
        A = torch.cat([fb.dfilt_axis(eye, h0b, h0a, 0),
                       fb.dfilt_axis(eye, h1b, h1a, 0)])
        err = max(err, float((A.T @ A - eye).abs().max()))
    return err


@pytest.mark.parametrize("fam", tdt.QSHIFT_NAMES)
def test_published_qshift_families_pass_the_transpose_check(fam):
    """Every published qshift family's synthesis level is the transpose of
    its analysis level within QSHIFT_ADJOINT_TOL (its first 8 filters:
    the bandpass pair is not part of the check).  The gate is not the
    orthogonality ||A^T A - I||: that is 2.2e-16 to 4.4e-16 for all but
    qshift_32 (1.5e-9), whose explicit adjoint is exact all the same."""
    q = tdt.qshift(fam)[:8]
    assert adjoint.qshift_adjoint_error(q) <= adjoint.QSHIFT_ADJOINT_TOL
    assert adjoint.explicit_route(tdt.biort("near_sym_a"), q, torch.float32)
    assert _orthogonality(q) < (1e-8 if fam == "qshift_32" else 1e-15)


def test_perturbed_qshift_fails_the_transpose_check():
    """An 8-tuple whose analysis filters no longer match its synthesis
    filters, or whose lengths differ, fails the check."""
    q = [np.array(v) for v in tdt.qshift("qshift_a")]
    q[0] = q[0] * (1 + 1e-6)
    assert adjoint.qshift_adjoint_error(q) > adjoint.QSHIFT_ADJOINT_TOL
    q = [np.array(v) for v in tdt.qshift("qshift_a")]
    q[2] = np.append(q[2], 0.0)
    assert adjoint.qshift_adjoint_error(q) == float("inf")
