"""Gradients of the port's 3-D transform through ``ops.linearize`` on the
CPU, float64, against ``jax.vjp`` of ``dtcwt_tpu.Transform3d`` (XLA engine)
at 1e-12 relative to each leaf's largest value, as
``tests/test_torch_grad.py`` does for the 1-D and 2-D transforms (whose
helpers these tests share): the explicit adjoints, the plain route, and
the envelope between them.
"""

import numpy as np
import pytest
import torch

import dtcwt_tpu as jdt
from dtcwt_tpu.ops import engine
import dtcwt_tpu_torch as tdt
from tests.test_torch_grad import (
    FAMS, _fwd_check, _inv_check, _pyramids, _rand)


@pytest.fixture(autouse=True)
def _xla_engine():
    with engine.engine("xla"):
        yield


# --- Transform3d ------------------------------------------------------------

# every level count, both layouts and both families, without the whole
# product: JAX compiles each 3-D vjp for 5-20 s
_CASES_3D = [(FAMS[0], 1, "planes"), (FAMS[0], 2, "interleaved"),
             (FAMS[0], 3, "interleaved"), (FAMS[0], 3, "planes"),
             (FAMS[1], 1, "interleaved"), (FAMS[1], 2, "planes")]


@pytest.mark.parametrize("fams,nlevels,layout", _CASES_3D)
def test_transform3d_grads_match_jax(fams, nlevels, layout):
    """Forward and inverse gradients through the explicit adjoints."""
    t, jt = tdt.Transform3d(*fams, device="cpu"), jdt.Transform3d(*fams)
    planes = layout == "planes"
    # crop-free; near_sym_b's 19 taps fold a 9-sample border
    shape = (8, 16, 8) if fams[0] == "near_sym_a" else (16, 16, 16)
    x = _rand(shape, 21)
    assert t._fwd_adjoint_fn(shape, torch.float64, nlevels, False, False,
                             planes) is not None
    _fwd_check(t, lambda a: jt._forward_impl(
        a, nlevels=nlevels, include_scale=False, discard_level_1=False,
        layout=layout), x,
        lambda tt, a: tt.forward(a, nlevels, layout=layout))
    p = t.forward(torch.from_numpy(x), nlevels, layout=layout)
    pyr, jpyr = _pyramids(p, planes, "3d", 22)
    assert t._inv_adjoint_fn(pyr) is not None
    _inv_check(t.inverse, jt._inverse_impl, pyr, jpyr)


@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_transform3d_plain_route_grads_match_jax(layout):
    """discard_level_1 (a None level) and a pad in the chain take the plain
    route, with JAX's gradients."""
    t, jt = tdt.Transform3d(device="cpu"), jdt.Transform3d()
    planes = layout == "planes"
    x = _rand((12, 8, 16), 23)
    assert t._fwd_adjoint_fn(x.shape, torch.float64, 2, False, True,
                             planes) is None
    _fwd_check(t, lambda a: jt._forward_impl(
        a, nlevels=2, include_scale=False, discard_level_1=True,
        layout=layout), x,
        lambda tt, a: tt.forward(a, 2, discard_level_1=True, layout=layout))
    p = t.forward(torch.from_numpy(x), 2, discard_level_1=True,
                  layout=layout)
    pyr, jpyr = _pyramids(p, planes, "3d", 24)
    if planes:
        # the discarded level: one None in each plane tuple
        pyr = tdt.PlanePyramid(pyr.lowpass, (None,) + pyr.highpasses_re,
                               (None,) + pyr.highpasses_im, kind="3d")
        jpyr = jdt.PlanePyramid(jpyr.lowpass, (None,) + jpyr.highpasses_re,
                                (None,) + jpyr.highpasses_im, None,
                                kind="3d")
    else:
        pyr = tdt.Pyramid(pyr.lowpass, (None,) + pyr.highpasses)
        jpyr = jdt.Pyramid(jpyr.lowpass, (None,) + jpyr.highpasses)
    assert t._inv_adjoint_fn(pyr) is None
    _inv_check(t.inverse, jt._inverse_impl, pyr, jpyr)


def test_transform3d_route_choice():
    """The 3-D envelope: JAX's (_adjoint_shapes_ok in both ext_modes, no
    discard_level_1, no include_scale, odd biort) plus the border fold and
    the qshift transpose check."""
    fwd = lambda t, shape, nlevels=2, **kw: t._fwd_adjoint_fn(
        shape, kw.get("dtype", torch.float32), nlevels, kw.get("scale", False),
        kw.get("discard", False), False)
    t = tdt.Transform3d(device="cpu")
    assert fwd(t, (16, 16, 16)) is not None
    assert fwd(t, (16, 16, 16), dtype=torch.float64) is not None
    assert fwd(t, (16, 16, 16), dtype=torch.bfloat16) is None
    assert fwd(t, (16, 16, 16), scale=True) is None
    assert fwd(t, (16, 16, 16), discard=True) is None
    assert fwd(t, (16, 12, 16)) is not None
    assert fwd(t, (16, 12, 16), nlevels=3) is None
    t8 = tdt.Transform3d(ext_mode=8, device="cpu")
    assert fwd(t8, (8, 8, 8)) is not None
    assert fwd(t8, (8, 8, 8), nlevels=3) is None
    assert fwd(tdt.Transform3d("near_sym_b", device="cpu"), (4, 4, 4),
               nlevels=1) is None
    even = tuple(np.array(v) for v in ([1, 3, 3, 1], [1, 3, 3, 1],
                                       [-1, 3, -3, 1], [1, -3, 3, -1]))
    assert fwd(tdt.Transform3d(even, device="cpu"), (16, 16, 16)) is None
