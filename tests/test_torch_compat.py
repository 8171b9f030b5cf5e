"""The port's MATLAB-style API (``compat``), backend stack
(``compat_backend``) and package exports against the JAX package's.

The eight ``compat`` entries run with ``device="cpu"`` (the plain path) and
match ``dtcwt_tpu.compat`` (XLA engine, float64) at 1e-12 on every output,
including ``dtwavexfm3(discard_level_1=True)`` -> ``dtwaveifm3`` and a
bandpass family through ``dtwavexfm2b``.  The backend stack behaves as the
JAX package's step by step; its base entry names the port's backend,
``"torch"``.  Inputs are made with numpy from a seed and fed to both
packages.
"""

import numpy as np
import pytest
import torch

import dtcwt_tpu as jdt
from dtcwt_tpu import compat as jcompat
from dtcwt_tpu import compat_backend as jback
from dtcwt_tpu.ops import engine
import dtcwt_tpu_torch as tdt
from dtcwt_tpu_torch import compat, compat_backend

TOL = 1e-12


@pytest.fixture(autouse=True)
def _xla_engine():
    with engine.engine("xla"):
        yield


def _err(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.complex128) - want).max())


def _same(got, want):
    """Two compat outputs: an array, or a tuple of arrays and None."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif want is None:
        assert got is None
    else:
        assert _err(got, want) < TOL


def _rand(shape, seed):
    return np.random.RandomState(seed).rand(*shape)


_CASES = {
    "1d": (compat.dtwavexfm, compat.dtwaveifm, jcompat.dtwavexfm,
           jcompat.dtwaveifm, (64, 3), {"biort": "near_sym_b",
                                        "qshift": "qshift_d"}, {}),
    "2d": (compat.dtwavexfm2, compat.dtwaveifm2, jcompat.dtwavexfm2,
           jcompat.dtwaveifm2, (37, 50), {}, {}),
    "2d bandpass": (compat.dtwavexfm2b, compat.dtwaveifm2b,
                    jcompat.dtwavexfm2b, jcompat.dtwaveifm2b, (32, 40),
                    {"biort": "near_sym_b_bp", "qshift": "qshift_b_bp"}, {}),
    "3d": (compat.dtwavexfm3, compat.dtwaveifm3, jcompat.dtwavexfm3,
           jcompat.dtwaveifm3, (16, 20, 24), {"ext_mode": 8}, {}),
    "3d discard_level_1": (compat.dtwavexfm3, compat.dtwaveifm3,
                           jcompat.dtwavexfm3, jcompat.dtwaveifm3,
                           (16, 16, 20), {}, {"discard_level_1": True}),
}


@pytest.mark.parametrize("include_scale", [False, True])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_compat_round_trip_matches_jax(case, include_scale):
    xfm, ifm, jxfm, jifm, shape, fams, fwd_only = _CASES[case]
    x = _rand(shape, len(case))
    got = xfm(x, 3, include_scale=include_scale, device="cpu", **fams,
              **fwd_only)
    want = jxfm(x, 3, include_scale=include_scale, **fams, **fwd_only)
    assert len(got) == (3 if include_scale else 2)
    _same(got, want)
    if fwd_only:
        assert got[1][0] is None
    _same(ifm(got[0], got[1], device="cpu", **fams),
          jifm(want[0], want[1], **fams))


def test_compat_gain_mask_matches_jax():
    x = _rand((32, 36), 3)
    gm = np.random.RandomState(4).rand(6, 3)
    yl, yh = compat.dtwavexfm2(x, 3, device="cpu")
    jl, jh = jcompat.dtwavexfm2(x, 3)
    _same(compat.dtwaveifm2(yl, yh, gain_mask=gm, device="cpu"),
          jcompat.dtwaveifm2(jl, jh, gain_mask=gm))
    bp = {"biort": "near_sym_b_bp", "qshift": "qshift_b_bp"}
    yl, yh = compat.dtwavexfm2b(x, 3, device="cpu", **bp)
    jl, jh = jcompat.dtwavexfm2b(x, 3, **bp)
    _same(compat.dtwaveifm2b(yl, yh, gain_mask=gm, device="cpu", **bp),
          jcompat.dtwaveifm2b(jl, jh, gain_mask=gm, **bp))
    s = _rand((64, 2), 5)
    gm1 = np.random.RandomState(6).rand(3)
    yl, yh = compat.dtwavexfm(s, 3, device="cpu")
    jl, jh = jcompat.dtwavexfm(s, 3)
    _same(compat.dtwaveifm(yl, yh, gain_mask=gm1, device="cpu"),
          jcompat.dtwaveifm(jl, jh, gain_mask=gm1))


def test_compat_names_and_bandpass_aliases():
    assert compat.__all__ == jcompat.__all__
    assert compat.dtwavexfm2b is compat.dtwavexfm2
    assert compat.dtwaveifm2b is compat.dtwaveifm2


def test_compat_runs_on_the_card_unless_asked_for_the_cpu():
    """The default device is CUDA: without a card the call raises instead
    of running on the CPU."""
    if torch.cuda.is_available():
        yl, _ = compat.dtwavexfm2(_rand((16, 16), 7), 2)
        assert yl.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            compat.dtwavexfm2(_rand((16, 16), 7), 2)


# --- the backend stack and the package exports ------------------------------

def _stack_trace(mod, pkg):
    """Drive one package's backend stack through every rule and record
    what it does: names seen and errors raised."""
    seen = []

    def name():
        assert pkg.backend_name == mod.backend_name()
        return "base" if mod.backend_name() == mod._STACK[0] else \
            mod.backend_name()

    with mod.preserve_backend_stack():
        seen.append(name())
        pkg.push_backend("numpy")
        seen.append(name())
        pkg.push_backend("opencl")
        seen.append(name())
        with pytest.raises(KeyError) as e:
            pkg.push_backend("cuda-ish")
        seen.append(str(e.value))
        pkg.pop_backend()
        seen.append(name())
        try:
            with pkg.preserve_backend_stack():
                pkg.push_backend("tf")
                seen.append(name())
                raise RuntimeError("body fails")
        except RuntimeError:
            pass
        seen.append(name())
        pkg.pop_backend()
        with pytest.raises(IndexError) as e:
            pkg.pop_backend()
        seen.append(str(e.value))
        seen.append(name())
    seen.append(name())
    return seen


def test_backend_stack_matches_jax():
    assert _stack_trace(compat_backend, tdt) == _stack_trace(jback, jdt)
    assert tdt.backend_name == compat_backend.backend_name() == "torch"
    assert set(compat_backend.KNOWN_BACKENDS) - {"torch"} == set(
        jback.KNOWN_BACKENDS) - {"tpu"}


def test_exports_match_jax():
    """Every name ``dtcwt_tpu`` exports, the port exports; only the base
    backend's name differs."""
    assert sorted(tdt.__all__) == sorted(jdt.__all__)
    for name in tdt.__all__:
        assert hasattr(tdt, name), name
    assert tdt.__version__ == jdt.__version__
    assert tdt.BIORT_NAMES == jdt.BIORT_NAMES
    assert tdt.QSHIFT_NAMES == jdt.QSHIFT_NAMES
    assert tdt.PLANE_BAND_ORDER == tuple(jdt.PLANE_BAND_ORDER)
    assert (tdt.backend_name, jdt.backend_name) == ("torch", "tpu")
