"""The CUDA kernels of the port against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a GPU.

This file imports neither JAX nor the JAX package, so that it runs on a GPU
machine that has only PyTorch.  ``tests/conftest.py`` imports JAX, so run it
there with::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances, relative to the largest reference value: float32 1e-5 (the sums
run in another order), bfloat16 1e-2 (one bfloat16 step of the stored
outputs), float64 1e-12 (a check of every index and parity rule).
"""

import numpy as np
import pytest
import torch

import dtcwt_tpu_torch as dt
from dtcwt_tpu_torch.coeffs import biort, qshift
from dtcwt_tpu_torch.ops import _build, ilevel1, ilevel2, level1, level2
from dtcwt_tpu_torch.transforms.pyramid import PLANE_BAND_ORDER

_KTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float64: 1e-12}
_CASES = [(torch.float64, False), (torch.float64, True),
          (torch.float32, False), (torch.float32, True),
          (torch.bfloat16, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _kerr(got, want):
    if isinstance(got, tuple):
        return max(_kerr(g, w) for g, w in zip(got, want))
    g = torch.view_as_real(got) if got.is_complex() else got
    w = torch.view_as_real(want) if want.is_complex() else want
    scale = float(w.double().abs().max().clamp_min(1e-30))
    return float((g.double() - w.double()).abs().max()) / scale


def _planes(yh):
    z = torch.stack([yh[..., d] for d in PLANE_BAND_ORDER], dim=-3)
    return z.real.contiguous(), z.imag.contiguous()


def _rand(shape, seed, device, dtype):
    return torch.from_numpy(np.random.RandomState(seed).rand(*shape)).to(
        device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,planes", _CASES)
@pytest.mark.parametrize("fam", ["near_sym_a", "near_sym_b", "legall"])
def test_cuda_level1_matches_plain(cuda, dtype, planes, fam):
    h0o, _, h1o, _ = biort(fam)
    for shape in [(2, 36, 52), (2, 4, 6), (130, 200)]:
        x = _rand(shape, 0, cuda, dtype)
        got = level1.fwd_level1(x, h0o, h1o, planes=planes)
        torch.cuda.synchronize()
        want = level1.fwd_level1_reference(x, h0o, h1o, planes=planes)
        assert _kerr(got[0], want[0]) < _KTOL[dtype]
        assert _kerr(got[1], want[1]) < _KTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,planes", _CASES)
@pytest.mark.parametrize("fam", ["qshift_a", "qshift_d", "qshift_32"])
def test_cuda_level2_matches_plain(cuda, dtype, planes, fam):
    q = qshift(fam)
    for shape in [(2, 40, 56), (2, 8, 12), (132, 260)]:
        x = _rand(shape, 0, cuda, dtype)
        got = level2.fwd_level2(x, q[0], q[1], q[4], q[5], planes=planes)
        torch.cuda.synchronize()
        want = level2.fwd_level2_reference(x, q[0], q[1], q[4], q[5],
                                           planes=planes)
        assert _kerr(got[0], want[0]) < _KTOL[dtype]
        assert _kerr(got[1], want[1]) < _KTOL[dtype]


def _inverse_inputs(shape, dtype, planes, device):
    rng = np.random.RandomState(1)
    Z = torch.from_numpy(rng.rand(*shape)).to(device, dtype)
    hw = shape[:-2] + (shape[-2] // 2, shape[-1] // 2, 6)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    yh = torch.complex(torch.from_numpy(rng.rand(*hw)),
                       torch.from_numpy(rng.rand(*hw))).to(device, cdt)
    if planes:
        re, im = _planes(yh)
        return Z, {"bands": (re.to(dtype), im.to(dtype))}
    return Z, {"yh": yh}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,planes", _CASES)
@pytest.mark.parametrize("fam", ["qshift_a", "qshift_d", "qshift_32"])
def test_cuda_ilevel2_matches_plain(cuda, dtype, planes, fam):
    q = qshift(fam)
    for shape in [(2, 20, 28), (2, 4, 6), (66, 130)]:
        Z, band = _inverse_inputs(shape, dtype, planes, cuda)
        got = ilevel2.inv_level2(Z, g0a=q[2], g0b=q[3], g1a=q[6], g1b=q[7],
                                 **band)
        torch.cuda.synchronize()
        want = ilevel2.inv_level2_reference(Z, g0a=q[2], g0b=q[3], g1a=q[6],
                                            g1b=q[7], **band)
        assert _kerr(got, want) < _KTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,planes", _CASES)
@pytest.mark.parametrize("fam", ["near_sym_a", "near_sym_b", "antonini"])
def test_cuda_ilevel1_matches_plain(cuda, dtype, planes, fam):
    b = biort(fam)
    for shape in [(2, 36, 52), (2, 4, 6), (130, 200)]:
        Z, band = _inverse_inputs(shape, dtype, planes, cuda)
        got = ilevel1.inv_level1(Z, g0o=b[1], g1o=b[3], **band)
        torch.cuda.synchronize()
        want = ilevel1.inv_level1_reference(Z, g0o=b[1], g1o=b[3], **band)
        assert _kerr(got, want) < _KTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_cuda_transform_matches_plain_path(cuda, layout):
    """The whole transform on the card (kernels) against the same transform
    on the CPU (plain versions) at float64, odd sizes, pad and crop, and
    the launch counts of a 3-level round trip."""
    t = dt.Transform2d("near_sym_b", "qshift_b")
    x = np.random.RandomState(2).rand(3, 75, 98)
    _build.reset_launches()
    pg = t.forward(torch.from_numpy(x).to(cuda), 3, layout=layout)
    rg = t.inverse(pg)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"level1": 1, "level2": 2, "ilevel2": 2,
                                     "ilevel1": 1}
    pc = t.forward(torch.from_numpy(x), 3, layout=layout)
    rc = t.inverse(pc)
    assert _kerr(rg.cpu(), rc) < 1e-12
    assert _kerr(pg.lowpass.cpu(), pc.lowpass) < 1e-12
    hg = pg.highpasses if layout == "interleaved" else pg.highpasses_re
    hc = pc.highpasses if layout == "interleaved" else pc.highpasses_re
    for a, b in zip(hg, hc):
        assert _kerr(a.cpu(), b) < 1e-12


@pytest.mark.cuda
def test_cuda_bandpass_families_raise(cuda):
    t = dt.Transform2d("near_sym_b_bp", "qshift_b_bp")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t.forward(torch.zeros(16, 16, device=cuda), 2)
