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
from dtcwt_tpu_torch.ops import (
    _build, dual, fb, hw, ilevel1, ilevel2, level1, level2, longfir, pack3d,
    single)
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


# fwd_level1's tiles are 32 or 64 rows by 128 columns: shapes that cross
# tile edges both ways, tall and wide images, rows too short or odd for
# its vector stores (C = 6, 202, 518, 4098), images shorter than the filters
_L1_SHAPES = [(2, 36, 52), (2, 4, 6), (130, 200), (4100, 4098),
              (3, 130, 200), (4096, 2), (2, 4096), (2, 38, 6), (6, 202),
              (4, 518)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,planes", _CASES)
@pytest.mark.parametrize("fam", ["near_sym_a", "near_sym_b", "legall"])
def test_cuda_level1_matches_plain(cuda, dtype, planes, fam):
    h0o, _, h1o, _ = biort(fam)
    for shape in _L1_SHAPES:
        x = _rand(shape, 0, cuda, dtype)
        _build.reset_launches()
        got = level1.fwd_level1(x, h0o, h1o, planes=planes)
        torch.cuda.synchronize()
        assert dict(_build.launches) == {"level1": 1}
        want = level1.fwd_level1_reference(x, h0o, h1o, planes=planes)
        assert _kerr(got[0], want[0]) < _KTOL[dtype], shape
        assert _kerr(got[1], want[1]) < _KTOL[dtype], shape


# fwd_level2's tiles are 4, 8 or 16 quad rows by 64 quads: shapes that
# cross tile edges both ways, tall and wide images, rows too short or odd
# for its vector stores (C / 2 not a multiple of 4, C / 4 odd: C = 12, 260,
# 1036), images shorter than the filters (8 x 12 with qshift_32), a batch
_L2_SHAPES = [(2, 40, 56), (2, 8, 12), (132, 260), (3, 132, 264),
              (4100, 8), (8, 4100), (1032, 1036), (2, 76, 264)]


def _forward_cases(shape, dtype, device):
    """The input of a forward level at *shape*: as allocated and, at (132,
    260), at a storage offset (no 16-byte alignment)."""
    x = _rand(shape, 0, device, dtype)
    return [x, _at_offset(x)] if shape == (132, 260) else [x]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,planes", _CASES)
@pytest.mark.parametrize("fam", ["qshift_a", "qshift_b", "qshift_d",
                                 "qshift_32"])
def test_cuda_level2_matches_plain(cuda, dtype, planes, fam):
    q = qshift(fam)
    for shape in _L2_SHAPES:
        for x in _forward_cases(shape, dtype, cuda):
            _build.reset_launches()
            got = level2.fwd_level2(x, q[0], q[1], q[4], q[5], planes=planes)
            torch.cuda.synchronize()
            assert dict(_build.launches) == {"level2": 1}
            want = level2.fwd_level2_reference(x, q[0], q[1], q[4], q[5],
                                               planes=planes)
            assert _kerr(got[0], want[0]) < _KTOL[dtype], shape
            assert _kerr(got[1], want[1]) < _KTOL[dtype], shape


@pytest.mark.cuda
@pytest.mark.parametrize("qh", [4, 8, 16])
def test_cuda_level2_tile_heights(cuda, qh):
    """Every tile height the kernel takes (the geometry picks 8 or 4), f32
    in both layouts and the third stream, against the plain version."""
    geometry = level2._level2_geometry

    def forced(*a, **k):
        return geometry(*a, **dict(k, qh=qh))
    q, bp = qshift("qshift_a"), qshift("qshift_b_bp")
    level2._level2_geometry = forced
    try:
        for shape in [(2, 76, 264), (132, 260), (1032, 1036)]:
            x = _rand(shape, 0, cuda, torch.float32)
            for planes in (False, True):
                for f, kw in (((q[0], q[1], q[4], q[5]), {}),
                              ((bp[0], bp[1], bp[4], bp[5]),
                               {"h2a": bp[8], "h2b": bp[9]})):
                    got = level2.fwd_level2(x, *f, planes, **kw)
                    torch.cuda.synchronize()
                    want = level2.fwd_level2_reference(x, *f, planes, **kw)
                    assert _kerr(got, want) < _KTOL[torch.float32], shape
    finally:
        level2._level2_geometry = geometry


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


# inv_level2's tiles are 4, 8 or 16 band rows by 32 band columns (lowpass
# tiles of 8, 16 or 32 rows by 64 columns): shapes that cross tile edges
# both ways, tall and wide images, a batch, images shorter than the filters
# (4 x 6 with qshift_32)
_IL2_SHAPES = [(2, 20, 28), (2, 4, 6), (66, 130), (3, 66, 132), (2050, 4),
               (4, 2050), (2, 38, 134), (516, 518)]


def _ilevel2_cases(shape, dtype, planes, device):
    """The inputs of a qshift inverse level at *shape*: as allocated and,
    at (66, 130), with the lowpass and the subbands at a storage offset."""
    Z, band = _inverse_inputs(shape, dtype, planes, device)
    yield Z, band
    if shape == (66, 130):
        yield _at_offset(Z), {k: _at_offset(v) for k, v in band.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,planes", _CASES)
@pytest.mark.parametrize("fam", ["qshift_a", "qshift_c", "qshift_b_bp"])
def test_cuda_ilevel2_edge_shapes_match_plain(cuda, dtype, planes, fam):
    """inv_level2 at shapes that cross its tiles both ways, rows too short
    for a row item, images shorter than the filters, and with its inputs at
    a storage offset, one launch each: qshift_a (the tap bound 5), qshift_c
    (m/2 even) and qshift_b_bp (the third stream)."""
    q = qshift(fam)
    g = dict(g0a=q[2], g0b=q[3], g1a=q[6], g1b=q[7])
    if len(q) == 12:
        g.update(g2a=q[10], g2b=q[11])
    for shape in _IL2_SHAPES:
        for Z, band in _ilevel2_cases(shape, dtype, planes, cuda):
            _build.reset_launches()
            got = ilevel2.inv_level2(Z, **g, **band)
            torch.cuda.synchronize()
            assert dict(_build.launches) == {"ilevel2": 1}
            want = ilevel2.inv_level2_reference(Z, **g, **band)
            assert _kerr(got, want) < _KTOL[dtype], (shape, Z.data_ptr())


@pytest.mark.cuda
@pytest.mark.parametrize("qh", [4, 8])
def test_cuda_ilevel2_tile_heights(cuda, qh):
    """Every tile height the kernel takes, f32 in both layouts and the
    third stream, against the plain version."""
    geometry = ilevel2._ilevel2_geometry

    def forced(*a, **k):
        return geometry(*a, **dict(k, qh=qh))
    q, bp = qshift("qshift_a"), qshift("qshift_b_bp")
    ilevel2._ilevel2_geometry = forced
    try:
        for shape in [(2, 38, 134), (66, 130), (516, 518)]:
            for planes in (False, True):
                Z, band = _inverse_inputs(shape, torch.float32, planes, cuda)
                for g in (dict(g0a=q[2], g0b=q[3], g1a=q[6], g1b=q[7]),
                          dict(g0a=bp[2], g0b=bp[3], g1a=bp[6], g1b=bp[7],
                               g2a=bp[10], g2b=bp[11])):
                    got = ilevel2.inv_level2(Z, **g, **band)
                    torch.cuda.synchronize()
                    want = ilevel2.inv_level2_reference(Z, **g, **band)
                    assert _kerr(got, want) < _KTOL[torch.float32], shape
    finally:
        ilevel2._ilevel2_geometry = geometry


def _at_offset(t):
    """A copy of *t* (or of each tensor of a tuple) stored one element past
    the start of its buffer: a caller's tensor at a storage offset, no
    longer 16-byte aligned."""
    if isinstance(t, tuple):
        return tuple(_at_offset(u) for u in t)
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = buf[1:].view(t.shape)
    v.copy_(t)
    return v


def _inverse_cases(shape, dtype, planes, device):
    """The inputs of a level-1 inverse at *shape*: as allocated and, at
    (130, 200), with the lowpass and the subbands at a storage offset."""
    Z, band = _inverse_inputs(shape, dtype, planes, device)
    yield Z, band
    if shape == (130, 200):
        yield _at_offset(Z), {k: _at_offset(v) for k, v in band.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,planes", _CASES)
@pytest.mark.parametrize("fam", ["near_sym_a", "near_sym_b", "antonini"])
def test_cuda_ilevel1_matches_plain(cuda, dtype, planes, fam):
    """inv_level1 at the shapes of fwd_level1's tests (every tile kind, rows
    too short or odd for its 4-wide stores, images shorter than the
    filters), and with its inputs at a storage offset, one launch each."""
    b = biort(fam)
    for shape in _L1_SHAPES:
        for Z, band in _inverse_cases(shape, dtype, planes, cuda):
            _build.reset_launches()
            got = ilevel1.inv_level1(Z, g0o=b[1], g1o=b[3], **band)
            torch.cuda.synchronize()
            assert dict(_build.launches) == {"ilevel1": 1}
            want = ilevel1.inv_level1_reference(Z, g0o=b[1], g1o=b[3],
                                                **band)
            assert _kerr(got, want) < _KTOL[dtype], (shape, Z.data_ptr())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_cuda_transform_matches_plain_path(cuda, layout):
    """The whole transform on the card (kernels) against the same transform
    on the CPU (plain versions) at float64, odd sizes, pad and crop, and
    the launch counts of a 3-level round trip."""
    t = dt.Transform2d("near_sym_b", "qshift_b")
    x = np.random.RandomState(2).rand(3, 75, 98)
    _build.reset_launches()
    pg = t.forward(x, 3, layout=layout)
    rg = t.inverse(pg)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"level1": 1, "level2": 2, "ilevel2": 2,
                                     "ilevel1": 1}
    tc = dt.Transform2d("near_sym_b", "qshift_b", device="cpu")
    pc = tc.forward(torch.from_numpy(x), 3, layout=layout)
    rc = tc.inverse(pc)
    assert _kerr(rg.cpu(), rc) < 1e-12
    assert _kerr(pg.lowpass.cpu(), pc.lowpass) < 1e-12
    hg = pg.highpasses if layout == "interleaved" else pg.highpasses_re
    hc = pc.highpasses if layout == "interleaved" else pc.highpasses_re
    for a, b in zip(hg, hc):
        assert _kerr(a.cpu(), b) < 1e-12


# --- the bandpass third stream of the four level kernels --------------------

_BP_SHAPES = {"level1": _L1_SHAPES,
              "level2": _L2_SHAPES,
              "ilevel2": _IL2_SHAPES,
              "ilevel1": _L1_SHAPES}


def _bp_calls(level):
    """(kernel wrapper, plain version) of one level with near_sym_b_bp's or
    qshift_b_bp's third stream, both taking ``(x, planes)`` for a forward
    level and ``(z, band)`` for an inverse one."""
    b, q = biort("near_sym_b_bp"), qshift("qshift_b_bp")
    if level == "level1":
        k = lambda x, pl: level1.fwd_level1(x, b[0], b[2], pl, h2o=b[4])
        p = lambda x, pl: level1.fwd_level1_reference(x, b[0], b[2], pl,
                                                      h2o=b[4])
    elif level == "level2":
        f = (q[0], q[1], q[4], q[5])
        k = lambda x, pl: level2.fwd_level2(x, *f, pl, h2a=q[8], h2b=q[9])
        p = lambda x, pl: level2.fwd_level2_reference(x, *f, pl, h2a=q[8],
                                                      h2b=q[9])
    elif level == "ilevel2":
        g = dict(g0a=q[2], g0b=q[3], g1a=q[6], g1b=q[7], g2a=q[10],
                 g2b=q[11])
        k = lambda z, band: ilevel2.inv_level2(z, **g, **band)
        p = lambda z, band: ilevel2.inv_level2_reference(z, **g, **band)
    else:
        g = dict(g0o=b[1], g1o=b[3], g2o=b[5])
        k = lambda z, band: ilevel1.inv_level1(z, **g, **band)
        p = lambda z, band: ilevel1.inv_level1_reference(z, **g, **band)
    return k, p


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,planes", _CASES)
@pytest.mark.parametrize("level", ["level1", "level2", "ilevel2", "ilevel1"])
def test_cuda_bandpass_kernels_match_plain(cuda, dtype, planes, level):
    """Each level kernel's bandpass variant (near_sym_b_bp: 13/19/19 taps,
    qshift_b_bp: 14) against its plain version, at the shapes of the tests
    above, including shapes shorter than the filters (fwd_level2,
    inv_level2 and inv_level1: also their inputs at a storage offset)."""
    kern, plain = _bp_calls(level)
    for shape in _BP_SHAPES[level]:
        if level == "ilevel1":
            cases = _inverse_cases(shape, dtype, planes, cuda)
        elif level == "ilevel2":
            cases = _ilevel2_cases(shape, dtype, planes, cuda)
        elif level.startswith("i"):
            cases = [_inverse_inputs(shape, dtype, planes, cuda)]
        elif level == "level2":
            cases = [(x, planes)
                     for x in _forward_cases(shape, dtype, cuda)]
        else:
            cases = [(_rand(shape, 0, cuda, dtype), planes)]
        for args in cases:
            _build.reset_launches()
            got = kern(*args)
            torch.cuda.synchronize()
            assert dict(_build.launches) == {level: 1}
            assert _kerr(got, plain(*args)) < _KTOL[dtype], shape


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_cuda_bandpass_transform_matches_plain_path(cuda, layout):
    """The bandpass families through the whole transform on the card against
    the CPU at float64: odd sizes, pad and crop, include_scale, a gain
    mask, explicit 6/12-tuples, the launch counts of a 3-level round trip,
    the nhwc channel adapter and compat.dtwavexfm2b / dtwaveifm2b."""
    b = tuple(np.array(h) for h in biort("near_sym_b_bp"))
    q = tuple(np.array(h) for h in qshift("qshift_b_bp"))
    t, tc = dt.Transform2d(b, q), dt.Transform2d(b, q, device="cpu")
    x = np.random.RandomState(2).rand(3, 75, 98)
    gm = np.linspace(0.2, 1.4, 18).reshape(6, 3)
    _build.reset_launches()
    pg = t.forward(x, 3, include_scale=True, layout=layout)
    rg = t.inverse(pg, gm)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"level1": 1, "level2": 2, "ilevel2": 2,
                                     "ilevel1": 1}
    pc = tc.forward(torch.from_numpy(x), 3, include_scale=True,
                    layout=layout)
    assert _kerr(rg.cpu(), tc.inverse(pc, gm)) < 1e-12
    hg = pg.highpasses if layout == "interleaved" else \
        pg.highpasses_re + pg.highpasses_im
    hc = pc.highpasses if layout == "interleaved" else \
        pc.highpasses_re + pc.highpasses_im
    for a, c in zip((pg.lowpass,) + hg + pg.scales,
                    (pc.lowpass,) + hc + pc.scales):
        assert _kerr(a.cpu(), c) < 1e-12
    if layout == "planes":
        return
    from dtcwt_tpu_torch import compat
    fams = {"biort": "near_sym_b_bp", "qshift": "qshift_b_bp"}
    yl, yh = compat.dtwavexfm2b(x, 3, **fams)
    assert _kerr(yl.cpu(), pc.lowpass) < 1e-12
    assert all(_kerr(a.cpu(), c) < 1e-12 for a, c in zip(yh, pc.highpasses))
    assert _kerr(compat.dtwaveifm2b(yl, yh, **fams).cpu(),
                 tc.inverse(pc)) < 1e-12
    xn = np.random.RandomState(3).rand(2, 40, 52, 3)
    pn = t.forward_channels(xn, "nhwc", 3)
    rn = t.inverse_channels(pn, "nhwc")
    pnc = tc.forward_channels(torch.from_numpy(xn), "nhwc", 3)
    assert _kerr(rn.cpu(), tc.inverse_channels(pnc, "nhwc")) < 1e-12
    assert all(_kerr(a.cpu(), c) < 1e-12
               for a, c in zip(pn.highpasses, pnc.highpasses))


@pytest.mark.cuda
def test_cuda_level_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """A third filter (pair) off the kernel's length rule, and a launch that
    would need more shared memory than a block has, raise ValueError from
    the host, naming the lengths or the size."""
    b, q = biort("near_sym_b_bp"), qshift("qshift_b_bp")
    x = torch.zeros(2, 32, 32, device=cuda)
    with pytest.raises(ValueError, match=r"odd-length .*\[13, 19, 18\]"):
        level1.fwd_level1(x, b[0], b[2], h2o=np.ones(18))
    with pytest.raises(ValueError, match=r"one even length .*12, 12\]"):
        level2.fwd_level2(x, q[0], q[1], q[4], q[5], h2a=np.ones(12),
                          h2b=np.ones(12))
    with pytest.raises(ValueError, match="together"):
        level2.fwd_level2(x, q[0], q[1], q[4], q[5], h2a=q[8])
    z, band = _inverse_inputs((2, 16, 16), torch.float32, True, cuda)
    with pytest.raises(ValueError, match=r"one even length .*10, 10\]"):
        ilevel2.inv_level2(z, g0a=q[2], g0b=q[3], g1a=q[6], g1b=q[7],
                           g2a=np.ones(10), g2b=np.ones(10), **band)
    with pytest.raises(ValueError, match="together"):
        ilevel2.inv_level2(z, g0a=q[2], g0b=q[3], g1a=q[6], g1b=q[7],
                           g2b=q[11], **band)
    with pytest.raises(ValueError, match=r"odd-length .*\[19, 13, 34\]"):
        ilevel1.inv_level1(z, g0o=b[1], g1o=b[3], g2o=np.ones(34), **band)
    old = _build.SMEM_LIMIT
    try:
        _build.SMEM_LIMIT = 20000
        with pytest.raises(ValueError, match="shared memory"):
            level1.fwd_level1(x, b[0], b[2], h2o=b[4])
        with pytest.raises(ValueError, match="shared memory"):
            ilevel2.inv_level2(z, g0a=q[2], g0b=q[3], g1a=q[6], g1b=q[7],
                               g2a=q[10], g2b=q[11], **band)
    finally:
        _build.SMEM_LIMIT = old
    _build.reset_launches()
    level1.fwd_level1(x, b[0], b[2], h2o=b[4])
    assert dict(_build.launches) == {"level1": 1}


@pytest.mark.cuda
def test_cuda_wrappers_refuse_inputs_that_need_grad(cuda):
    """The wrappers without gradients (the low-level filters, a level or hw
    kernel's entry called directly) raise on an input that requires grad
    while grad mode is on, naming device="cpu"; under torch.no_grad() the
    same calls run the kernels.  The transforms, sharded ones included,
    take such inputs and run their kernels inside ``linear_vjp``."""
    need = r'requires grad.*device="cpu"'
    t = dt.Transform2d()
    x = torch.rand(2, 64, 96, device=cuda, requires_grad=True)
    _build.reset_launches()
    p = t.forward(x, 3)
    rec = t.inverse(p)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"level1": 1, "level2": 2, "ilevel2": 2,
                                     "ilevel1": 1}
    assert rec.grad_fn is not None
    assert float((rec - x).abs().max()) < 1e-4
    im = torch.rand(64, 96, device=cuda, requires_grad=True)
    v = torch.rand(32, 32, 32, device=cuda, requires_grad=True)
    b, q = biort("near_sym_a"), qshift("qshift_a")
    calls = [lambda: single.colfilter(im, b[0]),
             lambda: single.coldfilt(im, q[1], q[0]),
             lambda: single.colifilt(im, q[3], q[2]),
             lambda: level1.fwd_level1(im, b[0], b[2]),
             lambda: dual.filter2_axis(im.contiguous(), b[0], b[2], 0),
             lambda: hw.filter_hw22(v, b[0], b[2])]
    for call in calls:
        with pytest.raises(RuntimeError, match=need):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


# --- gradients on the card (ops/linearize, ops/adjoint) --------------------

# the tolerance of the adjoint rung, relative to the largest value: float32
# 2e-5 (two kernel chains and the border folds, sums in another order),
# bfloat16 planes 1e-2
_GTOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
_GRAD_CASES = [(torch.float32, "interleaved"), (torch.float32, "planes"),
               (torch.bfloat16, "planes")]


def _grad_leaves(p):
    from dtcwt_tpu_torch.ops import linearize
    return linearize._tree(p)[0]


def _plain_entries(monkeypatch, *pairs):
    """Route each (module, entry) to its plain version and keep the
    transforms off ``linear_vjp``: the plain path's autograd on the
    card."""
    from dtcwt_tpu_torch.ops import linearize
    monkeypatch.setattr(linearize, "needs_vjp", lambda _: False)
    for mod, name in pairs:
        monkeypatch.setattr(mod, name, getattr(mod, name + "_reference"))


def _no_plain(monkeypatch, *pairs):
    """Make each (module, entry)'s plain version raise."""
    def refuse(*_a, **_k):
        raise RuntimeError("a plain version ran on the card's backward")
    for mod, name in pairs:
        monkeypatch.setattr(mod, name + "_reference", refuse)


_LEVELS_2D = ((level1, "fwd_level1"), (level2, "fwd_level2"),
              (ilevel2, "inv_level2"), (ilevel1, "inv_level1"))
_DUAL = tuple((dual, n) for n in (
    "filter2_axis", "dfilt2_axis", "filter2_sum_axis", "ifilt2_sum_axis",
    "filter2_fromext_axis", "filter2_sum_fromext_axis"))


def _round_trip_grads(t, x, layout, seed, fwd_kw=None, nlevels=3):
    """Gradients of a loss on a forward's leaves and on its round trip:
    (d/dx of forward, d/dpyramid of inverse)."""
    fwd_kw = fwd_kw or {}
    xg = x.detach().requires_grad_()
    p = t.forward(xg, nlevels, layout=layout, **fwd_kw)
    leaves = _grad_leaves(p)
    rng = np.random.RandomState(seed)
    cots = [torch.from_numpy(rng.randn(*a.shape)).to(a.device, a.dtype)
            if not a.is_complex() else torch.complex(
                *(torch.from_numpy(rng.randn(*a.shape)) for _ in "ri")).to(
                    a.device, a.dtype) for a in leaves]
    (gx,) = torch.autograd.grad(leaves, xg, cots)
    pl = [a.detach().requires_grad_() for a in leaves]
    from dtcwt_tpu_torch.ops import linearize
    z = t.inverse(linearize._fill(linearize._tree(p)[1], pl))
    v = torch.from_numpy(rng.randn(*z.shape)).to(z.device, z.dtype)
    return (gx,) + torch.autograd.grad(z, pl, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,layout", _GRAD_CASES)
def test_cuda_transform2d_grads_match_plain(cuda, monkeypatch, dtype,
                                            layout):
    """Transform2d's forward and inverse gradients on the card (the
    explicit adjoints in float32, the plain route in bfloat16) against
    the plain path's autograd on the card, at 2 x 128 x 96, 3 levels."""
    t = dt.Transform2d()
    x = _rand((2, 128, 96), 20, cuda, dtype)
    got = _round_trip_grads(t, x, layout, 21)
    with monkeypatch.context() as m:
        _plain_entries(m, *_LEVELS_2D)
        want = _round_trip_grads(t, x, layout, 21)
    for g, w in zip(got, want):
        assert _kerr(g.float() if g.dtype == torch.bfloat16 else g,
                     w.float() if w.dtype == torch.bfloat16 else w) \
            < _GTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_cuda_transform2d_backward_launches(cuda, monkeypatch, layout):
    """With every plain version patched to raise, the explicit backward
    launches exactly: the forward's adjoint inv_level2 nlevels - 1 times
    and filter2_sum 3 times, the inverse's filter2 3 times and fwd_level2
    nlevels - 1 times."""
    _no_plain(monkeypatch, *_LEVELS_2D, *_DUAL)
    t = dt.Transform2d()
    x = _rand((256, 256), 22, cuda, torch.float32).requires_grad_()
    p = t.forward(x, 3, layout=layout)
    leaves = _grad_leaves(p)
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.autograd.backward(leaves, [torch.ones_like(a) for a in leaves])
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"ilevel2": 2, "filter2_sum": 3}
    pl = [a.detach().requires_grad_() for a in leaves]
    from dtcwt_tpu_torch.ops import linearize
    z = t.inverse(linearize._fill(linearize._tree(p)[1], pl))
    torch.cuda.synchronize()
    _build.reset_launches()
    z.backward(torch.ones_like(z))
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"filter2": 3, "level2": 2}
    assert all(a.grad is not None for a in pl)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,layout", _GRAD_CASES)
def test_cuda_transform3d_grads_match_plain(cuda, monkeypatch, dtype,
                                            layout):
    """Transform3d's gradients on the card against the plain path's
    autograd on the card, at 32^3, 3 levels, and with discard_level_1
    (the plain route)."""
    from dtcwt_tpu_torch.ops import pack3d
    entries = ((pack3d, "fwd_level1_pack"), (pack3d, "fwd_level2_pack"),
               (pack3d, "inv_level1_pack"), (pack3d, "inv_level2_pack"),
               (single, "filter_axis"))
    t = dt.Transform3d()
    x = _rand((32, 32, 32), 23, cuda, dtype)
    for kw in ({}, {"discard_level_1": True}):
        got = _round_trip_grads(t, x, layout, 24, kw)
        with monkeypatch.context() as m:
            _plain_entries(m, *entries)
            want = _round_trip_grads(t, x, layout, 24, kw)
        for g, w in zip(got, want):
            assert _kerr(g.float() if g.dtype == torch.bfloat16 else g,
                         w.float() if w.dtype == torch.bfloat16 else w) \
                < _GTOL[dtype]


@pytest.mark.cuda
def test_cuda_transform3d_backward_launches(cuda, monkeypatch):
    """With every plain version patched to raise, the 3-D explicit
    backward launches: the forward's adjoint inv_level2_pack (and its
    depth stage ifilt2_sum) nlevels - 1 times and filter2_sum 7 times,
    the inverse's filter2 7 times and fwd_level2_pack (and dfilt2)
    nlevels - 1 times."""
    from dtcwt_tpu_torch.ops import pack3d
    _no_plain(monkeypatch, *_DUAL, (pack3d, "fwd_level1_pack"),
              (pack3d, "fwd_level2_pack"), (pack3d, "inv_level1_pack"),
              (pack3d, "inv_level2_pack"))
    t = dt.Transform3d()
    x = _rand((32, 32, 32), 25, cuda, torch.float32).requires_grad_()
    p = t.forward(x, 3)
    leaves = _grad_leaves(p)
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.autograd.backward(leaves, [torch.ones_like(a) for a in leaves])
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"inv_level2_pack": 2, "ifilt2_sum": 2,
                                     "filter2_sum": 7}
    pl = [a.detach().requires_grad_() for a in leaves]
    from dtcwt_tpu_torch.ops import linearize
    z = t.inverse(linearize._fill(linearize._tree(p)[1], pl))
    torch.cuda.synchronize()
    _build.reset_launches()
    z.backward(torch.ones_like(z))
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"filter2": 7, "fwd_level2_pack": 2,
                                     "dfilt2": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fams", [("near_sym_a", "qshift_a"),
                                  ("near_sym_b", "qshift_d")])
def test_cuda_transform3d_round_trip_and_grads_on_the_analysis_kernels(
        cuda, monkeypatch, fams, dtype):
    """The 3-D round trip and its gradients on the card, every plain
    version patched to raise, against the CPU at float64: the forward runs
    fwd_level1_pack once and fwd_level2_pack twice, the inverse's backward
    fwd_level2_pack twice more; a [40, 48, 72] volume (partial 32 x 32
    tiles at levels 1 and 2), float32 within 2e-5 and float64 within 1e-12
    of the largest value."""
    from dtcwt_tpu_torch.ops import pack3d
    x = np.random.RandomState(27).rand(40, 48, 72)
    t, tc = dt.Transform3d(*fams), dt.Transform3d(*fams, device="cpu")
    tol = {torch.float32: 2e-5, torch.float64: 1e-12}[dtype]
    want = _round_trip_grads(tc, torch.from_numpy(x), "interleaved", 28)
    _no_plain(monkeypatch, *_DUAL, (pack3d, "fwd_level1_pack"),
              (pack3d, "fwd_level2_pack"), (pack3d, "inv_level1_pack"),
              (pack3d, "inv_level2_pack"))
    xg = torch.from_numpy(x).to(cuda, dtype)
    _build.reset_launches()
    rec = t.inverse(t.forward(xg, 3))
    torch.cuda.synchronize()
    assert _build.launches["fwd_level1_pack"] == 1
    assert _build.launches["fwd_level2_pack"] == 2
    assert float((rec.double().cpu() - torch.from_numpy(x)).abs().max()) \
        < (1e-4 if dtype == torch.float32 else 1e-12)
    _build.reset_launches()
    got = _round_trip_grads(t, xg, "interleaved", 28)
    torch.cuda.synchronize()
    assert _build.launches["fwd_level1_pack"] == 1
    assert _build.launches["fwd_level2_pack"] == 4
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape
        assert _kerr(g.cpu(), w.to(g.dtype)) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,layout", _GRAD_CASES)
def test_cuda_transform1d_grads_match_plain(cuda, monkeypatch, dtype,
                                            layout):
    """Transform1d's gradients on the card (the plain route: the backward
    differentiates the plain chain) against the plain path's autograd on
    the card, [1024, 8], 3 levels."""
    t = dt.Transform1d()
    x = _rand((1024, 8), 26, cuda, dtype)
    got = _round_trip_grads(t, x, layout, 27)
    with monkeypatch.context() as m:
        _plain_entries(m, *_DUAL[:4])
        want = _round_trip_grads(t, x, layout, 27)
    for g, w in zip(got, want):
        assert _kerr(g.float() if g.dtype == torch.bfloat16 else g,
                     w.float() if w.dtype == torch.bfloat16 else w) \
            < _GTOL[dtype]


@pytest.mark.cuda
def test_cuda_second_order_backward_raises(cuda):
    """The kernels' outputs carry no graph: a create_graph=True backward
    through the explicit route raises in check_no_grad instead of
    returning a wrong second derivative; the plain route (bandpass
    families) differentiates twice."""
    x = _rand((64, 64), 28, cuda, torch.float32).requires_grad_()
    p = dt.Transform2d().forward(x, 2)
    loss = p.lowpass.pow(2).sum()
    with pytest.raises(RuntimeError, match="requires grad"):
        torch.autograd.grad(loss, x, create_graph=True)
    pb = dt.Transform2d("near_sym_b_bp", "qshift_b_bp").forward(x, 2)
    (g,) = torch.autograd.grad(pb.lowpass.pow(2).sum(), x, create_graph=True)
    (h,) = torch.autograd.grad(g.sum(), x)
    assert bool(torch.isfinite(h).all())


@pytest.mark.cuda
def test_cuda_grad_round_trips_free_their_memory(cuda):
    """Twenty forward and backward passes of a 2-D and a 3-D round trip
    through the explicit route (the 2-D inverse gain-masked) leave the
    card's allocated memory where it was after the first, with the garbage
    collector off: the Function's node keeps no pyramid alive."""
    import gc
    cases = [(dt.Transform2d(), _rand((512, 512), 29, cuda, torch.float32),
              np.full((6, 3), 0.5)),
             (dt.Transform3d(), _rand((32, 32, 32), 30, cuda, torch.float32),
              None)]

    def step(t, x, gm):
        xg = x.detach().requires_grad_()
        p = t.forward(xg, 3)
        z = t.inverse(p) if gm is None else t.inverse(p, gm)
        z.pow(2).sum().backward()
        return float(xg.grad.abs().max())

    for t, x, gm in cases:
        step(t, x, gm)      # the plans' and folds' caches fill once
        torch.cuda.synchronize()
        gc.collect()
        gc.disable()
        try:
            start = torch.cuda.memory_allocated()
            for _ in range(20):
                assert step(t, x, gm) > 0
            torch.cuda.synchronize()
            assert torch.cuda.memory_allocated() == start
        finally:
            gc.enable()


@pytest.mark.cuda
def test_cuda_transform2d_grad_through_conj(cuda, monkeypatch):
    """A loss on the bands' conjugates (cotangents with the lazy
    conjugate bit, which the level kernels' complex views refuse) gets
    the plain path's gradient through the explicit route."""
    t = dt.Transform2d()
    x = _rand((128, 96), 31, cuda, torch.float32)
    rng = np.random.RandomState(32)

    def grad_x():
        xg = x.detach().requires_grad_()
        p = t.forward(xg, 3)
        loss = sum((h.conj() * torch.from_numpy(
            rng.randn(*h.shape) + 1j * rng.randn(*h.shape)).to(
                h.device, h.dtype)).real.sum() for h in p.highpasses)
        return torch.autograd.grad(loss, xg)[0]

    got = grad_x()
    rng = np.random.RandomState(32)
    with monkeypatch.context() as m:
        _plain_entries(m, *_LEVELS_2D)
        want = grad_x()
    assert _kerr(got, want) < _GTOL[torch.float32]


# --- the dual-stream kernels of the 1-D transform (csrc/dual.cu) -----------

_EVEN = (np.array([1.0, 3.0, 3.0, 1.0]) / 8,
         np.array([-0.25, -1.0, 2.0, 1.0, -0.5, 0.125]))


def _dual_calls(kind, fam):
    """(kernel wrapper, plain version) of one dual kernel on one filter
    case, both taking ``(inputs, axis, side)``; side None is the axis form.
    "even" is an explicit pair of 4 and 6 taps; "mixed" takes branch 0 from
    qshift_a (10 taps) and branch 1 from qshift_d (18 taps), or for
    filter2 near_sym_a's 7-tap filter with the 6-tap one (outputs of n and
    n + 1 samples).  The longest filters taken, every tap random: "odd31"
    and "even32" (filter2, filter2_sum), "long32", two qshift pairs of 32
    taps whose sum(ha * hb) differ in sign (dfilt2), "long64", two pairs
    of 64 (ifilt2_sum)."""
    rs = np.random.RandomState(6)
    if kind in ("filter2", "filter2_sum"):
        if fam == "even":
            h0, h1 = _EVEN
        elif fam == "mixed":
            h0, h1 = biort("near_sym_a")[2], _EVEN[1]
        elif fam in ("odd31", "even32"):
            h0, h1 = rs.randn(int(fam[-2:])), rs.randn(int(fam[-2:]))
        else:
            b = biort(fam)
            h0, h1 = (b[0], b[2]) if kind == "filter2" else (b[1], b[3])
        if kind == "filter2":
            return (lambda x, ax, s: dual.filter2_axis(x[0], h0, h1, ax)
                    if s is None else
                    dual.filter2_fromext_axis(x[0], s, h0, h1, ax),
                    lambda x, ax, s: dual.filter2_axis_reference(
                        x[0], h0, h1, ax) if s is None else
                    dual.filter2_fromext_axis_reference(x[0], s, h0, h1, ax))
        return (lambda x, ax, s: dual.filter2_sum_axis(*x, h0, h1, ax)
                if s is None else
                dual.filter2_sum_fromext_axis(*x, s, h0, h1, ax),
                lambda x, ax, s: dual.filter2_sum_axis_reference(
                    *x, h0, h1, ax) if s is None else
                dual.filter2_sum_fromext_axis_reference(*x, s, h0, h1, ax))
    if fam.startswith("long"):
        m = int(fam[4:])
        p0, p1 = (rs.randn(m), rs.randn(m)), (rs.randn(m), rs.randn(m))
        if np.sum(p0[0] * p0[1]) * np.sum(p1[0] * p1[1]) > 0:
            p1 = (p1[0], -p1[1])
    else:
        q0 = qshift("qshift_a" if fam == "mixed" else fam)
        q1 = qshift("qshift_d" if fam == "mixed" else fam)
        p0, p1 = (((q0[1], q0[0]), (q1[5], q1[4])) if kind == "dfilt2"
                  else ((q0[3], q0[2]), (q1[7], q1[6])))
    if kind == "dfilt2":
        return (lambda x, ax, s: dual.dfilt2_axis(x[0], p0, p1, ax)
                if s is None else
                dual.dfilt2_fromext_axis(x[0], s, p0, p1, ax),
                lambda x, ax, s: dual.dfilt2_axis_reference(x[0], p0, p1, ax)
                if s is None else
                dual.dfilt2_fromext_axis_reference(x[0], s, p0, p1, ax))
    return (lambda x, ax, s: dual.ifilt2_sum_axis(*x, p0, p1, ax)
            if s is None else
            dual.ifilt2_sum_fromext_axis(*x, s, p0, p1, ax),
            lambda x, ax, s: dual.ifilt2_sum_axis_reference(*x, p0, p1, ax)
            if s is None else
            dual.ifilt2_sum_fromext_axis_reference(*x, s, p0, p1, ax))


_DUAL_FAMS = {"filter2": ("near_sym_a", "near_sym_b", "legall", "even",
                          "mixed"),
              "filter2_sum": ("near_sym_a", "near_sym_b", "antonini",
                              "even"),
              "dfilt2": ("qshift_a", "qshift_d", "qshift_32", "mixed"),
              "ifilt2_sum": ("qshift_a", "qshift_06", "qshift_32", "mixed")}
# (8, 20, 36): every axis a multiple of 4, inner 720 / 36 / 1; (4, 8, 4):
# axes shorter than the filters; (1028, 1): one signal, inner 1; (12, 130):
# inner 130, more than one column tile
_DUAL_SHAPES = [((8, 20, 36), (-1, -2, -3)), ((4, 8, 4), (-1, -2, -3)),
                ((1028, 1), (0,)), ((12, 130), (0,))]
# and for every entry (ops/dual.py _stream_geometry): columns tiles
# partial across inner (136 of 256 columns) and along the axis (70 and 35
# of 32 and 16 groups); a grid large enough to keep its column vectors (228 blocks,
# float64 600), its tiles partial both ways (520 of 768 columns, 300
# groups of 32 or 16); staged rows whose last block of whole rows is
# partial (45 rows of 100, 40 a block in float32), and segments of a long
# row whose last is partial (5000 and 9000 samples, 4096 float32 groups a
# segment)
_DUAL_SUM_SHAPES = [((3, 70, 136), (-2,)), ((4, 600, 520), (-2,)),
                    ((45, 100), (-1,)), ((3, 5000), (-1,)), ((9000,), (0,))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("kind", ["filter2", "dfilt2", "filter2_sum",
                                  "ifilt2_sum"])
def test_cuda_dual_matches_plain(cuda, kind, dtype):
    """Every dual kernel in its axis and from-extension modes, for every
    filter case, on axes -1, -2 and -3, inner 1 and signals shorter than the
    filter; also on shapes whose last tile is partial on both paths (dfilt2
    where the axis is a multiple of 4), and with every input a contiguous
    view one element off 16-byte alignment."""
    n_in = 2 if kind.endswith("_sum") else 1
    side = 32       # covers qshift_32's 32-tap decimator
    shapes = _DUAL_SHAPES + [
        (shape, axes) for shape, axes in _DUAL_SUM_SHAPES
        if kind != "dfilt2" or shape[axes[0]] % 4 == 0]
    for fam in _DUAL_FAMS[kind]:
        kern, plain = _dual_calls(kind, fam)
        for seed, (shape, axes) in enumerate(shapes):
            xs = [_rand(shape, seed + i, cuda, dtype) for i in range(n_in)]
            for axis in axes:
                for s, odd in ((None, False), (side, False), (None, True),
                               (side, True)):
                    ins = xs if s is None else [
                        fb.symmetric_extend(x, s, axis).contiguous()
                        for x in xs]
                    if odd:
                        ins = [_at_odd_offset(x) for x in ins]
                    got = kern(ins, axis, s)
                    torch.cuda.synchronize()
                    assert _kerr(got, plain(ins, axis, s)) < _KTOL[dtype], \
                        (fam, shape, axis, s, odd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["filter2_sum", "ifilt2_sum"])
def test_cuda_dual_sum_writes_its_outputs_whole(cuda, monkeypatch, kind,
                                                dtype):
    """The sums write every output element and nothing past the end: the
    output is the head of a NaN-filled buffer one row longer (at least 16
    elements, a vector store's reach), equal to the plain version after
    the launch, the tail still NaN.  On both paths, aligned and one element
    off, in both modes, for a short and the longest filters."""
    make, heads = dual._output, []

    def sentinel(shape, dt, device):
        t = make(shape, dt, device)
        buf = torch.full((t.numel() + max(16, t.shape[-1]),), float("nan"),
                         dtype=dt, device=device)
        heads.append((buf, t.numel()))
        return buf[:t.numel()].view(t.shape)
    monkeypatch.setattr(dual, "_output", sentinel)
    fams = (("near_sym_a", "even32") if kind == "filter2_sum"
            else ("qshift_a", "long64"))
    side = 40       # covers the 64-tap pairs' reach
    for fam in fams:
        kern, plain = _dual_calls(kind, fam)
        for seed, (shape, axis) in enumerate(
                [((3, 70, 136), -2), ((12, 130), 0), ((4, 600, 520), -2),
                 ((45, 100), -1), ((3, 5000), -1), ((4, 8, 4), -3)]):
            xs = [_rand(shape, seed + i, cuda, dtype) for i in range(2)]
            for s in (None, side):
                ins = xs if s is None else [
                    fb.symmetric_extend(x, s, axis).contiguous() for x in xs]
                if seed % 2:
                    ins = [_at_odd_offset(x) for x in ins]
                heads.clear()
                got = kern(ins, axis, s)
                torch.cuda.synchronize()
                assert _kerr(got, plain(ins, axis, s)) < _KTOL[dtype], (
                    fam, shape, s)
                assert len(heads) == 1
                buf, n = heads[0]
                assert not torch.isnan(buf[:n]).any(), (fam, shape, s)
                assert torch.isnan(buf[n:]).all(), (fam, shape, s)


@pytest.mark.cuda
def test_cuda_dual_sum_refuses_a_tiling_not_the_hosts(cuda, monkeypatch):
    """The sums' C entries take the tap bound and tiling of
    _stream_geometry and refuse any other with a CUDA error, launching
    nothing; the host's own launch then runs."""
    geometry = dual._stream_geometry
    cols, rows = ((8, 20, 36), -2), ((3, 5000), -1)
    for kind, dtype, (shape, axis), bad in (
            ("filter2_sum", torch.float32, cols, dict(mt=9)),
            ("filter2_sum", torch.float32, cols, dict(seg=64)),
            ("filter2_sum", torch.float32, cols, dict(vc=2)),
            ("filter2_sum", torch.float64, rows, dict(smem=1)),
            ("filter2_sum", torch.bfloat16, rows, dict(v=4)),
            ("ifilt2_sum", torch.float32, cols, dict(mt=7)),
            ("ifilt2_sum", torch.float32, cols, dict(tx=24)),
            ("ifilt2_sum", torch.float32, cols, dict(path="rows")),
            ("ifilt2_sum", torch.float64, rows, dict(smem=1)),
            ("ifilt2_sum", torch.float32, rows, dict(path="cols"))):
        fam = "near_sym_a" if kind == "filter2_sum" else "qshift_a"
        kern, plain = _dual_calls(kind, fam)
        xs = [_rand(shape, i, cuda, dtype) for i in range(2)]
        monkeypatch.setattr(
            dual, "_stream_geometry",
            lambda *a, **k: geometry(*a, **k)._replace(**bad))
        _build.reset_launches()
        with pytest.raises(RuntimeError, match="CUDA error"):
            kern(xs, axis, None)
        assert not _build.launches
        monkeypatch.setattr(dual, "_stream_geometry", geometry)
        got = kern(xs, axis, None)
        torch.cuda.synchronize()
        assert _kerr(got, plain(xs, axis, None)) < _KTOL[dtype], (kind, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("kind", ["filter2_sum", "ifilt2_sum"])
def test_cuda_dual_sum_takes_the_longest_filters(cuda, kind, dtype):
    """The longest filters the sums took before their redesign, every tap
    random, at the largest tap bound (33): filter2_sum's 31 and 32 taps,
    ifilt2_sum's two qshift pairs of 64, on both paths, both modes, aligned
    and one element off, against the plain version, one launch a call."""
    side = 40       # covers the 64-tap pairs' reach
    for fam in (("odd31", "even32") if kind == "filter2_sum"
                else ("long64",)):
        kern, plain = _dual_calls(kind, fam)
        for seed, (shape, axis) in enumerate(
                [((2, 4, 4), -2), ((3, 70, 136), -2), ((12, 130), 0),
                 ((4, 600, 520), -2), ((45, 100), -1), ((9000,), 0)]):
            xs = [_rand(shape, seed + i, cuda, dtype) for i in range(2)]
            for s in (None, side):
                ins = xs if s is None else [
                    fb.symmetric_extend(x, s, axis).contiguous() for x in xs]
                if seed % 2:
                    ins = [_at_odd_offset(x) for x in ins]
                _build.reset_launches()
                got = kern(ins, axis, s)
                torch.cuda.synchronize()
                assert dict(_build.launches) == {kind: 1}
                assert _kerr(got, plain(ins, axis, s)) < _KTOL[dtype], (
                    fam, shape, s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["filter2", "dfilt2"])
def test_cuda_dual_analysis_writes_its_outputs_whole(cuda, monkeypatch,
                                                     kind, dtype):
    """The analysis entries write every element of both outputs and
    nothing past their ends: each output is the head of a NaN-filled
    buffer one row longer (at least 16 elements, a vector store's reach),
    equal to the plain version after the launch, the tail still NaN.  On
    both paths, aligned and one element off, in both modes, for a short
    filter, the mixed ones (filter2's outputs of two lengths) and the
    longest."""
    make, heads = dual._output, []

    def sentinel(shape, dt, device):
        t = make(shape, dt, device)
        buf = torch.full((t.numel() + max(16, t.shape[-1]),), float("nan"),
                         dtype=dt, device=device)
        heads.append((buf, t.numel()))
        return buf[:t.numel()].view(t.shape)
    monkeypatch.setattr(dual, "_output", sentinel)
    fams = (("near_sym_a", "mixed", "even32") if kind == "filter2"
            else ("qshift_a", "mixed", "long32"))
    side = 32       # covers the 32-tap filters' reach
    for fam in fams:
        kern, plain = _dual_calls(kind, fam)
        for seed, (shape, axis) in enumerate(
                [((3, 72, 136), -2), ((12, 132), 0), ((4, 600, 520), -2),
                 ((45, 100), -1), ((3, 5000), -1), ((4, 8, 4), -3)]):
            x = _rand(shape, seed, cuda, dtype)
            for s in (None, side):
                ins = [x if s is None else
                       fb.symmetric_extend(x, s, axis).contiguous()]
                if seed % 2:
                    ins = [_at_odd_offset(ins[0])]
                heads.clear()
                got = kern(ins, axis, s)
                torch.cuda.synchronize()
                assert _kerr(got, plain(ins, axis, s)) < _KTOL[dtype], (
                    fam, shape, s)
                assert len(heads) == 2
                for buf, n in heads:
                    assert not torch.isnan(buf[:n]).any(), (fam, shape, s)
                    assert torch.isnan(buf[n:]).all(), (fam, shape, s)


@pytest.mark.cuda
def test_cuda_dual_analysis_refuses_a_tiling_not_the_hosts(cuda,
                                                           monkeypatch):
    """The analysis entries' C entries take the tap bound and tiling of
    _stream_geometry and refuse any other with a CUDA error, launching
    nothing; the host's own launch then runs."""
    geometry = dual._stream_geometry
    cols, rows = ((8, 20, 36), -2), ((3, 5000), -1)
    for kind, dtype, (shape, axis), bad in (
            ("filter2", torch.float32, cols, dict(mt=9)),
            ("filter2", torch.float32, cols, dict(seg=64)),
            ("filter2", torch.float32, cols, dict(vc=2)),
            ("filter2", torch.float64, rows, dict(smem=1)),
            ("filter2", torch.bfloat16, rows, dict(v=4)),
            ("dfilt2", torch.float32, cols, dict(mt=14)),
            ("dfilt2", torch.float32, cols, dict(tx=24)),
            ("dfilt2", torch.float32, cols, dict(v=8)),
            ("dfilt2", torch.float32, cols, dict(path="rows")),
            ("dfilt2", torch.float64, rows, dict(smem=1)),
            ("dfilt2", torch.float32, rows, dict(path="cols"))):
        fam = "near_sym_a" if kind == "filter2" else "qshift_a"
        kern, plain = _dual_calls(kind, fam)
        x = [_rand(shape, 0, cuda, dtype)]
        monkeypatch.setattr(
            dual, "_stream_geometry",
            lambda *a, **k: geometry(*a, **k)._replace(**bad))
        _build.reset_launches()
        with pytest.raises(RuntimeError, match="CUDA error"):
            kern(x, axis, None)
        assert not _build.launches
        monkeypatch.setattr(dual, "_stream_geometry", geometry)
        got = kern(x, axis, None)
        torch.cuda.synchronize()
        assert _kerr(got, plain(x, axis, None)) < _KTOL[dtype], (kind, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("kind", ["filter2", "dfilt2"])
def test_cuda_dual_analysis_takes_the_longest_filters(cuda, kind, dtype):
    """The longest filters the analysis entries took before their
    redesign, every tap random, at the largest tap bound: filter2's 31 and
    32 taps (bound 33), dfilt2's qshift pairs of 32 (bound 32, the two
    pairs' sum(ha * hb) of either sign), on both paths, both modes,
    aligned and one element off, against the plain version, one launch a
    call."""
    side = 32       # covers the 32-tap filters' reach
    for fam in (("odd31", "even32") if kind == "filter2" else ("long32",)):
        kern, plain = _dual_calls(kind, fam)
        for seed, (shape, axis) in enumerate(
                [((2, 4, 4), -2), ((3, 70, 136), -2), ((12, 130), 0),
                 ((4, 600, 520), -2), ((45, 100), -1), ((9000,), 0)]):
            if kind == "dfilt2" and shape[axis] % 4:
                continue
            x = _rand(shape, seed, cuda, dtype)
            for s in (None, side):
                ins = [x if s is None else
                       fb.symmetric_extend(x, s, axis).contiguous()]
                if seed % 2:
                    ins = [_at_odd_offset(ins[0])]
                _build.reset_launches()
                got = kern(ins, axis, s)
                torch.cuda.synchronize()
                assert dict(_build.launches) == {kind: 1}
                assert _kerr(got, plain(ins, axis, s)) < _KTOL[dtype], (
                    fam, shape, s)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_cuda_transform1d_matches_plain_path(cuda, layout):
    """The 1-D transform on the card against the CPU at float64: pad and
    crop, a single signal and a batch through the channel methods, and the
    launch counts of a 4-level round trip."""
    t = dt.Transform1d("near_sym_b", "qshift_d")
    tc = dt.Transform1d("near_sym_b", "qshift_d", device="cpu")
    for x in (np.random.RandomState(3).rand(202, 19),
              np.random.RandomState(4).rand(1000)):
        _build.reset_launches()
        pg = t.forward(x, 4, layout=layout)
        rg = t.inverse(pg)
        torch.cuda.synchronize()
        assert dict(_build.launches) == {"filter2": 1, "dfilt2": 3,
                                         "ifilt2_sum": 3, "filter2_sum": 1}
        pc = tc.forward(x, 4, layout=layout)
        assert _kerr(rg.cpu(), tc.inverse(pc)) < 1e-12
        assert _kerr(pg.lowpass.cpu(), pc.lowpass) < 1e-12
        hg = pg.highpasses if layout == "interleaved" else pg.highpasses_re
        hc = pc.highpasses if layout == "interleaved" else pc.highpasses_re
        for a, b in zip(hg, hc):
            assert _kerr(a.cpu(), b) < 1e-12
    xb = np.random.RandomState(5).rand(2, 64, 3)
    rg = t.inverse_channels(t.forward_channels(xb, 3))
    assert float((rg.cpu() - torch.from_numpy(xb)).abs().max()) < 1e-12


@pytest.mark.cuda
def test_cuda_dual_refuses_non_contiguous_input(cuda):
    b = biort("near_sym_a")
    x = torch.zeros(16, 8, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        dual.filter2_axis(x, b[0], b[2], 0)


# --- the 3-D level kernels (csrc/pack3d.cu) --------------------------------

# the analysis kernels at each tap bound of their instance sets (level 1:
# legall 5, near_sym_a 7, antonini 9, near_sym_b 19, a random pair of 31
# taps; level 2: qshift_a 10, qshift_b 14, qshift_c 16, qshift_d 18,
# qshift_32 32)
_PACK_FAMS = {"fwd_level1_pack": ("legall", "near_sym_a", "antonini",
                                  "near_sym_b", "long"),
              "inv_level1_pack": ("near_sym_a", "near_sym_b", "antonini"),
              "fwd_level2_pack": ("qshift_a", "qshift_b", "qshift_c",
                                  "qshift_d", "qshift_32"),
              "inv_level2_pack": ("qshift_a", "qshift_d", "qshift_32")}
# the volume each level reads: H or W not a multiple of 32, above 512, or
# shorter than the filter (JAX's Pallas envelope refuses all of them);
# level 2 takes multiples of 4, and its inverse reads half of each
_PACK_SHAPES = {1: [(2, 4, 6, 10), (6, 36, 44), (2, 520, 6)],
                2: [(4, 8, 12), (2, 8, 36, 20), (4, 516, 8)]}
# and for the analysis kernels (32 x 32 output tiles), volumes whose last
# tile is partial in both H and W, band rows ending inside a warp's run
_FWD_PACK_SHAPES = {1: [(4, 36, 44), (8, 40, 72)],
                    2: [(4, 72, 88), (8, 40, 72)]}
# for the synthesis kernels (32 x 32 output tiles), batched output volumes
# whose last tile is partial in both H and W, with staged halos that
# reflect at both ends of an axis
_INV_PACK_SHAPES = {1: [(1, 4, 36, 44), (2, 2, 66, 68)],
                    2: [(1, 4, 72, 88), (2, 4, 36, 68)]}


def _pack_calls(kind, fam):
    """(kernel wrapper, plain version) of one pack3d entry, both taking
    (inputs, planes)."""
    from dtcwt_tpu_torch.ops import pack3d
    if kind.endswith("level1_pack"):
        # "long": four random filters of 31 taps, the longest level 1 takes
        b = (np.random.RandomState(31).randn(4, 31) if fam == "long"
             else biort(fam))
        f = (b[0], b[2]) if kind.startswith("fwd") else (b[1], b[3])
    else:
        q = qshift(fam)
        f = (((q[1], q[0]), (q[5], q[4])) if kind.startswith("fwd")
             else ((q[3], q[2]), (q[7], q[6])))
    kern = getattr(pack3d, kind)
    plain = getattr(pack3d, kind + "_reference")
    if kind.startswith("fwd"):
        return (lambda x, pl: kern(x[0], *f, planes=pl),
                lambda x, pl: plain(x[0], *f, planes=pl))
    return (lambda x, pl: kern(*x, *f)), (lambda x, pl: plain(*x, *f))


def _pack_inputs(kind, shape, dtype, planes, device, seed=0):
    if kind.startswith("fwd"):
        return [_rand(shape, seed, device, dtype)]
    if kind == "inv_level2_pack":
        shape = tuple(shape[:-3]) + tuple(s // 2 for s in shape[-3:])
    D, H, W = shape[-3:]
    bshape = tuple(shape[:-3]) + (28, D // 2, H // 2, W // 2)
    lll = _rand(shape, seed, device, dtype)
    re = _rand(bshape, seed + 1, device, dtype)
    im = _rand(bshape, seed + 2, device, dtype)
    if planes:
        return [lll, re, im]
    return [lll, torch.complex(re, im).movedim(-4, -1).contiguous(), None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,planes", _CASES)
@pytest.mark.parametrize("kind", ["fwd_level1_pack", "inv_level1_pack",
                                  "fwd_level2_pack", "inv_level2_pack"])
def test_cuda_pack3d_matches_plain(cuda, kind, dtype, planes):
    level = 1 if "level1" in kind else 2
    shapes = _PACK_SHAPES[level] + (_FWD_PACK_SHAPES[level]
                                    if kind.startswith("fwd")
                                    else _INV_PACK_SHAPES[level])
    for fam in _PACK_FAMS[kind]:
        kern, plain = _pack_calls(kind, fam)
        for seed, shape in enumerate(shapes):
            x = _pack_inputs(kind, shape, dtype, planes, cuda, seed)
            got = kern(x, planes)
            torch.cuda.synchronize()
            want = plain(x, planes)
            if kind.startswith("fwd") and planes:
                got, want = (got[0], *got[1]), (want[0], *want[1])
            assert _kerr(got, want) < _KTOL[dtype], (fam, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,planes", _CASES)
@pytest.mark.parametrize("kind", ["fwd_level1_pack", "fwd_level2_pack"])
def test_cuda_fwd_pack_writes_its_outputs_whole(cuda, monkeypatch, kind,
                                                dtype, planes):
    """The analysis kernels write every output element and nothing past
    the end: each output is the head of a NaN-filled buffer one band row
    (LLL: one row) longer, equal to the plain version after the launch,
    the tail still NaN."""
    from dtcwt_tpu_torch.ops import pack3d
    level = 1 if "level1" in kind else 2
    make, heads = pack3d._fwd_outputs, []

    def sentinel(*args):
        outs = []
        for t in make(*args):
            if t is not None:
                # a row more: the LLL's, a plane's band row, or the 28
                # subbands of an interleaved band row
                extra = t.shape[-1] * (t.shape[-2] if t.is_complex() else 1)
                nan = float("nan")
                buf = torch.full((t.numel() + extra,),
                                 complex(nan, nan) if t.is_complex() else nan,
                                 dtype=t.dtype, device=t.device)
                heads.append((buf, t.numel()))
                t = buf[:t.numel()].view(t.shape)
            outs.append(t)
        return tuple(outs)
    monkeypatch.setattr(pack3d, "_fwd_outputs", sentinel)
    for fam in _PACK_FAMS[kind]:
        kern, plain = _pack_calls(kind, fam)
        for seed, shape in enumerate(_FWD_PACK_SHAPES[level]):
            heads.clear()
            x = _pack_inputs(kind, shape, dtype, planes, cuda, seed)
            got = kern(x, planes)
            torch.cuda.synchronize()
            want = plain(x, planes)
            if planes:
                got, want = (got[0], *got[1]), (want[0], *want[1])
            assert _kerr(got, want) < _KTOL[dtype], (fam, shape)
            assert len(heads) == (3 if planes else 2)
            for buf, n in heads:
                v = torch.view_as_real(buf) if buf.is_complex() else buf
                assert not torch.isnan(v[:n]).any(), (fam, shape)
                assert torch.isnan(v[n:]).all(), (fam, shape)


@pytest.mark.cuda
def test_cuda_fwd_pack_refuses_a_tile_not_the_hosts(cuda, monkeypatch):
    """The analysis C entries take the tap bound and tile of
    _fwd_pack_geometry and refuse any other with a CUDA error, launching
    nothing; the host's own launch then runs."""
    from dtcwt_tpu_torch.ops import pack3d
    geometry = pack3d._fwd_pack_geometry

    def hw(**bad):
        return lambda g: g._replace(hw=g.hw._replace(**bad))
    for kind, planes, bad in (
            ("fwd_level1_pack", False, hw(mt=9)),
            ("fwd_level1_pack", False, hw(oh=16)),
            ("fwd_level1_pack", True, lambda g: g._replace(smem=g.smem + 4)),
            ("fwd_level1_pack", True, lambda g: g._replace(
                smem=g.smem + 8192)),
            ("fwd_level2_pack", False, hw(mt=14)),
            ("fwd_level2_pack", False, hw(xr=76, xc=76)),
            ("fwd_level2_pack", True, hw(mt=32))):
        fam = "near_sym_a" if kind == "fwd_level1_pack" else "qshift_a"
        kern, plain = _pack_calls(kind, fam)
        x = _pack_inputs(kind, (4, 36, 44), torch.float32, planes, cuda)
        monkeypatch.setattr(pack3d, "_fwd_pack_geometry",
                            lambda *a, **k: bad(geometry(*a, **k)))
        _build.reset_launches()
        with pytest.raises(RuntimeError, match="CUDA error"):
            kern(x, planes)
        assert not _build.launches.get(kind)
        monkeypatch.setattr(pack3d, "_fwd_pack_geometry", geometry)
        got, want = kern(x, planes), plain(x, planes)
        torch.cuda.synchronize()
        if planes:
            got, want = (got[0], *got[1]), (want[0], *want[1])
        assert _kerr(got, want) < _KTOL[torch.float32], (kind, planes)


def _inv_stage(kind, fam, x, planes):
    """The synthesis kernel alone (its (U_0, U_1), before the depth stage)
    and its plain version, on the inputs of :func:`_pack_inputs`."""
    from dtcwt_tpu_torch.ops import pack3d
    from dtcwt_tpu_torch.ops.ilevel2 import ifilt_streams
    lll, ba, bb = x
    H, W = lll.shape[-2:]
    if kind == "inv_level1_pack":
        b = biort(fam)
        f = (b[1], b[3])
        plans = pack3d._filter_plans(*f)
        merge = lambda a, c, ax: fb.filter2_sum_axis(a, c, *f, ax)
        Ho, Wo = H, W
    else:
        q = qshift(fam)
        f = ((q[3], q[2]), (q[7], q[6]))
        plans = [ifilt_streams(*p) for p in f]
        merge = lambda a, c, ax: fb.ifilt2_sum_axis(a, c, *f, ax)
        Ho, Wo = 2 * H, 2 * W

    def plain():
        octs = pack3d.unpack_octants((ba, bb) if planes else ba)
        octs[(0, 0, 0)] = lll.float() if lll.dtype == torch.bfloat16 else lll
        return tuple(merge(merge(octs[(i, 0, 0)], octs[(i, 0, 1)], -1),
                           merge(octs[(i, 1, 0)], octs[(i, 1, 1)], -1), -2)
                     for i in range(2))
    return (lambda: tuple(pack3d._launch(kind, (lll,), (ba, bb), plans, None,
                                         planes, Ho, Wo, False)[:2]), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,planes", [(torch.float32, False),
                                          (torch.float64, False),
                                          (torch.float32, True)])
@pytest.mark.parametrize("kind", ["inv_level1_pack", "inv_level2_pack"])
def test_cuda_inv_pack_writes_its_outputs_whole(cuda, monkeypatch, kind,
                                                dtype, planes):
    """The synthesis kernels write every output element and nothing past
    the end: U_0 and U_1 are the heads of NaN-filled buffers one row
    longer, equal to the plain version after the launch, the tail still
    NaN."""
    from dtcwt_tpu_torch.ops import pack3d
    level = 1 if "level1" in kind else 2
    make, heads = pack3d._inv_outputs, []

    def sentinel(*args):
        outs = []
        for t in make(*args):
            if t is not None:
                buf = torch.full((t.numel() + t.shape[-1],), float("nan"),
                                 dtype=t.dtype, device=t.device)
                heads.append((buf, t.numel()))
                t = buf[:t.numel()].view(t.shape)
            outs.append(t)
        return tuple(outs)
    monkeypatch.setattr(pack3d, "_inv_outputs", sentinel)
    for fam in _PACK_FAMS[kind]:
        for seed, shape in enumerate(_INV_PACK_SHAPES[level]):
            heads.clear()
            x = _pack_inputs(kind, shape, dtype, planes, cuda, seed)
            kern, plain = _inv_stage(kind, fam, x, planes)
            got = kern()
            torch.cuda.synchronize()
            assert _kerr(got, plain()) < _KTOL[dtype], (fam, shape)
            assert len(heads) == 2
            for buf, n in heads:
                assert not torch.isnan(buf[:n]).any(), (fam, shape)
                assert torch.isnan(buf[n:]).all(), (fam, shape)


@pytest.mark.cuda
def test_cuda_inv_pack_refuses_a_tile_not_the_hosts(cuda, monkeypatch):
    """The synthesis C entries take the tile, tap bound and 16-byte loads
    of _inv_pack_geometry and refuse any other with a CUDA error; the
    host's own launch then runs."""
    from dtcwt_tpu_torch.ops import pack3d
    geometry = pack3d._inv_pack_geometry
    for kind, planes, bad in (
            ("inv_level1_pack", False, dict(mt=21)),
            ("inv_level1_pack", False, dict(oh=16)),
            ("inv_level1_pack", True, dict(smem=1)),
            ("inv_level1_pack", True, dict(vq=True)),
            ("inv_level2_pack", False, dict(mt=7)),
            ("inv_level2_pack", False, dict(xr=26, xc=26)),
            ("inv_level2_pack", True, dict(mt=17))):
        fam = "near_sym_a" if kind == "inv_level1_pack" else "qshift_a"
        x = _pack_inputs(kind, (1, 4, 36, 44), torch.float32, planes, cuda)
        kern, plain = _inv_stage(kind, fam, x, planes)
        monkeypatch.setattr(
            pack3d, "_inv_pack_geometry",
            lambda *a, **k: geometry(*a, **k)._replace(**bad))
        _build.reset_launches()
        with pytest.raises(RuntimeError, match="CUDA error"):
            kern()
        assert not _build.launches
        monkeypatch.setattr(pack3d, "_inv_pack_geometry", geometry)
        got = kern()
        torch.cuda.synchronize()
        assert _kerr(got, plain()) < _KTOL[torch.float32], (kind, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_cuda_transform3d_matches_plain_path(cuda, layout):
    """The 3-D transform on the card against the CPU at float64: pads and
    crops at levels 2 and 3 in both ext_modes, a batch, and the launch
    counts of a 3-level round trip; an even-length biort pair runs the
    separable tree on the dual kernels."""
    for em, fams, x in ((4, ("near_sym_b", "qshift_b"),
                         np.random.RandomState(6).rand(2, 18, 22, 26)),
                        (8, ("near_sym_a", "qshift_a"),
                         np.random.RandomState(7).rand(20, 28, 36))):
        t = dt.Transform3d(*fams, ext_mode=em)
        tc = dt.Transform3d(*fams, ext_mode=em, device="cpu")
        _build.reset_launches()
        pg = t.forward(x, 3, layout=layout, include_scale=True)
        rg = t.inverse(pg)
        torch.cuda.synchronize()
        assert dict(_build.launches) == {
            "filter2": 1, "fwd_level1_pack": 1, "dfilt2": 2,
            "fwd_level2_pack": 2, "inv_level2_pack": 2, "ifilt2_sum": 2,
            "inv_level1_pack": 1, "filter2_sum": 1}
        pc = tc.forward(torch.from_numpy(x), 3, layout=layout,
                        include_scale=True)
        assert _kerr(rg.cpu(), tc.inverse(pc)) < 1e-12
        assert float((rg.cpu() - torch.from_numpy(x)).abs().max()) < 1e-12
        hg = pg.highpasses if layout == "interleaved" else \
            pg.highpasses_re + pg.highpasses_im
        hc = pc.highpasses if layout == "interleaved" else \
            pc.highpasses_re + pc.highpasses_im
        for a, b in zip((pg.lowpass,) + hg + pg.scales,
                        (pc.lowpass,) + hc + pc.scales):
            assert _kerr(a.cpu(), b) < 1e-12
    h0 = np.array((0.5, 0.5))
    haar = (h0, h0, h0 * [1, -1], -h0 * [-1, 1])
    x = np.random.RandomState(8).rand(8, 10, 12)
    pg = dt.Transform3d(haar).forward(x, 1, layout=layout)
    pc = dt.Transform3d(haar, device="cpu").forward(torch.from_numpy(x), 1,
                                                    layout=layout)
    assert _kerr(dt.Transform3d(haar).inverse(pg).cpu(),
                 dt.Transform3d(haar, device="cpu").inverse(pc)) < 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["interleaved", "planes"])
def test_cuda_transform3d_discard_level_1_matches_cpu(cuda, layout):
    """``discard_level_1`` on the card: the lowpass-only level 1 is three
    ``filter`` launches each way, and every leaf and the inverse match the
    CPU at float64, with a pad and crop at level 3."""
    x = np.random.RandomState(9).rand(20, 24, 28)
    t, tc = dt.Transform3d(), dt.Transform3d(device="cpu")
    _build.reset_launches()
    pg = t.forward(x, 3, layout=layout, discard_level_1=True)
    rg = t.inverse(pg)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {
        "filter": 6, "dfilt2": 2, "fwd_level2_pack": 2,
        "inv_level2_pack": 2, "ifilt2_sum": 2}
    pc = tc.forward(torch.from_numpy(x), 3, layout=layout,
                    discard_level_1=True)
    assert _kerr(rg.cpu(), tc.inverse(pc)) < 1e-12
    hg = pg.highpasses if layout == "interleaved" else pg.highpasses_re
    hc = pc.highpasses if layout == "interleaved" else pc.highpasses_re
    assert hg[0] is None and hc[0] is None
    for a, b in zip((pg.lowpass,) + hg[1:], (pc.lowpass,) + hc[1:]):
        assert _kerr(a.cpu(), b) < 1e-12
    # bfloat16 planes: widened once, stored once
    xb = torch.from_numpy(x).to(cuda, torch.bfloat16)
    pb = t.forward(xb, 2, layout="planes", discard_level_1=True)
    assert pb.lowpass.dtype == torch.bfloat16
    assert t.inverse(pb).dtype == torch.bfloat16


# --- the single-stream kernels (csrc/filter.cu, csrc/single.cu) ------------

def _single_cases(kind):
    """The filters of every family for one single-stream kernel, the
    bandpass ones included: (label, filter args)."""
    out = []
    if kind == "filter":
        for fam in dt.BIORT_NAMES:
            out += [(fam, (h,)) for h in biort(fam)]
        out += [("qshift_a h0a (even)", (qshift("qshift_a")[0],)),
                ("even", (_EVEN[0],))]
        return out
    for fam in dt.QSHIFT_NAMES:
        q = qshift(fam)
        for i in range(0, len(q), 2):
            out += [(fam, (q[i + 1], q[i])), (fam, (q[i], q[i + 1]))]
    return out


# filter's tiles (csrc/filter.cu): rows longer than one staged segment
# (4097 and 8192 in float32 and float64, 20000 in every type), several
# short rows to a block ([300, 256], [7, 5], odd n for the even filters),
# and columns at inner 2, 3 and 33 (scalar columns)
_FILTER_SHAPES = [((3, 4097), (-1,)), ((2, 8192), (-1,)),
                  ((2, 20000), (-1,)), ((300, 256), (-1,)),
                  ((7, 5), (-1, -2)), ((5, 40, 2), (-2,)),
                  ((5, 40, 3), (-2,)), ((3, 50, 33), (-2,))]


def _at_odd_offset(t):
    """*t* as a contiguous view one element into its storage, so that its
    rows leave 16-byte alignment."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


# dfilt's and ifilt's tiles (the one-branch stream kernels, ops/dual.py
# _stream_geometry): columns tiles partial across inner and along the axis
# (136 of 256 columns, 18 groups of 16), a grid large enough to keep its
# column vectors with tiles partial both ways (520 of 1024 columns, 150
# groups), staged rows whose last block of whole rows is partial (45 rows
# of 100) and segments of a long row whose last is partial (5000 and 9000
# samples)
_SINGLE_STREAM_SHAPES = [((3, 72, 136), (-2,)), ((4, 600, 520), (-2,)),
                         ((45, 100), (-1,)), ((3, 5000), (-1,)),
                         ((9000,), (0,))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("kind", ["filter", "dfilt", "ifilt"])
def test_cuda_single_matches_plain(cuda, kind, dtype):
    """Every single-stream kernel in its axis and from-extension modes, for
    every family's filters (bandpass included, both tap orders of each
    pair, so both signs of sum(ha*hb)), on axes -1, -2 and -3, inner 1 and
    signals shorter than the filter, the extension a contiguous view at an
    odd storage offset; ``filter`` also on the shapes of its tiles, dfilt
    and ifilt on shapes whose last tiles are partial on both paths and
    with the axis form's input at an odd storage offset too.  Each call
    makes one launch."""
    kern = getattr(single, kind + "_axis")
    plain = getattr(single, kind + "_axis_reference")
    kern_x = getattr(single, kind + "_fromext_axis")
    plain_x = getattr(single, kind + "_fromext_axis_reference")
    side = 32       # covers qshift_32's 32-tap decimator
    shapes = _DUAL_SHAPES + (_FILTER_SHAPES if kind == "filter"
                             else _SINGLE_STREAM_SHAPES)
    for label, f in _single_cases(kind):
        for seed, (shape, axes) in enumerate(shapes):
            x = _rand(shape, seed, cuda, dtype)
            for axis in axes:
                for xin in ((x,) if kind == "filter"
                            else (x, _at_odd_offset(x))):
                    _build.reset_launches()
                    got = kern(xin, *f, axis)
                    torch.cuda.synchronize()
                    assert dict(_build.launches) == {kind: 1}
                    assert _kerr(got, plain(xin, *f, axis)) < _KTOL[dtype], \
                        (label, shape, axis, xin.data_ptr() % 16)
                e = _at_odd_offset(fb.symmetric_extend(x, side, axis))
                _build.reset_launches()
                got = kern_x(e, side, *f, axis)
                torch.cuda.synchronize()
                assert dict(_build.launches) == {kind: 1}
                assert _kerr(got, plain_x(e, side, *f, axis)) < \
                    _KTOL[dtype], (label, shape, axis, side)


def _single_stream_long(kind, seed=6):
    """Random pairs of the longest length dfilt (32 taps) or ifilt (64)
    takes, sum(ha * hb) positive then negative."""
    rs = np.random.RandomState(seed)
    m = 32 if kind == "dfilt" else 64
    out = []
    for sign in (1, -1):
        ha, hb = rs.randn(m), rs.randn(m)
        if np.sign(np.sum(ha * hb)) != sign:
            hb = -hb
        out.append((ha, hb))
    return out


def _single_stream_call(kind, x, f, axis, side):
    """(kernel, plain) results of dfilt or ifilt on *x*, in the axis form
    (*side* None) or from an extension by *side*."""
    if side is None:
        return (getattr(single, kind + "_axis")(x, *f, axis),
                lambda: getattr(single, kind + "_axis_reference")(x, *f,
                                                                  axis))
    return (getattr(single, kind + "_fromext_axis")(x, side, *f, axis),
            lambda: getattr(single, kind + "_fromext_axis_reference")(
                x, side, *f, axis))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["dfilt", "ifilt"])
def test_cuda_single_streams_write_their_outputs_whole(cuda, monkeypatch,
                                                       kind, dtype):
    """dfilt and ifilt write every output element and nothing past the
    end: the output is the head of a NaN-filled buffer one row longer (at
    least 16 elements, a vector store's reach), equal to the plain version
    after the launch, the tail still NaN.  On both paths, aligned and one
    element off, in both modes, for qshift_a's pair and the longest."""
    make, heads = dual._output, []

    def sentinel(shape, dt, device):
        t = make(shape, dt, device)
        buf = torch.full((t.numel() + max(16, t.shape[-1]),), float("nan"),
                         dtype=dt, device=device)
        heads.append((buf, t.numel()))
        return buf[:t.numel()].view(t.shape)
    monkeypatch.setattr(dual, "_output", sentinel)
    q = qshift("qshift_a")
    first = 0 if kind == "dfilt" else 2
    sets = [(q[first + 1], q[first])] + _single_stream_long(kind)
    side = 40       # covers the 64-tap pairs' reach
    for f in sets:
        for seed, (shape, axis) in enumerate(
                [((3, 72, 136), -2), ((12, 132), 0), ((4, 600, 520), -2),
                 ((45, 100), -1), ((3, 5000), -1), ((4, 8, 4), -3)]):
            x = _rand(shape, seed, cuda, dtype)
            for s in (None, side):
                xin = x if s is None else fb.symmetric_extend(
                    x, s, axis).contiguous()
                if seed % 2:
                    xin = _at_odd_offset(xin)
                heads.clear()
                got, plain = _single_stream_call(kind, xin, f, axis, s)
                torch.cuda.synchronize()
                assert _kerr(got, plain()) < _KTOL[dtype], (shape, s)
                assert len(heads) == 1
                buf, n = heads[0]
                assert not torch.isnan(buf[:n]).any(), (f[0].size, shape, s)
                assert torch.isnan(buf[n:]).all(), (f[0].size, shape, s)


@pytest.mark.cuda
def test_cuda_single_streams_refuse_a_tiling_not_the_hosts(cuda,
                                                           monkeypatch):
    """dfilt's and ifilt's C entries take the tap bound and tiling of
    _stream_geometry and refuse any other with a CUDA error, launching
    nothing; the host's own launch then runs."""
    geometry = dual._stream_geometry
    cols, rows = ((8, 20, 36), -2), ((3, 5000), -1)
    for kind, dtype, (shape, axis), bad in (
            ("dfilt", torch.float32, cols, dict(mt=14)),
            ("dfilt", torch.float32, cols, dict(tx=24)),
            ("dfilt", torch.float32, cols, dict(v=4)),
            ("dfilt", torch.float32, cols, dict(vc=2)),
            ("dfilt", torch.float32, cols, dict(path="rows")),
            ("dfilt", torch.float64, rows, dict(smem=1)),
            ("dfilt", torch.bfloat16, rows, dict(v=2)),
            ("dfilt", torch.float32, rows, dict(path="cols")),
            ("ifilt", torch.float32, cols, dict(mt=7)),
            ("ifilt", torch.float32, cols, dict(seg=64)),
            ("ifilt", torch.float32, cols, dict(v=4)),
            ("ifilt", torch.float32, cols, dict(path="rows")),
            ("ifilt", torch.float64, rows, dict(smem=1)),
            ("ifilt", torch.float32, rows, dict(rows=2)),
            ("ifilt", torch.float32, rows, dict(path="cols"))):
        q = qshift("qshift_a")
        f = (q[1], q[0]) if kind == "dfilt" else (q[3], q[2])
        x = _rand(shape, 0, cuda, dtype)
        monkeypatch.setattr(
            dual, "_stream_geometry",
            lambda *a, **k: geometry(*a, **k)._replace(**bad))
        _build.reset_launches()
        with pytest.raises(RuntimeError, match="CUDA error"):
            _single_stream_call(kind, x, f, axis, None)
        assert not _build.launches
        monkeypatch.setattr(dual, "_stream_geometry", geometry)
        got, plain = _single_stream_call(kind, x, f, axis, None)
        torch.cuda.synchronize()
        assert _kerr(got, plain()) < _KTOL[dtype], (kind, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("kind", ["dfilt", "ifilt"])
def test_cuda_single_streams_take_the_longest_filters(cuda, kind, dtype):
    """The longest pairs dfilt and ifilt took before their redesign, every
    tap random, at the largest tap bound: dfilt's qshift pairs of 32 taps
    (bound 32), ifilt's of 64 (bound 33), sum(ha * hb) of either sign and
    both tap orders, on both paths, both modes, aligned and one element
    off, against the plain version, one launch a call."""
    side = 40       # covers the 64-tap pairs' reach
    for ha, hb in _single_stream_long(kind):
        for f in ((ha, hb), (hb, ha)):
            for seed, (shape, axis) in enumerate(
                    [((2, 4, 4), -2), ((3, 72, 136), -2), ((12, 132), 0),
                     ((4, 600, 520), -2), ((45, 100), -1), ((9000,), 0)]):
                x = _rand(shape, seed, cuda, dtype)
                for s in (None, side):
                    xin = x if s is None else fb.symmetric_extend(
                        x, s, axis).contiguous()
                    if seed % 2:
                        xin = _at_odd_offset(xin)
                    _build.reset_launches()
                    got, plain = _single_stream_call(kind, xin, f, axis, s)
                    torch.cuda.synchronize()
                    assert dict(_build.launches) == {kind: 1}
                    assert _kerr(got, plain()) < _KTOL[dtype], (
                        f[0].size, shape, s)


@pytest.mark.cuda
def test_cuda_ops_names_launch_the_single_kernels(cuda):
    """The public low-level names on CUDA tensors launch one single-stream
    kernel each and agree with the same names on CPU tensors."""
    from dtcwt_tpu_torch import ops
    b, q = biort("near_sym_a"), qshift("qshift_a")
    x = np.random.RandomState(10).rand(4, 24, 40)
    calls = [("filter", lambda v: ops.colfilter(v, b[0])),
             ("filter", lambda v: ops.rowfilter(v, b[2])),
             ("dfilt", lambda v: ops.coldfilt(v, q[1], q[0])),
             ("dfilt", lambda v: ops.rowdfilt(v, q[5], q[4])),
             ("ifilt", lambda v: ops.colifilt(v, q[3], q[2])),
             ("ifilt", lambda v: ops.rowifilt(v, q[7], q[6])),
             ("filter", lambda v: ops.filter_axis(v, b[0], -3)),
             ("dfilt", lambda v: ops.dfilt_axis(v, q[1], q[0], -2)),
             ("ifilt", lambda v: ops.ifilt_axis(v, q[3], q[2], -3))]
    for name, call in calls:
        _build.reset_launches()
        got = call(torch.from_numpy(x).to(cuda))
        torch.cuda.synchronize()
        assert dict(_build.launches) == {name: 1}
        assert _kerr(got.cpu(), call(torch.from_numpy(x))) < 1e-12


@pytest.mark.cuda
def test_cuda_single_refuses_what_the_kernel_does_not_take(cuda):
    b = biort("near_sym_a")
    with pytest.raises(ValueError, match="contiguous"):
        single.filter_axis(torch.zeros(16, 8, device=cuda).t(), b[0], 0)
    with pytest.raises(TypeError, match="float32, bfloat16 or float64"):
        single.filter_axis(torch.zeros(16, 8, device=cuda,
                                       dtype=torch.float16), b[0], 0)
    # past filter.cu's 32 taps the long-filter kernel takes the filter and
    # its host refuses an extension short of the reach
    with pytest.raises(ValueError, match="reach"):
        single.filter_fromext_axis(torch.zeros(40, 8, device=cuda), 4,
                                   np.ones(33), 0)
    with pytest.raises(ValueError, match="reach"):
        single.filter_fromext_axis(torch.zeros(16, 8, device=cuda), 2, b[1],
                                   0)
    q = qshift("qshift_a")
    with pytest.raises(ValueError, match="reach"):
        single.dfilt_fromext_axis(torch.zeros(24, 8, device=cuda), 4, q[1],
                                  q[0], 0)


@pytest.mark.cuda
def test_cuda_compat_matches_the_transforms(cuda):
    """The compat entries on the card give the Transforms' results."""
    from dtcwt_tpu_torch import compat
    v = np.random.RandomState(11).rand(16, 20, 24)
    yl, yh = compat.dtwavexfm3(v, 3, discard_level_1=True)
    p = dt.Transform3d().forward(v, 3, discard_level_1=True)
    assert torch.equal(yl, p.lowpass) and yh[0] is None
    assert all(torch.equal(a, c) for a, c in zip(yh[1:], p.highpasses[1:]))
    assert torch.equal(compat.dtwaveifm3(yl, yh),
                       dt.Transform3d().inverse(p))
    x = np.random.RandomState(12).rand(40, 36)
    yl, yh = compat.dtwavexfm2(x, 3)
    assert torch.equal(compat.dtwaveifm2(yl, yh),
                       dt.Transform2d().inverse(dt.Transform2d().forward(
                           x, 3)))
    s = np.random.RandomState(13).rand(256, 4)
    yl, yh = compat.dtwavexfm(s, 4)
    assert float((compat.dtwaveifm(yl, yh).cpu()
                  - torch.from_numpy(s)).abs().max()) < 1e-12


# --- the two-sided (H, W) kernels (csrc/hw.cu) ------------------------------

# [..., H, W]: H or W off the Pallas envelope's 8 x 128 grid, above its 512
# cap, or shorter than the filter; multiples of 4 where dfilt needs them
_HW_SHAPES = [(3, 12, 20), (2, 2, 8, 132), (1, 520, 8), (2, 4, 4),
              (6, 32, 48)]
# the synthesis kernel's 32 x 32 output tiles partial in H and W (ifilt:
# even sides, outputs 72 x 88 and 132 x 136), and rows of 42 that its
# chunked staging does not take (a value an item)
_HW_SUM_SHAPES = [(1, 36, 44), (2, 66, 68), (1, 36, 42)]
# the analysis kernel's 32 x 32 output tiles partial in H and W (dfilt:
# sides multiples of 4, outputs 18 x 22 and 34 x 36), and rows of 42 that
# its chunked staging does not take (filter)
_HW22_SHAPES = {"filter": [(1, 36, 44), (2, 68, 72), (1, 36, 42)],
                "dfilt": [(1, 36, 44), (2, 68, 72)]}


def _hw_cases(kind):
    """(family, filters) of one hw kernel for every family of its kind."""
    if kind in ("filter", "filter_sum"):
        out = []
        for fam in ("antonini", "near_sym_a", "near_sym_b"):
            b = biort(fam)
            out.append((fam, (b[0], b[2]) if kind == "filter"
                        else (b[1], b[3])))
        return out
    i = 0 if kind == "dfilt" else 2
    return [(fam, ((q[i + 1], q[i]), (q[i + 5], q[i + 4])))
            for fam in ("qshift_06", "qshift_a", "qshift_d", "qshift_32")
            for q in [qshift(fam)]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("kind", ["filter", "dfilt", "filter_sum",
                                  "ifilt_sum"])
def test_cuda_hw_matches_plain(cuda, kind, dtype):
    from dtcwt_tpu_torch.ops import hw
    kern = getattr(hw, kind + "_hw22")
    plain = getattr(hw, kind + "_hw22_reference")
    n_in = 1 if kind in ("filter", "dfilt") else 4
    shapes = _HW_SHAPES + (_HW_SUM_SHAPES if n_in == 4 else
                           _HW22_SHAPES[kind])
    for fam, f in _hw_cases(kind):
        for seed, shape in enumerate(shapes):
            xs = [_rand(shape, seed + i, cuda, dtype) for i in range(n_in)]
            _build.reset_launches()
            got = kern(*xs, *f)
            torch.cuda.synchronize()
            assert dict(_build.launches) == {kind + "_hw22": 1}
            want = plain(*xs, *f)
            if n_in == 1:
                got = tuple(u for row in got for u in row)
                want = tuple(u for row in want for u in row)
            assert _kerr(got, want) < _KTOL[dtype], (fam, shape)


def _hw_long(kind, seed=3):
    """The longest filters the synthesis kernel takes, every tap random:
    an odd pair of 31 taps (filter_sum), two qshift pairs of 64 (ifilt_sum)."""
    rs = np.random.RandomState(seed)
    if kind == "filter_sum":
        return rs.randn(31), rs.randn(31)
    return (rs.randn(64), rs.randn(64)), (rs.randn(64), rs.randn(64))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("kind", ["filter_sum", "ifilt_sum"])
def test_cuda_sum_hw22_takes_the_longest_filters(cuda, kind, dtype):
    """Odd filters of 31 taps and qshift pairs of 64, the longest the
    synthesis kernel took before its redesign, run on the card at the
    largest tap bound (33) against the plain version."""
    f = _hw_long(kind)
    kern = getattr(hw, kind + "_hw22")
    plain = getattr(hw, kind + "_hw22_reference")
    for seed, shape in enumerate([(2, 4, 4), (1, 36, 44), (2, 66, 68)]):
        xs = [_rand(shape, seed + i, cuda, dtype) for i in range(4)]
        _build.reset_launches()
        got = kern(*xs, *f)
        torch.cuda.synchronize()
        assert dict(_build.launches) == {kind + "_hw22": 1}
        assert _kerr(got, plain(*xs, *f)) < _KTOL[dtype], shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["filter_sum", "ifilt_sum"])
def test_cuda_sum_hw22_writes_its_output_whole(cuda, monkeypatch, kind,
                                               dtype):
    """The synthesis kernel writes every output element and nothing past
    the end: its output is the head of a NaN-filled buffer one row
    longer, equal to the plain version after the launch, the tail still
    NaN.  Odd seeds place the inputs one element past an aligned start
    (the staging then copies a value at a time)."""
    make, heads = hw._outputs, []

    def sentinel(n_out, N, Ho, Wo, dt, device):
        outs = []
        for t in make(n_out, N, Ho, Wo, dt, device):
            buf = torch.full((t.numel() + Wo,), float("nan"), dtype=dt,
                             device=device)
            heads.append((buf, t.numel()))
            outs.append(buf[:t.numel()].view(t.shape))
        return outs
    monkeypatch.setattr(hw, "_outputs", sentinel)
    kern = getattr(hw, kind + "_hw22")
    plain = getattr(hw, kind + "_hw22_reference")
    cases = _hw_cases(kind)[:2] + [("long", _hw_long(kind))]
    for fam, f in cases:
        for seed, shape in enumerate(_HW_SUM_SHAPES + [(3, 12, 20)]):
            heads.clear()
            xs = [_rand(shape, seed + i, cuda, dtype) for i in range(4)]
            if seed % 2:
                xs = [torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(
                    shape) for t in xs]
            got = kern(*xs, *f)
            torch.cuda.synchronize()
            assert _kerr(got, plain(*xs, *f)) < _KTOL[dtype], (fam, shape)
            assert len(heads) == 1
            buf, n = heads[0]
            assert not torch.isnan(buf[:n]).any(), (fam, shape)
            assert torch.isnan(buf[n:]).all(), (fam, shape)


@pytest.mark.cuda
def test_cuda_sum_hw22_refuses_a_tile_not_the_hosts(cuda, monkeypatch):
    """The synthesis C entries take the tile, tap bound and shared memory
    of _sum_hw22_geometry and refuse any other with a CUDA error, launching
    nothing; the host's own launch then runs."""
    geometry = hw._sum_hw22_geometry
    for kind, dtype, bad in (
            ("filter_sum", torch.float32, dict(mt=21)),
            ("filter_sum", torch.float32, dict(oh=16)),
            ("filter_sum", torch.float64, dict(smem=1)),
            ("filter_sum", torch.bfloat16, dict(xr=44, xc=44)),
            ("ifilt_sum", torch.float32, dict(mt=7)),
            ("ifilt_sum", torch.float32, dict(ow=16)),
            ("ifilt_sum", torch.float64, dict(smem=1)),
            ("ifilt_sum", torch.float32, dict(xr=26, xc=26))):
        fam, f = _hw_cases(kind)[1]
        kern = getattr(hw, kind + "_hw22")
        plain = getattr(hw, kind + "_hw22_reference")
        xs = [_rand((2, 36, 44), i, cuda, dtype) for i in range(4)]
        monkeypatch.setattr(
            hw, "_sum_hw22_geometry",
            lambda *a, **k: geometry(*a, **k)._replace(**bad))
        _build.reset_launches()
        with pytest.raises(RuntimeError, match="CUDA error"):
            kern(*xs, *f)
        assert not _build.launches
        monkeypatch.setattr(hw, "_sum_hw22_geometry", geometry)
        got = kern(*xs, *f)
        torch.cuda.synchronize()
        assert _kerr(got, plain(*xs, *f)) < _KTOL[dtype], (kind, bad)


def _hw22_long(kind, seed=4):
    """The longest filters the analysis kernel takes, every tap random: an
    odd pair of 31 taps (filter), two qshift pairs of 32 (dfilt)."""
    rs = np.random.RandomState(seed)
    if kind == "filter":
        return rs.randn(31), rs.randn(31)
    return (rs.randn(32), rs.randn(32)), (rs.randn(32), rs.randn(32))


def _flat4(u):
    return tuple(v for row in u for v in row)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("kind", ["filter", "dfilt"])
def test_cuda_hw22_takes_the_longest_filters(cuda, kind, dtype):
    """Odd filters of 31 taps and qshift pairs of 32, the longest the
    analysis kernel took before its redesign, run on the card at the
    largest tap bound (31, 32) against the plain version."""
    f = _hw22_long(kind)
    kern = getattr(hw, kind + "_hw22")
    plain = getattr(hw, kind + "_hw22_reference")
    for seed, shape in enumerate([(2, 4, 4), (1, 36, 44), (2, 68, 72)]):
        x = _rand(shape, seed, cuda, dtype)
        _build.reset_launches()
        got = kern(x, *f)
        torch.cuda.synchronize()
        assert dict(_build.launches) == {kind + "_hw22": 1}
        assert _kerr(_flat4(got), _flat4(plain(x, *f))) < _KTOL[dtype], shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["filter", "dfilt"])
def test_cuda_hw22_writes_its_outputs_whole(cuda, monkeypatch, kind, dtype):
    """The analysis kernel writes every element of its four outputs and
    nothing past their ends: each output is the head of a NaN-filled buffer
    one row longer, equal to the plain version after the launch, every
    tail still NaN.  Odd seeds place the input one element past an aligned
    start (the staging then copies a value at a time)."""
    make, heads = hw._outputs, []

    def sentinel(n_out, N, Ho, Wo, dt, device):
        outs = []
        for t in make(n_out, N, Ho, Wo, dt, device):
            buf = torch.full((t.numel() + Wo,), float("nan"), dtype=dt,
                             device=device)
            heads.append((buf, t.numel()))
            outs.append(buf[:t.numel()].view(t.shape))
        return outs
    monkeypatch.setattr(hw, "_outputs", sentinel)
    kern = getattr(hw, kind + "_hw22")
    plain = getattr(hw, kind + "_hw22_reference")
    cases = _hw_cases(kind)[:2] + [("long", _hw22_long(kind))]
    for fam, f in cases:
        for seed, shape in enumerate(_HW22_SHAPES[kind] + [(3, 12, 20)]):
            heads.clear()
            x = _rand(shape, seed, cuda, dtype)
            if seed % 2:
                x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(shape)
            got = kern(x, *f)
            torch.cuda.synchronize()
            assert _kerr(_flat4(got), _flat4(plain(x, *f))) < _KTOL[dtype], (
                fam, shape)
            assert len(heads) == 4
            for buf, n in heads:
                assert not torch.isnan(buf[:n]).any(), (fam, shape)
                assert torch.isnan(buf[n:]).all(), (fam, shape)


@pytest.mark.cuda
def test_cuda_hw22_refuses_a_tile_not_the_hosts(cuda, monkeypatch):
    """The analysis C entries take the tile, tap bound and shared memory of
    _hw22_geometry and refuse any other with a CUDA error, launching
    nothing; the host's own launch then runs."""
    geometry = hw._hw22_geometry
    for kind, dtype, bad in (
            ("filter", torch.float32, dict(mt=9)),
            ("filter", torch.float32, dict(oh=16)),
            ("filter", torch.float64, dict(smem=1)),
            ("filter", torch.bfloat16, dict(xr=44, xc=44)),
            ("dfilt", torch.float32, dict(mt=14)),
            ("dfilt", torch.float32, dict(ow=16)),
            ("dfilt", torch.float64, dict(smem=1)),
            ("dfilt", torch.float32, dict(xr=84, xc=84))):
        fam, f = _hw_cases(kind)[1]
        kern = getattr(hw, kind + "_hw22")
        plain = getattr(hw, kind + "_hw22_reference")
        x = _rand((2, 36, 44), 0, cuda, dtype)
        monkeypatch.setattr(
            hw, "_hw22_geometry",
            lambda *a, **k: geometry(*a, **k)._replace(**bad))
        _build.reset_launches()
        with pytest.raises(RuntimeError, match="CUDA error"):
            kern(x, *f)
        assert not _build.launches
        monkeypatch.setattr(hw, "_hw22_geometry", geometry)
        got = kern(x, *f)
        torch.cuda.synchronize()
        assert _kerr(_flat4(got), _flat4(plain(x, *f))) < _KTOL[dtype], (
            kind, bad)


@pytest.mark.cuda
def test_cuda_sharded3d_on_a_card_mesh_matches_transform3d(cuda):
    """ShardedTransform3d on four shards of the card against Transform3d on
    the card: every leaf at float32 within 1e-5 of the largest value, the
    launches of a depth-sharded 3-level round trip, a plan that gathers
    (levels 2-3 replicated), a rows mesh, and float64 against the CPU."""
    from dtcwt_tpu_torch.parallel import ShardedTransform3d, make_mesh
    mesh = make_mesh((1, 4), ("data", "depth"), ["cuda"] * 4)
    st, t = ShardedTransform3d(mesh), dt.Transform3d()
    x = _rand((1, 128, 32, 32), 14, cuda, torch.float32)
    _build.reset_launches()
    ps = st.forward(x, 3)
    rs = st.inverse(ps)
    torch.cuda.synchronize()
    assert dict(_build.launches) == {
        "filter_hw22": 4, "filter2": 16, "dfilt_hw22": 8, "dfilt2": 32,
        "ifilt2_sum": 32, "ifilt_sum_hw22": 8, "filter2_sum": 16,
        "filter_sum_hw22": 4}
    p = t.forward(x, 3)
    for a, b in zip((ps.lowpass,) + ps.highpasses, (p.lowpass,) + p.highpasses):
        assert _kerr(a, b) < 1e-5
    assert _kerr(rs, t.inverse(p)) < 1e-5
    # levels 2-3 replicated: the inverse's (H, W) merge on ifilt_sum_hw22
    xg = _rand((1, 32, 32, 32), 15, cuda, torch.float32)
    _build.reset_launches()
    rg = st.inverse(st.forward(xg, 3))
    assert _build.launches["ifilt_sum_hw22"] == 2
    assert _build.launches["fwd_level2_pack"] == 2
    assert float((rg - xg).abs().max()) < 1e-4
    # a rows mesh and float64 against the CPU
    for shape, names, rows in (((2, 2), ("data", "depth"), None),
                               ((1, 2, 2), ("data", "depth", "rows"),
                                "rows")):
        n = int(np.prod(shape))
        sg = ShardedTransform3d(make_mesh(shape, names, ["cuda"] * n),
                                rows_axis=rows)
        sc = ShardedTransform3d(make_mesh(shape, names, ["cpu"] * n),
                                rows_axis=rows)
        v = np.random.RandomState(16).rand(2, 32, 32, 16)
        for layout in ("interleaved", "planes"):
            pg = sg.forward(v, 2, layout=layout, include_scale=True)
            pc = sc.forward(torch.from_numpy(v), 2, layout=layout,
                            include_scale=True)
            hg = pg.highpasses if layout == "interleaved" else \
                pg.highpasses_re + pg.highpasses_im
            hc = pc.highpasses if layout == "interleaved" else \
                pc.highpasses_re + pc.highpasses_im
            for a, b in zip((pg.lowpass,) + hg + pg.scales,
                            (pc.lowpass,) + hc + pc.scales):
                assert _kerr(a.cpu(), b) < 1e-12
            assert _kerr(sg.inverse(pg).cpu(), sc.inverse(pc)) < 1e-12


# --- the algorithms on the 2-D pyramid: sampling, registration, keypoint ---

def _smooth_pair(h, w, seed=3, shift=(3, 2), sigma=0.04):
    """A smooth random field in [0, 1] and its roll by *shift* pixels."""
    rs = np.random.RandomState(seed)
    spec = np.fft.rfft2(rs.rand(h, w))
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.rfftfreq(w)[None, :]
    spec *= np.exp(-((fy ** 2 + fx ** 2) / (2 * sigma ** 2)))
    f1 = np.fft.irfft2(spec, s=(h, w))
    f1 = (f1 - f1.min()) / (f1.max() - f1.min())
    return f1, np.roll(f1, shift, axis=(0, 1))


def _cpu_pyramid(p):
    return dt.Pyramid(p.lowpass.cpu(), tuple(h.cpu() for h in p.highpasses))


_ALGO_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# keypoint rows: a position is a ratio of second differences of the energy
_KP_TOL = {torch.float64: 1e-12, torch.float32: 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_sampling_matches_cpu(cuda, dtype):
    """Every sampler on the card against ``device="cpu"``: the result stays
    on the card, in the CPU's dtype, within 1e-12 (float64) or 1e-5
    (float32) of the largest value."""
    from dtcwt_tpu_torch import sampling as S
    rng = np.random.RandomState(4)
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    im = torch.from_numpy(rng.randn(40, 52, 2)).to(dtype)
    hp = torch.complex(torch.from_numpy(rng.randn(30, 26, 6)),
                       torch.from_numpy(rng.randn(30, 26, 6))).to(cdt)
    xs = torch.from_numpy(rng.rand(17, 9) * 70 - 10).to(dtype)
    ys = torch.from_numpy(rng.rand(17, 9) * 60 - 10).to(dtype)
    for method in ("nearest", "bilinear", "lanczos"):
        calls = [lambda d: S.sample(im.to(d), xs.to(d), ys.to(d), method),
                 lambda d: S.rescale(im.to(d), (73, 31), method),
                 lambda d: S.rescale(hp.to(d), (11, 45), method),
                 lambda d: S.sample_highpass(hp.to(d), xs.to(d), ys.to(d),
                                             method, sbs=[4, 0, 2]),
                 lambda d: S.rescale_highpass(hp.to(d), (61, 50), method),
                 lambda d: S.upsample(im.to(d), method),
                 lambda d: S.upsample_highpass(hp.to(d), method)]
        for i, call in enumerate(calls):
            got, want = call(cuda), call("cpu")
            assert got.device.type == "cuda" and got.dtype == want.dtype
            assert _kerr(got.cpu(), want) < _ALGO_TOL[dtype], (method, i)
    # a numpy input goes to the card by default
    assert S.sample(im.numpy(), xs.numpy(), ys.numpy()).device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_registration_parts_match_cpu(cuda, dtype):
    """phasegradient (modulo 2 pi), confidence, Qtilde, the box filter,
    velocityfield, warp and warphighpass on the card against the CPU."""
    from dtcwt_tpu_torch import registration as R
    f1, f2 = _smooth_pair(96, 128)
    t = dt.Transform2d()
    p1 = t.forward(torch.from_numpy(f1).to(cuda, dtype), 4)
    p2 = t.forward(torch.from_numpy(f2).to(cuda, dtype), 4)
    c1, c2 = _cpu_pyramid(p1), _cpu_pyramid(p2)
    tol = _ALGO_TOL[dtype]
    for g, w in zip(R.phasegradient(p1.highpasses[2][..., 1],
                                    p2.highpasses[2][..., 1],
                                    R.EXPECTED_SHIFTS[1]),
                    R.phasegradient(c1.highpasses[2][..., 1],
                                    c2.highpasses[2][..., 1],
                                    R.EXPECTED_SHIFTS[1])):
        d = torch.remainder(g.cpu().double() - w.double() + np.pi,
                            2 * np.pi) - np.pi
        assert float(d.abs().max()) / float(w.abs().max()) < tol
    assert _kerr(R.confidence(p1.highpasses[1][..., 2],
                              p2.highpasses[1][..., 2]).cpu(),
                 R.confidence(c1.highpasses[1][..., 2],
                              c2.highpasses[1][..., 2])) < tol
    for g, w in zip(R.qtildematrices(p1, p2, [1, 2, 3]),
                    R.qtildematrices(c1, c2, [1, 2, 3])):
        assert _kerr(g.cpu(), w) < tol
        assert _kerr(R._boxfilter(g, 5).cpu(), R._boxfilter(w, 5)) < tol
    avecs = torch.from_numpy(np.random.RandomState(6).randn(12, 16, 6)
                             * 0.01).to(dtype)
    img = torch.from_numpy(f1).to(dtype)
    for g, w in zip(R.velocityfield(avecs.to(cuda), (96, 128)),
                    R.velocityfield(avecs, (96, 128))):
        assert _kerr(g.cpu(), w) < tol
    assert _kerr(R.warp(img.to(cuda), avecs.to(cuda), "bilinear").cpu(),
                 R.warp(img, avecs, "bilinear")) < tol
    assert _kerr(R.warphighpass(p1.highpasses[0], avecs.to(cuda)).cpu(),
                 R.warphighpass(c1.highpasses[0], avecs)) < tol


@pytest.mark.cuda
def test_cuda_solve_ex_on_a_singular_block(cuda):
    """A zero Qtilde block (a flat region) solves to non-finite values on
    the card, beside finite ones, and raises nothing."""
    from dtcwt_tpu_torch import registration as R
    rng = np.random.RandomState(2)
    M = rng.randn(3, 6, 6)
    Q = M @ M.transpose(0, 2, 1) + 6 * np.eye(6)
    r, c = np.triu_indices(6)
    vecs = np.concatenate([Q[:, r, c], rng.randn(3, 6)], axis=-1)
    vecs[1] = 0.0
    got = R.solvetransform(torch.from_numpy(vecs).to(cuda))
    want = R.solvetransform(torch.from_numpy(vecs))
    assert not bool(torch.isfinite(got[1]).any())
    assert bool(torch.isfinite(got[[0, 2]]).all())
    assert _kerr(got[[0, 2]].cpu(), want[[0, 2]]) < 1e-10


@pytest.mark.cuda
def test_cuda_estimatereg_matches_cpu_and_its_batched_form(cuda):
    """estimatereg at float64 on the card against the CPU within 1e-10; the
    batched form over three frame pairs equal to the loop (float64 1e-10,
    float32 1e-5); the behavioural gate on the card."""
    from dtcwt_tpu_torch import registration as R
    f1, f2 = _smooth_pair(128, 160)
    t = dt.Transform2d()
    p1 = t.forward(torch.from_numpy(f1).to(cuda), 4)
    p2 = t.forward(torch.from_numpy(f2).to(cuda), 4)
    got = R.estimatereg(p1, p2)
    assert got.device.type == "cuda"
    assert _kerr(got.cpu(), R.estimatereg(_cpu_pyramid(p1),
                                          _cpu_pyramid(p2))) < 1e-10
    frames = np.stack([np.roll(f1, (k, 2 * k), axis=(0, 1))
                       for k in range(4)])
    take = lambda p, sl: dt.Pyramid(p.lowpass[sl],
                                    tuple(h[sl] for h in p.highpasses))
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-5)):
        p = t.forward(torch.from_numpy(frames).to(cuda, dtype), 4)
        batched = R.estimatereg_batched(take(p, slice(None, -1)),
                                        take(p, slice(1, None)))
        loop = torch.stack([R.estimatereg(take(p, i), take(p, i + 1))
                            for i in range(3)])
        assert batched.shape == (3, 8, 10, 6)
        assert _kerr(batched, loop) < tol, dtype
    g1, g2 = _smooth_pair(256, 256, seed=5)
    q1 = t.forward(torch.from_numpy(g1).to(cuda, torch.float32), 6)
    q2 = t.forward(torch.from_numpy(g2).to(cuda, torch.float32), 6)
    src = torch.from_numpy(g1).to(cuda, torch.float32)
    warped = R.warp(src, R.estimatereg(q1, q2), method="bilinear")
    ref = torch.from_numpy(g2).to(cuda, torch.float32)
    assert float((warped - ref).abs().mean()) < float(
        (src - ref).abs().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_keypoints_match_cpu_as_sets(cuda, dtype):
    """find_keypoints on the card against the CPU for each method, with and
    without max_points: the same number of rows, and the rows equal as
    multisets within 1e-12 (float64) or 1e-4 (float32): each column, and
    two random mixtures of the columns scaled by their largest values,
    sorted on their own (rounding orders near-equal energies differently
    on the card and the CPU; sorting moves no value further than the best
    matching of the rows does)."""
    from dtcwt_tpu_torch import keypoint as K
    im, _ = _smooth_pair(96, 128, seed=21, sigma=0.12)
    p = dt.Transform2d().forward(torch.from_numpy(im).to(cuda, dtype), 4)
    hps_cpu = tuple(h.cpu() for h in p.highpasses)
    mix = np.random.RandomState(0).rand(4, 2)
    for method in ("fauqueur", "bendale", "kingsbury"):
        for mp in (None, 50):
            got = K.find_keypoints(p.highpasses, method=method, max_points=mp)
            want = K.find_keypoints(hps_cpu, method=method, max_points=mp)
            assert got.device.type == "cuda" and got.dtype == dtype
            g, w = got.double().cpu().numpy(), want.double().numpy()
            assert g.shape == w.shape and len(w) > 0, (method, mp)
            scale = np.abs(w).max(axis=0)
            cols = [(g[:, c], w[:, c]) for c in range(4)]
            cols += [((g / scale) @ m, (w / scale) @ m) for m in mix.T]
            for a, b in cols:
                err = float(np.abs(np.sort(a) - np.sort(b)).max())
                assert err / float(np.abs(b).max()) < _KP_TOL[dtype], (
                    method, mp)


# --- the rest of parallel/: sharded 2-D and 1-D, batch, registration ------

def _leaves2(p):
    if hasattr(p, "highpasses_re"):
        out = [p.lowpass] + list(p.highpasses_re) + list(p.highpasses_im)
    else:
        out = [p.lowpass] + list(p.highpasses)
    return out + list(p.scales or ())


# every entry of the level, dual and single-stream modules: with _no_plain
# their plain versions raise, so a card mesh runs only kernels
_ALL_ENTRIES = tuple((mod, n[:-len("_reference")])
                     for mod in (dual, single, level1, level2, ilevel1,
                                 ilevel2)
                     for n in mod.__all__ if n.endswith("_reference"))


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [False, True])
def test_cuda_sharded2d_on_a_card_mesh_matches_transform2d(cuda, monkeypatch,
                                                           cols):
    """ShardedTransform2d on four shards of the card (the (1, 4) rows mesh,
    or the (1, 2, 2) cols mesh) against Transform2d on the card: every
    leaf and the reconstruction at float32 within 1e-5 and bfloat16 planes
    within 1e-2 of the largest value, the launches of a 3-level round trip
    with every level sharded and the plain versions patched to raise; the
    bandpass families' launches; float64 against the same mesh on the
    CPU within 1e-12."""
    from dtcwt_tpu_torch.parallel import ShardedTransform2d, make_mesh
    if cols:
        shape, names, kw = (1, 2, 2), ("data", "rows", "cols"), {
            "cols_axis": "cols"}
    else:
        shape, names, kw = (1, 4), ("data", "rows"), {}
    st = ShardedTransform2d(make_mesh(shape, names, ["cuda"] * 4), **kw)
    t = dt.Transform2d()
    x = _rand((1, 256, 256), 17, cuda, torch.float32)
    want_p = {t_: t.forward(x.to(d), 3, layout=lay) for t_, d, lay in (
        ("f32", torch.float32, "interleaved"),
        ("bf16", torch.bfloat16, "planes"))}
    with monkeypatch.context() as m:
        _no_plain(m, *_ALL_ENTRIES)
        for tag, dtype, layout, tol in (
                ("f32", torch.float32, "interleaved", 1e-5),
                ("bf16", torch.bfloat16, "planes", 1e-2)):
            _build.reset_launches()
            p = st.forward(x.to(dtype), 3, layout=layout)
            r = st.inverse(p)
            torch.cuda.synchronize()
            assert dict(_build.launches) == {
                "filter2": 12, "dfilt2": 24, "ifilt2_sum": 24,
                "filter2_sum": 12}
            for a, b in zip(_leaves2(p), _leaves2(want_p[tag])):
                assert _kerr(a, b) < tol
            assert _kerr(r, t.inverse(want_p[tag])) < tol
        fams = ("near_sym_b_bp", "qshift_b_bp")
        sb = ShardedTransform2d(st.mesh, *fams, **kw)
        _build.reset_launches()
        p = sb.forward(x, 3)
        rb = sb.inverse(p)
        torch.cuda.synchronize()
        assert dict(_build.launches) == {
            "filter": 24, "filter2": 8, "dfilt2": 16, "dfilt": 24,
            "ifilt2_sum": 16, "ifilt": 24, "filter2_sum": 8}
        tb = dt.Transform2d(*fams)
        pb = tb.forward(x, 3)
        for a, b in zip(_leaves2(p), _leaves2(pb)):
            assert _kerr(a, b) < 1e-5
        assert _kerr(rb, tb.inverse(pb)) < 1e-5
    sc = ShardedTransform2d(make_mesh(shape, names, ["cpu"] * 4), **kw)
    v = np.random.RandomState(18).rand(1, 128, 128)
    for layout in ("interleaved", "planes"):
        pg = st.forward(v, 3, layout=layout, include_scale=True)
        pc = sc.forward(torch.from_numpy(v), 3, layout=layout,
                        include_scale=True)
        for a, b in zip(_leaves2(pg), _leaves2(pc)):
            assert _kerr(a.cpu(), b) < 1e-12
        gm = np.linspace(0.0, 1.5, 18).reshape(6, 3)
        assert _kerr(st.inverse(pg, gm).cpu(), sc.inverse(pc, gm)) < 1e-12


@pytest.mark.cuda
def test_cuda_sharded2d_plan_that_gathers(cuda):
    """6 levels on 512 rows over four shards: level 6 gathers and runs
    replicated on the dual kernels, the inverse re-shards; against
    Transform2d within 1e-5."""
    from dtcwt_tpu_torch.parallel import ShardedTransform2d, make_mesh
    st = ShardedTransform2d(make_mesh((1, 4), ("data", "rows"),
                                      ["cuda"] * 4))
    t = dt.Transform2d()
    x = _rand((2, 512, 512), 19, cuda, torch.float32)
    _build.reset_launches()
    p = st.forward(x, 6)
    r = st.inverse(p)
    torch.cuda.synchronize()
    assert "level2" not in _build.launches
    assert _build.launches["dfilt2"] == 4 * 3 * 4 + 3
    want = t.forward(x, 6)
    for a, b in zip(_leaves2(p), _leaves2(want)):
        assert _kerr(a, b) < 1e-5
    assert _kerr(r, t.inverse(want)) < 1e-5


@pytest.mark.cuda
def test_cuda_sharded1d_on_a_card_mesh_matches_transform1d(cuda, monkeypatch):
    """ShardedTransform1d on four shards of the card against Transform1d on
    the card at float32 within 1e-5, the launches of an 8-level round trip
    with every level sharded and the plain versions patched to raise;
    float64 against the CPU mesh within 1e-12."""
    from dtcwt_tpu_torch.parallel import ShardedTransform1d, make_mesh
    st = ShardedTransform1d(make_mesh((1, 4), ("data", "rows"),
                                      ["cuda"] * 4))
    t = dt.Transform1d()
    x = _rand((1, 4096, 8), 20, cuda, torch.float32)
    with monkeypatch.context() as m:
        _no_plain(m, *_ALL_ENTRIES)
        _build.reset_launches()
        p = st.forward(x, 8)
        r = st.inverse(p)
        torch.cuda.synchronize()
    assert dict(_build.launches) == {"filter2": 4, "dfilt2": 28,
                                     "ifilt2_sum": 28, "filter2_sum": 4}
    want = t.forward(x, 8)
    for a, b in zip(_leaves2(p), _leaves2(want)):
        assert _kerr(a, b) < 1e-5
    assert _kerr(r, t.inverse(want)) < 1e-5
    sc = ShardedTransform1d(make_mesh((2, 4), ("data", "rows"), ["cpu"] * 8))
    sg = ShardedTransform1d(make_mesh((2, 4), ("data", "rows"),
                                      ["cuda"] * 8))
    v = np.random.RandomState(21).rand(2, 328, 3)
    for layout in ("interleaved", "planes"):
        pg = sg.forward(v, 4, layout=layout)
        pc = sc.forward(torch.from_numpy(v), 4, layout=layout)
        for a, b in zip(_leaves2(pg), _leaves2(pc)):
            assert _kerr(a.cpu(), b) < 1e-12
        assert _kerr(sg.inverse(pg).cpu(), sc.inverse(pc)) < 1e-12


@pytest.mark.cuda
def test_cuda_batch_sharded_matches_the_whole_batch(cuda, monkeypatch):
    """BatchSharded over the four devices of a data mesh on the card: one
    Transform2d call per slice (fwd_level1 4, fwd_level2 8, inv_level2 8,
    inv_level1 4 for 3 levels), equal to Transform2d on the whole batch
    within 1e-5; Transform1d and Transform3d likewise."""
    from dtcwt_tpu_torch.parallel import BatchSharded, make_mesh
    mesh = make_mesh((4,), ("data",), ["cuda"] * 4)
    t = dt.Transform2d()
    bt = BatchSharded(t, mesh)
    x = _rand((8, 96, 128), 22, cuda, torch.float32)
    with monkeypatch.context() as m:
        _no_plain(m, *_ALL_ENTRIES)
        _build.reset_launches()
        p = bt.forward(x, 3)
        r = bt.inverse(p)
        torch.cuda.synchronize()
    assert dict(_build.launches) == {"level1": 4, "level2": 8, "ilevel2": 8,
                                     "ilevel1": 4}
    want = t.forward(x, 3)
    for a, b in zip(_leaves2(p), _leaves2(want)):
        assert _kerr(a, b) < 1e-5
    assert _kerr(r, t.inverse(want)) < 1e-5
    for tr, shape, nl in ((dt.Transform1d(), (8, 256, 4), 4),
                          (dt.Transform3d(), (4, 32, 32, 32), 2)):
        xs = _rand(shape, 23, cuda, torch.float32)
        b = BatchSharded(tr, mesh)
        pb, pw = b.forward(xs, nl), tr.forward(xs, nl)
        for a, c in zip(_leaves2(pb), _leaves2(pw)):
            assert _kerr(a, c) < 1e-5
        assert _kerr(b.inverse(pb), tr.inverse(pw)) < 1e-5


@pytest.mark.cuda
def test_cuda_estimatereg_sharded_matches_estimatereg(cuda):
    """estimatereg_sharded on a (4,) rows mesh of the card against
    estimatereg on the card, float64 within 1e-10, with no host wait."""
    import warnings
    from dtcwt_tpu_torch import registration as R
    from dtcwt_tpu_torch.parallel import estimatereg_sharded, make_mesh
    mesh = make_mesh((4,), ("rows",), ["cuda"] * 4)
    f1, f2 = _smooth_pair(128, 160)
    t = dt.Transform2d()
    p1 = t.forward(torch.from_numpy(f1).to(cuda), 6)
    p2 = t.forward(torch.from_numpy(f2).to(cuda), 6)
    got = estimatereg_sharded(p1, p2, mesh)
    assert got.is_cuda
    assert _kerr(got, R.estimatereg(p1, p2)) < 1e-10
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            estimatereg_sharded(p1, p2, mesh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not [w for w in caught if "synchroniz" in str(w.message)]


# --- gradients through the sharded transforms on card meshes ----------------

def _sharded_grad_case(cuda, kind, fams=()):
    """(sharded transform on a ["cuda"] * 4 mesh, the unsharded transform,
    input shape, nlevels, the (module, entry) pairs of its kernel entries)
    of one sharded class: every level sharded."""
    from dtcwt_tpu_torch.ops import pack3d
    from dtcwt_tpu_torch.parallel import (
        ShardedTransform1d, ShardedTransform2d, ShardedTransform3d, make_mesh)
    names = {"2d-cols": ("data", "rows", "cols"), "3d": ("data", "depth")}
    shape = (1, 2, 2) if kind == "2d-cols" else (1, 4)
    mesh = make_mesh(shape, names.get(kind, ("data", "rows")),
                     ["cuda"] * 4)
    dual_pairs = tuple((dual, n + s) for n in ("filter2", "dfilt2",
                                               "filter2_sum", "ifilt2_sum")
                       for s in ("_axis", "_fromext_axis"))
    if kind == "1d":
        return (ShardedTransform1d(mesh, *fams), dt.Transform1d(*fams),
                (1, 4096, 8), 8, dual_pairs)
    if kind == "3d":
        return (ShardedTransform3d(mesh, *fams), dt.Transform3d(*fams),
                (1, 128, 32, 32), 3,
                dual_pairs + tuple((hw, n) for n in (
                    "filter_hw22", "dfilt_hw22", "filter_sum_hw22",
                    "ifilt_sum_hw22")) + tuple(
                    (pack3d, n) for n in ("fwd_level1_pack",
                                          "fwd_level2_pack")))
    kw = {"cols_axis": "cols"} if kind == "2d-cols" else {}
    return (ShardedTransform2d(mesh, *fams, **kw), dt.Transform2d(*fams),
            (1, 256, 256), 3, dual_pairs + tuple(
                (single, n + s) for n in ("filter", "dfilt", "ifilt")
                for s in ("_axis", "_fromext_axis")))


_SHARDED_KINDS = ["2d-rows", "2d-cols", "1d", "3d"]
_SHARDED_GTOL = {torch.float32: 2e-5, torch.float64: 1e-12}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", _SHARDED_KINDS)
def test_cuda_sharded_grads_match_unsharded_and_plain(cuda, monkeypatch,
                                                      kind, dtype):
    """A sharded class on four shards of the card takes an input and a
    pyramid that require grad: its forward and inverse gradients equal the
    unsharded transform's on the card and the plain path's autograd on
    the card, float32 within 2e-5 and float64 within 1e-12 of the
    largest value."""
    st, t, shape, nl, entries = _sharded_grad_case(cuda, kind)
    x = _rand(shape, 40, cuda, dtype)
    got = _round_trip_grads(st, x, "interleaved", 41, nlevels=nl)
    want = _round_trip_grads(t, x, "interleaved", 41, nlevels=nl)
    with monkeypatch.context() as m:
        _plain_entries(m, *entries)
        plain = _round_trip_grads(st, x, "interleaved", 41, nlevels=nl)
    assert len(got) == len(want) == len(plain)
    for g, w, p in zip(got, want, plain):
        assert g.device == w.device and g.dtype == w.dtype
        assert _kerr(g, w) < _SHARDED_GTOL[dtype]
        assert _kerr(g, p) < _SHARDED_GTOL[dtype]


# the explicit backward's launches of each sharded round trip with every
# level sharded: (the forward's adjoint, the inverse's adjoint)
_SHARDED_BWD = {
    "2d-rows": ({"filter2_sum": 12, "ifilt2_sum": 24},
                {"filter2": 12, "dfilt2": 24}),
    "2d-cols": ({"filter2_sum": 12, "ifilt2_sum": 24},
                {"filter2": 12, "dfilt2": 24}),
    "1d": ({"filter2_sum": 4, "ifilt2_sum": 28},
           {"filter2": 4, "dfilt2": 28}),
    # the level-1 (H, W) adjoint: three filter2_sum / filter2 a shard
    "3d": ({"ifilt_sum_hw22": 8, "ifilt2_sum": 32, "filter2_sum": 16 + 12},
           {"dfilt_hw22": 8, "dfilt2": 32, "filter2": 16 + 12})}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", _SHARDED_KINDS)
def test_cuda_sharded_backward_launches(cuda, monkeypatch, kind):
    """With every plain version patched to raise, the backward of each
    direction of a sharded round trip runs the opposite passes on the
    kernels: the launch counts of PERF.md."""
    from dtcwt_tpu_torch.ops import linearize, pack3d
    st, _, shape, nl, _ = _sharded_grad_case(cuda, kind)
    _no_plain(monkeypatch, *_ALL_ENTRIES, *((hw, n) for n in (
        "filter_hw22", "dfilt_hw22", "filter_sum_hw22", "ifilt_sum_hw22")),
              *((pack3d, n) for n in ("fwd_level1_pack", "fwd_level2_pack",
                                      "inv_level1_pack", "inv_level2_pack")))
    x = _rand(shape, 42, cuda, torch.float32).requires_grad_()
    p = st.forward(x, nl)
    leaves = _grad_leaves(p)
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.autograd.backward(leaves, [torch.ones_like(a) for a in leaves])
    torch.cuda.synchronize()
    assert dict(_build.launches) == _SHARDED_BWD[kind][0]
    pl = [a.detach().requires_grad_() for a in leaves]
    z = st.inverse(linearize._fill(linearize._tree(p)[1], pl))
    torch.cuda.synchronize()
    _build.reset_launches()
    z.backward(torch.ones_like(z))
    torch.cuda.synchronize()
    assert dict(_build.launches) == _SHARDED_BWD[kind][1]
    assert x.grad is not None and all(a.grad is not None for a in pl)


@pytest.mark.cuda
def test_cuda_sharded_grads_bandpass_and_planes(cuda, monkeypatch):
    """The bandpass families (every pass on the plain route) and the
    planes layout on the (1, 4) rows mesh of the card: gradients equal
    Transform2d's on the card within 2e-5."""
    for fams, layout in ((("near_sym_b_bp", "qshift_b_bp"), "interleaved"),
                         ((), "planes")):
        st, t, shape, nl, _ = _sharded_grad_case(cuda, "2d-rows", fams)
        x = _rand(shape, 43, cuda, torch.float32)
        got = _round_trip_grads(st, x, layout, 44, nlevels=nl)
        want = _round_trip_grads(t, x, layout, 44, nlevels=nl)
        for g, w in zip(got, want):
            assert _kerr(g, w) < 2e-5


@pytest.mark.cuda
def test_cuda_batch_sharded_grads_match_the_whole_batch(cuda):
    """BatchSharded(Transform2d()) over the four devices of a data mesh on
    the card: the forward's input gradient and the inverse's pyramid
    gradients equal Transform2d's on the whole batch within 2e-5."""
    from dtcwt_tpu_torch.parallel import BatchSharded, make_mesh
    t = dt.Transform2d()
    bt = BatchSharded(t, make_mesh((4,), ("data",), ["cuda"] * 4))
    x = _rand((8, 96, 128), 45, cuda, torch.float32)
    got = _round_trip_grads(bt, x, "interleaved", 46)
    want = _round_trip_grads(t, x, "interleaved", 46)
    for g, w in zip(got, want):
        assert _kerr(g, w) < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["2d-rows", "3d"])
def test_cuda_sharded_grad_steps_free_their_memory(cuda, kind):
    """Twenty forward, inverse and backward steps of a sharded round trip
    leave the card's allocated memory where it was after the first, with
    the garbage collector off: no pass's Function node keeps a shard
    alive."""
    import gc
    st, _, shape, nl, _ = _sharded_grad_case(cuda, kind)
    x = _rand(shape, 47, cuda, torch.float32)

    def step():
        xg = x.detach().requires_grad_()
        st.inverse(st.forward(xg, nl)).pow(2).sum().backward()
        return float(xg.grad.abs().max())

    step()      # the plans' and folds' caches fill once
    torch.cuda.synchronize()
    gc.collect()
    gc.disable()
    try:
        start = torch.cuda.memory_allocated()
        for _ in range(20):
            assert step() > 0
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == start
    finally:
        gc.enable()


# --- filters past the kernels' tap bounds (ops/longfir, csrc/longfir.cu) ---

def _long_taps(m, seed):
    """*m* seeded random taps, none zero, at a unit sum of magnitudes."""
    rs = np.random.RandomState(seed)
    h = rs.uniform(0.5, 1.5, m) * rs.choice((-1.0, 1.0), m)
    return h / np.abs(h).sum()


# a random 35/37-tap biort family, a random 36-tap qshift family, and
# qshift_32 zero-padded to 36 taps (within QSHIFT_ADJOINT_TOL: the
# gradients' explicit route)
_LONG_B = tuple(_long_taps(m, i) for i, m in enumerate((35, 37, 37, 35)))
_LONG_Q = tuple(_long_taps(36, 10 + i) for i in range(8))
_LONG_QADJ = tuple(np.pad(np.asarray(h).ravel(), 2)
                   for h in qshift("qshift_32"))
_LTOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float64: 1e-12}


def _lt(m, seed=0):
    return _long_taps(m, seed)


# entry -> (inputs, filters past its bound), as ``mod.<entry>_axis`` takes
# them after the inputs
_LONG_STREAMS = {
    "filter": (single, 1, lambda: (_lt(35),)),
    "filter2": (dual, 1, lambda: (_lt(33), _lt(36, 1))),
    "filter2_sum": (dual, 2, lambda: (_lt(37), _lt(33, 1))),
    "dfilt": (single, 1, lambda: (_lt(34), _lt(34, 1))),
    "dfilt2": (dual, 1, lambda: ((_lt(36), _lt(36, 1)),
                                 (_lt(36, 2), _lt(36, 3)))),
    "ifilt": (single, 1, lambda: (_lt(66), _lt(66, 1))),
    "ifilt2_sum": (dual, 2, lambda: ((_lt(68), _lt(68, 1)),
                                     (_lt(68, 2), _lt(68, 3)))),
}
# (shape, axis): columns four a thread (inner 300), a short inner, the
# axis contiguous (inner = 1), a middle axis, an axis of 8 under 37+ taps
_LONG_VIEWS = [((3, 28, 300), 1), ((28, 5), 0), ((4, 2, 1028), -1),
               ((2, 28, 3, 2), 1), ((5, 8, 7), 1)]


def _nest_lens(f):
    if isinstance(f, (tuple, list)):
        return [n for g in f for n in _nest_lens(g)]
    return [np.asarray(f).size]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["reflect", "fromext"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("name", list(_LONG_STREAMS))
def test_cuda_long_stream_entries_match_plain(cuda, name, dtype, mode):
    """Each dual and single entry with filters past its kernel's bound:
    one launch of the long-filter kernel, against its plain version, on
    every view and in both boundary modes."""
    mod, n_in, filters = _LONG_STREAMS[name]
    f = filters()
    op = longfir._OPS[longfir.STREAMS[name]][0]
    suffix = "_fromext_axis" if mode == "fromext" else "_axis"
    kern = getattr(mod, name + suffix)
    plain = getattr(mod, name + suffix + "_reference")
    for seed, (shape, axis) in enumerate(_LONG_VIEWS):
        if name.startswith("dfilt") and shape[axis] % 4:
            continue
        xs = [_rand(shape, seed + k, cuda, dtype) for k in range(n_in)]
        args = list(xs)
        if mode == "fromext":
            side = max(_nest_lens(f)) + 3
            args = [fb.symmetric_extend(x, side, axis).contiguous()
                    for x in xs] + [side]
        _build.reset_launches()
        got = kern(*args, *f, axis)
        torch.cuda.synchronize()
        assert dict(_build.launches) == {"longfir_" + op: 1}
        assert _kerr(got, plain(*args, *f, axis)) < _LTOL[dtype], (shape,
                                                                     axis)


def _long_edges(name):
    """Filter sets of entry *name* whose streams fill 1, 2 and 3 chunks of
    the kernel's 8 taps (LF_MT) from one tap short of an edge to one past
    it: 7, 9, 17 taps (filter), qshift pairs of 8, 10, 18 (dfilt, a
    stream a filter), 14, 18, 34 (ifilt, half a filter, one tap more where
    a stream starts a window step in), then a few hundred taps, staged
    again along the rows (301, pairs of 300)."""
    P = longfir.STREAMS[name]
    two = name in ("filter2", "filter2_sum", "dfilt2", "ifilt2_sum")
    sets = []
    for i, m in enumerate({1: (7, 9, 17, 301), 2: (8, 10, 18, 300),
                           4: (14, 18, 34, 300)}[P]):
        if P == 1:
            other = m if name == "filter2_sum" else m + 1
            sets.append((_lt(m, i),) + ((_lt(other, i + 9),) if two else ()))
        else:
            pair = lambda k, i=i, m=m: (_lt(m, i + k), _lt(m, i + k + 1))
            sets.append((pair(0), pair(2)) if two else pair(0))
    return sets


def _least_side(name, flat):
    """The least extension a side that the plain from-extension versions
    take (fb's own widths: half a filter for filter and ifilt, a whole
    filter for dfilt)."""
    P = longfir.STREAMS[name]
    return max(np.size(h) // (1 if P == 2 else 2) for h in flat)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["reflect", "fromext"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("name", list(_LONG_STREAMS))
def test_cuda_long_kernel_at_its_tile_and_chunk_edges(cuda, name, dtype,
                                                      mode):
    """The long-filter kernel itself (``longfir.stream``, whatever the
    entry's bound) at its chunk edges and past one staging round
    (:func:`_long_edges`), in from-extension mode with the least side
    the plain versions take, with inner 1 (rows path: one block of 3 rows,
    and 300 rows in several), 3 (columns, one a thread) and 4096
    (columns, a 16-byte vector a thread): one launch against the entry's
    plain version."""
    mod, n_in, _ = _LONG_STREAMS[name]
    op = longfir._OPS[longfir.STREAMS[name]][0]
    for f in _long_edges(name):
        flat = tuple(h for g in f for h in (g if isinstance(g, tuple)
                                            else (g,)))
        for seed, (shape, axis) in enumerate((((3, 40), -1),
                                              ((300, 40), -1), ((40, 3), 0),
                                              ((2, 20, 4096), 1))):
            n = shape[axis]
            xs = [_rand(shape, seed + k, cuda, dtype) for k in range(n_in)]
            if mode == "reflect":
                side, ins = None, xs
                plain = getattr(mod, name + "_axis_reference")
                want = plain(*ins, *f, axis)
            else:
                side = _least_side(name, flat)
                ins = [fb.symmetric_extend(x, side, axis).contiguous()
                       for x in xs]
                plain = getattr(mod, name + "_fromext_axis_reference")
                want = plain(*ins, side, *f, axis)
            _build.reset_launches()
            out = longfir.stream(name, ins, flat, n, axis, side)
            torch.cuda.synchronize()
            assert dict(_build.launches) == {"longfir_" + op: 1}
            got = tuple(out) if len(out) > 1 else out[0]
            assert _kerr(got, want) < _LTOL[dtype], (
                [np.size(h) for h in flat], shape, axis, side)


def _long_level_cases(cuda, dtype, planes):
    """entry -> (call, plain version, launches) of every level and hw
    entry with filters past its bound."""
    b, q = _LONG_B, _LONG_Q
    bp = _lt(33, 20)
    q2 = (_lt(36, 30), _lt(36, 31))
    p0, p1 = (q[1], q[0]), (q[5], q[4])
    s0, s1 = (q[3], q[2]), (q[7], q[6])
    l0, l1 = (_lt(66, 40), _lt(66, 41)), (_lt(66, 42), _lt(66, 43))
    x = _rand((2, 136, 200), 1, cuda, dtype)
    z, band = _inverse_inputs((2, 68, 100), dtype, planes, cuda)
    v = _rand((2, 16, 24, 40), 2, cuda, dtype)
    lo = _rand((2, 8, 12, 20), 3, cuda, dtype)
    sub = (2, 28, 4, 6, 10)
    if planes:
        bands = (_rand(sub, 4, cuda, dtype), _rand(sub, 5, cuda, dtype))
    else:
        cd = torch.complex128 if dtype == torch.float64 else torch.complex64
        bands = (torch.complex(_rand((2, 4, 6, 10, 28), 4, cuda,
                                     torch.float64),
                               _rand((2, 4, 6, 10, 28), 5, cuda,
                                     torch.float64)).to(cd), None)
    hs = [_rand((3, 40, 56), 6 + k, cuda, dtype) for k in range(4)]
    f, d, i = "longfir_filter", "longfir_dfilt", "longfir_ifilt"
    return {
        "fwd_level1": (lambda: level1.fwd_level1(x, b[0], b[2], planes),
                       lambda: level1.fwd_level1_reference(x, b[0], b[2],
                                                           planes), {f: 3}),
        "fwd_level1 bandpass": (
            lambda: level1.fwd_level1(x, b[0], b[2], planes, bp),
            lambda: level1.fwd_level1_reference(x, b[0], b[2], planes, bp),
            {f: 5}),
        "fwd_level2": (
            lambda: level2.fwd_level2(x, q[0], q[1], q[4], q[5], planes),
            lambda: level2.fwd_level2_reference(x, q[0], q[1], q[4], q[5],
                                                planes), {d: 3}),
        "fwd_level2 bandpass": (
            lambda: level2.fwd_level2(x, q[0], q[1], q[4], q[5], planes,
                                      *q2),
            lambda: level2.fwd_level2_reference(x, q[0], q[1], q[4], q[5],
                                                planes, *q2), {d: 5}),
        "inv_level2": (
            lambda: ilevel2.inv_level2(z, g0a=q[2], g0b=q[3], g1a=q[6],
                                       g1b=q[7], **band),
            lambda: ilevel2.inv_level2_reference(
                z, g0a=q[2], g0b=q[3], g1a=q[6], g1b=q[7], **band), {i: 3}),
        "inv_level2 bandpass": (
            lambda: ilevel2.inv_level2(z, g0a=q[2], g0b=q[3], g1a=q[6],
                                       g1b=q[7], g2a=q2[0], g2b=q2[1],
                                       **band),
            lambda: ilevel2.inv_level2_reference(
                z, g0a=q[2], g0b=q[3], g1a=q[6], g1b=q[7], g2a=q2[0],
                g2b=q2[1], **band), {i: 5}),
        "inv_level1": (
            lambda: ilevel1.inv_level1(z, g0o=b[1], g1o=b[3], **band),
            lambda: ilevel1.inv_level1_reference(z, g0o=b[1], g1o=b[3],
                                                 **band), {f: 3}),
        "inv_level1 bandpass": (
            lambda: ilevel1.inv_level1(z, g0o=b[1], g1o=b[3], g2o=bp,
                                       **band),
            lambda: ilevel1.inv_level1_reference(z, g0o=b[1], g1o=b[3],
                                                 g2o=bp, **band), {f: 5}),
        "fwd_level1_pack": (
            lambda: pack3d.fwd_level1_pack(v, b[0], b[2], planes),
            lambda: pack3d.fwd_level1_pack_reference(v, b[0], b[2], planes),
            {f: 7}),
        "fwd_level2_pack": (
            lambda: pack3d.fwd_level2_pack(v, p0, p1, planes),
            lambda: pack3d.fwd_level2_pack_reference(v, p0, p1, planes),
            {d: 7}),
        "inv_level1_pack": (
            lambda: pack3d.inv_level1_pack(lo, *bands, b[1], b[3]),
            lambda: pack3d.inv_level1_pack_reference(lo, *bands, b[1], b[3]),
            {f: 7}),
        "inv_level2_pack": (
            lambda: pack3d.inv_level2_pack(lo, *bands, s0, s1),
            lambda: pack3d.inv_level2_pack_reference(lo, *bands, s0, s1),
            {i: 7}),
        "filter_hw22": (lambda: hw.filter_hw22(hs[0], b[0], b[2]),
                        lambda: hw.filter_hw22_reference(hs[0], b[0], b[2]),
                        {f: 3}),
        "dfilt_hw22": (lambda: hw.dfilt_hw22(hs[0], p0, p1),
                       lambda: hw.dfilt_hw22_reference(hs[0], p0, p1),
                       {d: 3}),
        "filter_sum_hw22": (
            lambda: hw.filter_sum_hw22(*hs, b[1], b[3]),
            lambda: hw.filter_sum_hw22_reference(*hs, b[1], b[3]), {f: 3}),
        "ifilt_sum_hw22": (
            lambda: hw.ifilt_sum_hw22(*hs, l0, l1),
            lambda: hw.ifilt_sum_hw22_reference(*hs, l0, l1), {i: 3}),
    }


_LONG_LEVELS = ["fwd_level1", "fwd_level1 bandpass", "fwd_level2",
                "fwd_level2 bandpass", "inv_level2", "inv_level2 bandpass",
                "inv_level1", "inv_level1 bandpass", "fwd_level1_pack",
                "fwd_level2_pack", "inv_level1_pack", "inv_level2_pack",
                "filter_hw22", "dfilt_hw22", "filter_sum_hw22",
                "ifilt_sum_hw22"]


def _flat_out(t):
    if isinstance(t, (tuple, list)):
        return [a for v in t for a in _flat_out(v)]
    return [t]


@pytest.mark.cuda
@pytest.mark.parametrize("entry,dtype,planes", [
    (e, d, p) for e in _LONG_LEVELS for d, p in _CASES
    if p or "hw22" not in e])   # the hw entries have no layout
def test_cuda_long_level_entries_match_plain(cuda, entry, dtype, planes):
    """Each level and hw entry with filters past its kernel's bound runs its
    plain chain on the long-filter kernel (no launch of its own kernel)
    and agrees with its plain version on the card."""
    call, plain, launches = _long_level_cases(cuda, dtype, planes)[entry]
    _build.reset_launches()
    got = call()
    torch.cuda.synchronize()
    assert dict(_build.launches) == launches
    for a, c in zip(_flat_out(got), _flat_out(plain())):
        assert _kerr(a, c) < _LTOL[dtype], entry


def _long_transform(kind, device, qs=_LONG_Q):
    return getattr(dt, kind)(biort=_LONG_B, qshift=qs, device=device)


# kind -> (input shape, levels, launches of a float32 round trip)
_LONG_TRANSFORMS = {
    "Transform1d": ((1024, 8), 4, {"longfir_filter": 2, "longfir_dfilt": 3,
                                   "ifilt2_sum": 3}),
    "Transform2d": ((2, 136, 200), 3, {"longfir_filter": 6,
                                       "longfir_dfilt": 6,
                                       "longfir_ifilt": 6}),
    "Transform3d": ((24, 32, 40), 2, {"longfir_filter": 14,
                                      "longfir_dfilt": 7,
                                      "longfir_ifilt": 7}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(_LONG_TRANSFORMS))
def test_cuda_long_transforms_match_cpu(cuda, kind):
    """Each transform's round trip with the long families on the card: the
    launches (the 1-D inverse's 36-tap pairs stay on ifilt2_sum, whose
    kernel takes 64), float32 against float64 on the CPU at storage
    grade, and float64 every leaf and the inverse against device="cpu"
    within 1e-12."""
    shape, nl, launches = _LONG_TRANSFORMS[kind]
    x = np.random.RandomState(7).rand(*shape)
    tc, tg = _long_transform(kind, "cpu"), _long_transform(kind, cuda)
    pc = tc.forward(torch.from_numpy(x), nl)
    rc = tc.inverse(pc)
    _build.reset_launches()
    p32 = tg.forward(torch.from_numpy(x).float(), nl)
    r32 = tg.inverse(p32)
    torch.cuda.synchronize()
    assert dict(_build.launches) == launches
    assert _kerr(r32.cpu(), rc) < 1e-5
    pg = tg.forward(torch.from_numpy(x), nl)
    rg = tg.inverse(pg)
    assert _kerr(pg.lowpass.cpu(), pc.lowpass) < 1e-12
    assert all(_kerr(a.cpu(), c) < 1e-12
               for a, c in zip(pg.highpasses, pc.highpasses))
    assert _kerr(rg.cpu(), rc) < 1e-12


@pytest.mark.cuda
def test_cuda_long_sharded3d_matches_cpu(cuda):
    """ShardedTransform3d on a (1, 2) card mesh with the long families:
    level 1 depth-sharded (each shard's 32 samples hold the 24-sample
    halo) on the long kernel's from-extension mode, float64 against the
    CPU mesh within 1e-12."""
    from dtcwt_tpu_torch.parallel import ShardedTransform3d, make_mesh
    x = torch.from_numpy(np.random.RandomState(8).rand(1, 64, 16, 24))
    mk = lambda dev: ShardedTransform3d(
        make_mesh((1, 2), ("data", "depth"), [dev] * 2), biort=_LONG_B,
        qshift=_LONG_Q)
    sg, sc = mk("cuda"), mk("cpu")
    assert sg._plan(64, 2)[0]
    _build.reset_launches()
    pg = sg.forward(x, 2)
    rg = sg.inverse(pg)
    torch.cuda.synchronize()
    assert _build.launches["longfir_filter"] > 0
    assert not {"hw", "filter_hw22", "dfilt_hw22", "filter2", "dfilt2"} & \
        set(_build.launches)
    pc = sc.forward(x, 2)
    assert _kerr(pg.lowpass.cpu(), pc.lowpass) < 1e-12
    assert all(_kerr(a.cpu(), c) < 1e-12
               for a, c in zip(pg.highpasses, pc.highpasses))
    assert _kerr(rg.cpu(), sc.inverse(pc)) < 1e-12


def _grads(t, x, nl, seed):
    """(d/dx of a loss on the forward's leaves, d/dleaves of a loss on
    the inverse)."""
    xg = x.detach().requires_grad_()
    p = t.forward(xg, nl)
    leaves = _grad_leaves(p)
    rng = np.random.RandomState(seed)
    cots = [torch.complex(*(torch.from_numpy(rng.randn(*a.shape))
                            for _ in "ri")).to(a.device, a.dtype)
            if a.is_complex() else
            torch.from_numpy(rng.randn(*a.shape)).to(a.device, a.dtype)
            for a in leaves]
    (gx,) = torch.autograd.grad(leaves, xg, cots)
    from dtcwt_tpu_torch.ops import linearize
    pl = [a.detach().requires_grad_() for a in leaves]
    z = t.inverse(linearize._fill(linearize._tree(p)[1], pl))
    w = torch.from_numpy(rng.randn(*z.shape)).to(z.device, z.dtype)
    return (gx,) + torch.autograd.grad(z, pl, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(_LONG_TRANSFORMS))
def test_cuda_long_transform_grads_match_cpu(cuda, kind):
    """Each transform's gradients with a random 35/37-tap biort family and
    qshift_32 zero-padded to 36 taps (the explicit route for the 2-D and
    3-D transforms, whose backward runs the long-filter kernel; the 1-D
    transform's plain route), float64, against the plain path's autograd
    on the CPU within 1e-12."""
    from dtcwt_tpu_torch.ops import adjoint
    assert adjoint.explicit_route(_LONG_B, _LONG_QADJ, torch.float64)
    shape, nl, _ = _LONG_TRANSFORMS[kind]
    x = torch.from_numpy(np.random.RandomState(9).rand(*shape))
    tg = _long_transform(kind, cuda, _LONG_QADJ)
    got = _grads(tg, x.to(cuda), nl, 10)
    torch.cuda.synchronize()
    want = _grads(_long_transform(kind, "cpu", _LONG_QADJ), x, nl, 10)
    for g, w in zip(got, want):
        assert _kerr(g.cpu(), w) < 1e-12


@pytest.mark.cuda
def test_cuda_long_transform2d_backward_launches(cuda, monkeypatch):
    """The 2-D explicit backward with the long families launches the
    long-filter kernel only (every plain version patched to raise): the
    forward's adjoint is the inverse's chain (ifilt 3 a qshift level,
    filter 3 for level 1), the inverse's the forward's (filter 3, dfilt 3 a
    level)."""
    _no_plain(monkeypatch, *_LEVELS_2D, *_DUAL)
    t = _long_transform("Transform2d", cuda, _LONG_QADJ)
    x = _rand((136, 200), 11, cuda, torch.float32).requires_grad_()
    p = t.forward(x, 3)
    leaves = _grad_leaves(p)
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.autograd.backward(leaves, [torch.ones_like(a) for a in leaves])
    torch.cuda.synchronize()
    assert dict(_build.launches) == {"longfir_ifilt": 6, "longfir_filter": 3}
    assert x.grad is not None


@pytest.mark.cuda
def test_cuda_long_route_refuses_inputs_that_need_grad(cuda):
    """A long route called directly refuses an input that requires grad
    while grad mode is on, naming device="cpu", as every wrapper does;
    under torch.no_grad() it launches the long-filter kernel."""
    need = r'requires grad.*device="cpu"'
    im = torch.rand(64, 96, device=cuda, requires_grad=True)
    v = torch.rand(16, 16, 16, device=cuda, requires_grad=True)
    b, q = _LONG_B, _LONG_Q
    calls = [lambda: single.colfilter(im, b[0]),
             lambda: single.coldfilt(im, q[1], q[0]),
             lambda: dual.filter2_axis(im, b[0], b[2], 0),
             lambda: level1.fwd_level1(im, b[0], b[2]),
             lambda: level2.fwd_level2(im, q[0], q[1], q[4], q[5]),
             lambda: hw.filter_hw22(v, b[0], b[2]),
             lambda: pack3d.fwd_level1_pack(v, b[0], b[2])]
    for call in calls:
        with pytest.raises(RuntimeError, match=need):
            call()
        _build.reset_launches()
        with torch.no_grad():
            call()
        assert set(_build.launches) <= {"longfir_filter", "longfir_dfilt"}
    torch.cuda.synchronize()
