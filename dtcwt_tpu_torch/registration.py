"""DTCWT-based phase image registration in 2-D (``dtcwt_tpu.registration``).

The locally-affine motion estimator of Chen & Kingsbury ("Efficient
Registration of Nonrigid 3-D Bodies", IEEE TIP 2012; its 2-D form).
``estimatereg`` runs the JAX package's static level schedule eagerly: an
initial global solve, then for every refinement stage a warp, the Qtilde
accumulation, a box filter, a rescale and a batched 6x6 solve.  It reads
nothing back to the host (no ``.item()``, no boolean-mask indexing, a solve
that does not check its pivots), so the host can queue a whole registration
without waiting for the device.

Every internal function takes its pyramids' leaves, subbands and parameter
fields with leading batch axes, so that :func:`estimatereg_batched` is the
single form with one batch axis.  Device rule: as in
:mod:`dtcwt_tpu_torch.sampling`; a pyramid stays on the device of its
leaves (numpy leaves go to *device*, the card by default).
"""

from __future__ import annotations

import numpy as np
import torch

from dtcwt_tpu_torch import convert, sampling
from dtcwt_tpu_torch.sampling import _const, _device, _tensor
from dtcwt_tpu_torch.transforms.pyramid import PlanePyramid, Pyramid

__all__ = [
    "estimatereg", "estimatereg_batched", "velocityfield", "warp",
    "warptransform", "warphighpass", "phasegradient", "confidence",
    "qtildematrices", "solvetransform", "normsample", "normsamplehighpass",
    "EXPECTED_SHIFTS",
]

#: Expected horizontal/vertical phase shift per subband of the 2-D transform
EXPECTED_SHIFTS = np.array(
    ((-1, -3), (-3, -3), (-3, -1), (-3, 1), (-3, 3), (-1, 3))) * np.pi / 2.15

_TRIU_R, _TRIU_C = np.triu_indices(6)
_TRIU_FLAT = np.ravel_multi_index(np.triu_indices(6), (6, 6))


def _slice(x, axis: int, start: int, stop: int):
    return x.narrow(axis, start, stop - start)


def _angle_mid(S, axis: int):
    """The angle of *S* along *axis* at the samples: the first and last
    differences at the edges, the mean of the two neighbours between."""
    n = S.shape[axis]
    return torch.cat((torch.angle(_slice(S, axis, 0, 1)),
                      torch.angle(0.5 * (_slice(S, axis, 0, n - 1)
                                         + _slice(S, axis, 1, n))),
                      torch.angle(_slice(S, axis, n - 1, n))), dim=axis)


def _phasegradient(sb1, sb2, rot_x, w_x, rot_y, w_y, ay: int, ax: int):
    """(d/dy, d/dx, d/dt) with the y and x axes *ay*, *ax*; *rot_x* is
    ``exp(-j w_x)`` and *w_x* the shift, scalars or tensors that broadcast
    over the subbands (``dtcwt_tpu/registration.py:46-73``)."""
    nx, ny = sb1.shape[ax], sb1.shape[ay]
    S = (_slice(sb1, ax, 1, nx) * torch.conj(_slice(sb1, ax, 0, nx - 1))
         + _slice(sb2, ax, 1, nx) * torch.conj(_slice(sb2, ax, 0, nx - 1))
         ) * rot_x
    dx = _angle_mid(S, ax) + w_x
    S = (_slice(sb1, ay, 1, ny) * torch.conj(_slice(sb1, ay, 0, ny - 1))
         + _slice(sb2, ay, 1, ny) * torch.conj(_slice(sb2, ay, 0, ny - 1))
         ) * rot_y
    dy = _angle_mid(S, ay) + w_y
    dt = torch.angle(sb2 * torch.conj(sb1))
    return dy, dx, dt


def _identical(sb1, sb2, device):
    dev = _device(device, sb1, sb2)
    sb1, sb2 = _tensor(sb1, dev), _tensor(sb2, dev)
    if sb1.shape != sb2.shape:
        raise ValueError("Subbands should have identical size")
    return sb1, sb2


def phasegradient(sb1, sb2, w=None, device=None):
    """d/dy, d/dx, d/dt phase gradients of a subband pair, de-rotated by the
    expected per-pixel shift *w* (``dtcwt_tpu/registration.py:46-73``).
    The rotation ``exp(-j w)`` is formed in float64 and cast to the
    subbands' dtype; the shift is added in their real dtype."""
    if w is None:
        w = (0.0, 0.0)
    sb1, sb2 = _identical(sb1, sb2, device)
    rot = lambda a: complex(np.cos(a), -np.sin(a))
    return _phasegradient(sb1, sb2, rot(w[0]), float(w[0]), rot(w[1]),
                          float(w[1]), 0, 1)


def _edge_pad1(sb, ay: int, ax: int):
    """Replicate-pad by one pixel on every side."""
    nx = sb.shape[ax]
    sb = torch.cat((_slice(sb, ax, 0, 1), sb, _slice(sb, ax, nx - 1, nx)), ax)
    ny = sb.shape[ay]
    return torch.cat((_slice(sb, ay, 0, 1), sb, _slice(sb, ay, ny - 1, ny)),
                     ay)


def _confidence(sb1, sb2, ay: int, ax: int, epsilon=1e-6):
    """Confidence weight per pixel from the four diagonal neighbours
    (``dtcwt_tpu/registration.py:82-99``)."""
    us, vs = _edge_pad1(sb1, ay, ax), _edge_pad1(sb2, ay, ax)
    us3 = torch.abs(us) ** 3
    vs3 = torch.abs(vs) ** 3
    prod = torch.conj(us) * vs
    ny, nx = us.shape[ay], us.shape[ax]

    def region(t, y0, x0):
        return _slice(_slice(t, ay, y0, y0 + ny - 2), ax, x0, x0 + nx - 2)

    numerator = 0.0
    denominator = epsilon
    for y0, x0 in ((0, 0), (0, 2), (2, 0), (2, 2)):
        numerator = numerator + region(prod, y0, x0)
        denominator = denominator + region(us3, y0, x0) + region(vs3, y0, x0)
    return torch.abs(numerator) ** 2 / denominator


def confidence(sb1, sb2, epsilon=1e-6, device=None):
    """Confidence weight per pixel from the four diagonal neighbours
    (``dtcwt_tpu/registration.py:82-99``)."""
    sb1, sb2 = _identical(sb1, sb2, device)
    return _confidence(sb1, sb2, 0, 1, epsilon)


def _shift_tables(dtype, device):
    """Per subband: ``exp(-j w)`` in *dtype* and the shift in its real dtype,
    for x and y (``EXPECTED_SHIFTS`` columns 0 and 1)."""
    rdt = dtype.to_real()
    rot = lambda c: _const(tuple(np.exp(-1j * EXPECTED_SHIFTS[:, c])), dtype,
                           device)
    shift = lambda c: _const(tuple(EXPECTED_SHIFTS[:, c]), rdt, device)
    return rot(0), shift(0), rot(1), shift(1)


def _qtilde_level(hp1, hp2, y0: int = 0, height=None):
    """``[*B, N, M, 27]`` Qtilde accumulation over the 6 subbands of one
    level's ``[*B, N, M, 6]`` stacks (``dtcwt_tpu/registration.py:102-125``),
    all six subbands at once.  The grid is ``arange(w) / w``, the first *w*
    points of the JAX package's ``np.arange(0, 1, 1 / w)``, which for some
    widths (49, 98, 103, ...) has ``w + 1`` points and fails there.

    A block of rows of a taller level gives its first row's index *y0* and
    the level's *height*: the rows then stand at ``(y0 + i) / height``."""
    h, w = hp1.shape[-3], hp1.shape[-2]
    height = h if height is None else height
    rdt = hp1.real.dtype
    dev = hp1.device
    xs = (torch.arange(w, dtype=torch.float64, device=dev) * (1.0 / w)).to(
        rdt)[:, None]
    ys = (torch.arange(y0, y0 + h, dtype=torch.float64, device=dev)
          * (1.0 / height)).to(rdt)[:, None, None]
    C_d = _confidence(hp1, hp2, -3, -2)
    dy, dx, dt = _phasegradient(hp1, hp2, *_shift_tables(hp1.dtype, dev),
                                -3, -2)
    dx = dx * w
    dy = dy * height
    tmp = torch.stack((dx, dy, xs * dx, xs * dy, ys * dx, ys * dy, -dt),
                      dim=-1)                               # [..., 6, 7]
    r = _const(tuple(_TRIU_R), torch.long, dev)
    c = _const(tuple(_TRIU_C), torch.long, dev)
    Qt = torch.cat((tmp.index_select(-1, r) * tmp.index_select(-1, c),
                    tmp[..., :6] * tmp[..., 6:]), dim=-1)   # [..., 6, 27]
    Qt = Qt * (C_d ** 2)[..., None]
    return Qt.sum(dim=-2)


def qtildematrices(t_ref, t_target, levels):
    r"""Per-pixel :math:`\tilde{Q}` matrices (NxMx27) for each level index in
    *levels* (``dtcwt_tpu/registration.py:128-133``)."""
    return tuple(_qtilde_level(t_ref.highpasses[level],
                               t_target.highpasses[level])
                 for level in levels)


def solvetransform(Qtilde_vec, device=None):
    r"""Solve :math:`a = -Q^{-1} q` from packed 27-vectors, batched over any
    leading dims (``dtcwt_tpu/registration.py:136-146``; only the upper
    triangle of Q is populated).  A singular block gives non-finite values
    and raises nothing: ``torch.linalg.solve_ex``'s pivot check is not
    read, so nothing waits on the device."""
    Qtilde_vec = _tensor(Qtilde_vec, _device(device, Qtilde_vec))
    lead = Qtilde_vec.shape[:-1]
    Q = Qtilde_vec.new_zeros(lead + (36,))
    Q.index_copy_(-1, _const(tuple(_TRIU_FLAT), torch.long, Q.device),
                  Qtilde_vec[..., :21])
    Q = Q.reshape(lead + (6, 6))
    q = Qtilde_vec[..., -6:]
    return torch.linalg.solve_ex(Q, -q[..., None])[0][..., 0]


def _normsample(Yh, xs, ys, method, nb: int = 0):
    return sampling._sample(Yh, xs * Yh.shape[nb + 1], ys * Yh.shape[nb],
                            method, nb)


def _normsamplehighpass(Yh, xs, ys, method, nb: int = 0):
    return sampling._sample_highpass(Yh, xs * Yh.shape[nb + 1],
                                     ys * Yh.shape[nb], method,
                                     np.arange(6), nb)


def normsample(Yh, xs, ys, method=None, device=None):
    """Sample with coordinates normalised to unit width and height
    (``dtcwt_tpu/registration.py:149-152``)."""
    dev = _device(device, Yh, xs, ys)
    Yh = _tensor(Yh, dev)
    return _normsample(Yh, sampling._coords(xs, dev),
                       sampling._coords(ys, dev), method)


def normsamplehighpass(Yh, xs, ys, method=None, device=None):
    """Highpass sampling with unit-normalised coordinates
    (``dtcwt_tpu/registration.py:155-158``)."""
    dev = _device(device, Yh, xs, ys)
    Yh = _tensor(Yh, dev)
    return _normsamplehighpass(Yh, sampling._coords(xs, dev),
                               sampling._coords(ys, dev), method)


def _unit_grid(h: int, w: int, dev):
    """``(arange(w) / w [w], arange(h) / h [h, 1])`` in float32, as the JAX
    package builds them in numpy before they meet the parameters (a
    float64 field promotes them exactly).  The quotients are taken in
    float64 and rounded once to float32, which gives numpy's correctly
    rounded float32 quotients on every device (on the card a division by
    a scalar multiplies by its reciprocal)."""
    f64 = torch.float64
    return ((torch.arange(w, dtype=f64, device=dev) / w).float(),
            (torch.arange(h, dtype=f64, device=dev) / h).float()[:, None])


def _velocityfield(avecs, shape, method, nb: int = 0):
    h, w = avecs.shape[nb], avecs.shape[nb + 1]
    pxs, pys = _unit_grid(h, w, avecs.device)
    vxs = avecs[..., 0] + avecs[..., 2] * pxs + avecs[..., 4] * pys
    vys = avecs[..., 1] + avecs[..., 3] * pxs + avecs[..., 5] * pys
    vxs = sampling._rescale(vxs, shape, method, nb)
    vys = sampling._rescale(vys, shape, method, nb)
    return vxs, vys


def velocityfield(avecs, shape, method=None, device=None):
    """x and y velocity fields (unit-normalised) of size *shape* implied by
    the local affine parameters *avecs* (``dtcwt_tpu/registration.py:
    161-171``)."""
    avecs = _tensor(avecs, _device(device, avecs))
    return _velocityfield(avecs, shape, method)


def _warphighpass(Yh, avecs, method, nb: int = 0):
    h, w = Yh.shape[nb], Yh.shape[nb + 1]
    X, Y = _unit_grid(h, w, Yh.device)
    vxs, vys = _velocityfield(avecs, (h, w), method, nb)
    return _normsamplehighpass(Yh, X + vxs, Y + vys, method, nb)


def warphighpass(Yh, avecs, method=None, device=None):
    """Warp a highpass subband stack along the velocity field implied by
    *avecs* (``dtcwt_tpu/registration.py:174-180``)."""
    dev = _device(device, Yh, avecs)
    return _warphighpass(_tensor(Yh, dev), _tensor(avecs, dev), method)


def warp(I, avecs, method=None, device=None):
    """Warp a real image along the velocity field implied by *avecs*
    (``dtcwt_tpu/registration.py:183-189``)."""
    dev = _device(device, I, avecs)
    I, avecs = _tensor(I, dev), _tensor(avecs, dev)
    X, Y = _unit_grid(I.shape[0], I.shape[1], dev)
    vxs, vys = _velocityfield(avecs, I.shape, method)
    return _normsample(I, X + vxs, Y + vys, method)


def _warptransform(t, avecs, levels, method, nb: int = 0):
    warped_highpasses = list(t.highpasses)
    for level in levels:
        warped_highpasses[level] = _warphighpass(
            warped_highpasses[level], avecs, method, nb)
    return Pyramid(t.lowpass, tuple(warped_highpasses), t.scales)


def warptransform(t, avecs, levels, method=None, device=None):
    """Warp the given *levels* of a transformed image; the rest is shared
    (``dtcwt_tpu/registration.py:192-199``)."""
    t = _pyramid(t, device)
    return _warptransform(t, _tensor(avecs, t.lowpass.device), levels,
                          method)


def _shift_reflect(X, delta: int, axis: int):
    """X shifted by *delta* along *axis* with symmetric-reflect boundary
    (the end sample repeated; ``dtcwt_tpu/registration.py:202-213``)."""
    n = X.shape[axis]
    if delta > 0:
        return torch.cat([_slice(X, axis, delta, n),
                          torch.flip(_slice(X, axis, n - delta, n), (axis,))],
                         dim=axis)
    d = -delta
    return torch.cat([torch.flip(_slice(X, axis, 0, d), (axis,)),
                      _slice(X, axis, 0, n - d)], dim=axis)


def _boxfilter(X, kernel_size, nb: int = 0):
    """Separable odd-sized box filter with reflect boundary over the axes
    *nb* and *nb* + 1 (``dtcwt_tpu/registration.py:216-227``)."""
    if kernel_size % 2 == 0:
        raise ValueError("Kernel size must be odd")
    for axis in (nb, nb + 1):
        out = X
        for delta in range(1, 1 + (kernel_size - 1) // 2):
            for sgn in (+1, -1):
                out = out + _shift_reflect(X, sgn * delta, axis)
        X = out / kernel_size
    return X


def _default_levels(nlevels):
    levels = [[x for x in range(nlevels - 1, nlevels - 3, -1) if x >= 0]]
    for s in np.arange(nlevels - 1, 0, -0.5):
        refine_levels = [int(np.floor(s)) - x for x in range(2) if s - x >= 2]
        if len(refine_levels) < 2:
            continue
        levels.append(refine_levels)
    return levels


def _pyramid(p, device):
    """An interleaved pyramid of tensors: a :class:`PlanePyramid` through
    :meth:`~PlanePyramid.interleaved` (bfloat16 planes become complex64);
    tensor leaves stay where they are unless *device* is given, numpy
    leaves go to *device* (the card by default)."""
    if isinstance(p, PlanePyramid):
        p = p.interleaved()
    leaf = p.highpasses[0]
    dev = _device(device, leaf)
    if not isinstance(leaf, torch.Tensor):
        return convert.pyramid_from_numpy(p, dev)
    return p if leaf.device == dev else convert._map(p, lambda a: a.to(dev))


def _avecs_shape(source, regshape, nb: int, name: str):
    if regshape is not None:
        return tuple(regshape[:2]) + (6,)
    nlevels = len(source.highpasses)
    if nlevels < 4:
        raise ValueError(
            "%s's default registration grid is the level-4 subband shape, "
            "but the pyramid has only %d level%s; either transform with "
            "nlevels >= 4 or pass regshape explicitly."
            % (name, nlevels, "" if nlevels == 1 else "s"))
    return tuple(source.highpasses[3].shape[nb:nb + 2]) + (6,)


def _estimatereg(source, reference, avecs_shape, levels, nb: int,
                 qtilde=None):
    """The estimator of ``dtcwt_tpu/registration.py:316-338`` on pyramids
    whose leaves have *nb* leading batch axes.  *qtilde(src, ref, levels,
    total)* gives the Qtilde fields of *levels*, summed over their pixels
    where *total* (default: :func:`qtildematrices`)."""
    if qtilde is None:
        def qtilde(src, ref, lv, total):
            qts = qtildematrices(src, ref, lv)
            return [x.sum(dim=(nb, nb + 1)) for x in qts] if total else qts
    lead = tuple(source.highpasses[0].shape[:nb])
    # initial global affine estimate from the coarsest level pair
    Qt = sum(qtilde(source, reference, levels[0], True))
    a = solvetransform(Qt)
    avecs = a.reshape(lead + (1, 1, 6)).expand(lead + tuple(avecs_shape))
    # refinement: warp by the current estimate, accumulate Qtilde again,
    # smooth, rescale to the parameter grid and solve per block
    for est_levels in levels[1:]:
        warped = _warptransform(source, avecs, est_levels, "bilinear", nb)
        all_qts = qtilde(warped, reference, est_levels, False)
        if len(all_qts) < 1:
            continue
        qts = 0.0
        for x in all_qts:
            qts = qts + sampling._rescale(_boxfilter(x, 3, nb),
                                          avecs_shape[:2], "bilinear", nb)
        avecs = avecs + solvetransform(qts)
    return avecs


def _levels(levels, nlevels):
    if levels is None:
        levels = _default_levels(nlevels)
    return tuple(tuple(int(l) for l in lv) for lv in levels)


def estimatereg(source, reference, regshape=None, levels=None, device=None):
    """Estimate the registration mapping *source* onto *reference*
    (``dtcwt_tpu/registration.py:240-270``).

    Both arguments are transformed :class:`Pyramid` (or plane-layout
    :class:`PlanePyramid`) instances.  Returns an ``NxMx6`` tensor of local
    affine parameters (one per 8x8 block by default) on the pyramids'
    device; feed it to :func:`velocityfield` / :func:`warp`.
    """
    source, reference = _pyramid(source, device), _pyramid(reference, device)
    avecs_shape = _avecs_shape(source, regshape, 0, "estimatereg")
    return _estimatereg(source, reference, avecs_shape,
                        _levels(levels, len(source.highpasses)), 0)


def estimatereg_batched(source, reference, regshape=None, levels=None,
                        device=None):
    """Batched :func:`estimatereg` (``dtcwt_tpu/registration.py:273-308``):
    *source* and *reference* are pyramids whose leaves carry a leading pair
    axis (for example every neighbouring frame pair of a video GOP); returns
    ``[P, N, M, 6]`` parameter fields.  Every operation broadcasts over the
    pair axis, so the pairs run together, each op once for the batch."""
    source, reference = _pyramid(source, device), _pyramid(reference, device)
    avecs_shape = _avecs_shape(source, regshape, 1, "estimatereg_batched")
    return _estimatereg(source, reference, avecs_shape,
                        _levels(levels, len(source.highpasses)), 1)
