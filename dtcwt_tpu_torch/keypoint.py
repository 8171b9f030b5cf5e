"""Multiscale keypoint detection from DTCWT highpass subbands
(``dtcwt_tpu.keypoint``).

Energies: 'fauqueur' (geometric-mean style, Fauqueur/Kingsbury/Anderson
ICIP 2006), 'bendale' (min abs, Bendale/Triggs/Kingsbury BMVC 2010),
'kingsbury' (cross-product of orthogonal subbands).

The detector is dense device math, as in the JAX package: 3x3
neighbourhood maxima, quadratic sub-pixel refinement through the
closed-form nullspace of the 2x3 gradient system (the cross product of its
rows), and one ``torch.topk`` where ``max_points`` is set.  It stays on the
highpasses' device and reads nothing back until the final trim of the
non-finite rows.
"""

from __future__ import annotations

import torch

from dtcwt_tpu_torch.sampling import (
    _device, _tensor, _upsample, upsample_highpass)

__all__ = ["find_keypoints"]


def _keypoint_energy_fauqueur(subband, alpha, beta, scale):
    prod = torch.prod(torch.abs(subband), dim=2)
    return (alpha ** (scale + 1)) * torch.clamp_min(prod, 0) ** beta


def _keypoint_energy_bendale(subband):
    return torch.amin(torch.abs(subband), dim=2)


def _keypoint_energy_kingsbury(subband, kappa=1.0 / 6.0, epsilon=1e-8):
    abs_Y = torch.abs(subband)
    A = torch.sqrt(torch.sum(abs_Y * abs_Y, dim=2))
    B = torch.sum(abs_Y[:, :, :3] * abs_Y[:, :, 3:], dim=2)
    return torch.clamp_min(B / torch.clamp_min(A, epsilon) - kappa * A, 0)


def _gradient(x, axis: int):
    """``jnp.gradient`` along *axis* with unit spacing: one-sided
    differences at the ends, central ones between."""
    n = x.shape[axis]
    if n < 2:
        raise ValueError("Shape of array too small to calculate a numerical "
                         "gradient, at least 2 elements are required.")
    s = lambda a, b: x.narrow(axis, a, b - a)
    return torch.cat((s(1, 2) - s(0, 1), (s(2, n) - s(0, n - 2)) * 0.5,
                      s(n - 1, n) - s(n - 2, n - 1)), dim=axis)


def _kp_energy_maxima_dense(X, threshold=None, refine=True):
    """Dense maps of local-maxima candidates of an energy map
    (``dtcwt_tpu/keypoint.py:49-105``).

    Returns ``(mask, x_off, y_off, vals)``, same-shape tensors: *mask* marks
    candidate maxima, *x_off* / *y_off* are the sub-pixel refinement
    offsets and *vals* the (refined) energies.
    """
    h, w = X.shape
    thr = (X.min() - 1) if threshold is None else torch.full(
        (), threshold, dtype=X.dtype, device=X.device)

    # 3x3 neighbourhood max over the window rows / columns 1 .. n - 3;
    # everything else stays at the threshold so border pixels never match
    interior = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            v = X[1 + dy:h - 2 + dy, 1 + dx:w - 2 + dx]
            interior = v if interior is None else torch.maximum(interior, v)
    interior = torch.maximum(interior, thr)
    maxima = thr.expand(X.shape).clone()
    maxima[1:-2, 1:-2] = interior
    mask = maxima == X

    if not refine:
        z = torch.zeros_like(X)
        return mask, z, z, X

    dXdy, dXdx = _gradient(X, 0), _gradient(X, 1)
    dX2dxdy, dX2dx2 = _gradient(dXdx, 0), _gradient(dXdx, 1)
    dX2dy2 = _gradient(dXdy, 0)
    a0, a1, a2 = dX2dx2, dX2dy2, dX2dxdy
    a3, a4, a5 = dXdx, dXdy, X

    # Quadratic fit f(x,y) = a0 x^2 + a1 y^2 + a2 xy + a3 x + a4 y + a5;
    # its stationary point solves the 2x3 homogeneous system
    #   [2*a0  a2  a3] [x]
    #   [ a2 2*a1  a4] [y]  = 0  with the hidden 1 as third coordinate:
    #                  [1]
    # the nullspace direction is the cross product of the two rows.
    v0 = a2 * a4 - 2.0 * a1 * a3
    v1 = a3 * a2 - 2.0 * a0 * a4
    v2 = 4.0 * a0 * a1 - a2 * a2
    safe = torch.abs(v2) > torch.full((), 1e-30, dtype=X.dtype,
                                      device=X.device)
    denom = torch.where(safe, v2, 1.0)
    x = torch.where(safe, v0 / denom, float("inf"))
    y = torch.where(safe, v1 / denom, float("inf"))

    # keep only fits whose maximum lies within half a pixel
    ok = (torch.abs(x) <= 0.5) & (torch.abs(y) <= 0.5)
    x = torch.where(ok, x, 0.0)
    y = torch.where(ok, y, 0.0)
    vals = (a0 * x * x + a1 * y * y + a2 * x * y + a3 * x + a4 * y + a5)
    return mask & ok, x, y, vals


def _level_maps(kp_energy, kp_scale, threshold, refine):
    """One level's candidate maps, flattened: (vals, xs, ys, scales)
    (``dtcwt_tpu/keypoint.py:108-122``)."""
    mask, x_off, y_off, vals = _kp_energy_maxima_dense(
        kp_energy, threshold=threshold, refine=refine)
    h, w = kp_energy.shape
    cols = torch.arange(w, dtype=vals.dtype, device=vals.device)
    rows = torch.arange(h, dtype=vals.dtype, device=vals.device)[:, None]
    # pixel (0 .. M-1) extent is (-0.5, M-0.5]; scaling by kp_scale maps
    # x -> kp_scale * (x + 0.5) - 0.5
    xs = (cols + x_off + 0.5) * kp_scale - 0.5
    ys = (rows + y_off + 0.5) * kp_scale - 0.5
    vals = torch.where(mask, vals, float("-inf"))
    scales = torch.full_like(vals, kp_scale)
    return (vals.reshape(-1), xs.reshape(-1), ys.reshape(-1),
            scales.reshape(-1))


def _detect(hps, alpha, beta, kappa, threshold, *, method, refine,
            skip_levels, upsample_scale, uhp, uke, max_points):
    """The whole detector on the device (``dtcwt_tpu/keypoint.py:125-160``):
    ``[k, 4]`` rows in ``torch.topk`` order where *max_points* is set,
    else the flattened (vals, xs, ys, scales) of every level."""
    parts = []
    for scale, subband in enumerate(hps):
        if uhp is not None:
            subband = upsample_highpass(subband, uhp)
        if method == "fauqueur":
            e = _keypoint_energy_fauqueur(subband, alpha, beta, scale)
        elif method == "bendale":
            e = _keypoint_energy_bendale(subband)
        else:
            e = _keypoint_energy_kingsbury(subband, kappa)
        if uke is not None:
            e = _upsample(e, uke)
        kp_scale = 2 ** (scale + 1 + skip_levels) / float(upsample_scale)
        parts.append(_level_maps(e, kp_scale, threshold, refine))

    vals, xs, ys, scales = (torch.cat([p[i] for p in parts])
                            for i in range(4))
    if max_points is not None:
        k = min(int(max_points), vals.shape[0])
        top_vals, top_idx = torch.topk(vals, k, sorted=True)
        return torch.stack((xs[top_idx], ys[top_idx], scales[top_idx],
                            top_vals), dim=-1)
    return vals, xs, ys, scales


def find_keypoints(highpass_highpasses, method=None,
                   alpha=1.0, beta=0.4, kappa=1.0 / 6.0,
                   threshold=None, max_points=None,
                   upsample_keypoint_energy=None, upsample_highpasses=None,
                   refine_positions=True, skip_levels=1, device=None):
    """Find multiscale keypoints from a tuple of (NxMx6) highpass levels
    (``dtcwt_tpu/keypoint.py:163-205``).

    Returns a ``(P, 4)`` tensor of rows ``(x, y, scale, energy)`` on the
    highpasses' device, by decreasing energy (``torch.topk``'s order where
    *max_points* is set, else a stable descending sort).  *threshold* and
    *max_points* compose, and *skip_levels* ignores the noisiest fine
    scales.  When no candidate survives, the result is an empty ``(0, 4)``
    tensor.  The one read back to the host is the final trim of the
    non-finite rows.
    """
    method = method or "fauqueur"
    if method not in ("fauqueur", "bendale", "kingsbury"):
        raise ValueError("Unknown method: {0}".format(method))
    dev = _device(device, *highpass_highpasses)
    hps = tuple(_tensor(h, dev) for h in highpass_highpasses[skip_levels:])
    if not hps:
        return torch.zeros((0, 4), dtype=torch.float64, device=dev)

    upsample_scale = 1
    if upsample_highpasses is not None:
        upsample_scale <<= 1
    if upsample_keypoint_energy is not None:
        upsample_scale <<= 1

    out = _detect(hps, alpha, beta, kappa, threshold, method=method,
                  refine=bool(refine_positions), skip_levels=skip_levels,
                  upsample_scale=upsample_scale, uhp=upsample_highpasses,
                  uke=upsample_keypoint_energy,
                  max_points=None if max_points is None else int(max_points))

    if max_points is not None:
        return out[torch.isfinite(out[:, 3])]

    # unbounded point count: sort every candidate by descending energy on
    # the device, then keep the finite ones (they sort first)
    vals, xs, ys, scales = out
    finite = torch.isfinite(vals)
    order = torch.argsort(torch.where(finite, vals, float("-inf")),
                          descending=True, stable=True)
    order = order[:int(finite.sum())]
    return torch.stack((xs[order], ys[order], scales[order], vals[order]),
                       dim=-1)
