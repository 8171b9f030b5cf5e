"""Plotting of DTCWT coefficients (``dtcwt_tpu.plotting``).

matplotlib is optional: importing this module does not need it, calling
:func:`overlay_quiver` does.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ("overlay_quiver",)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def overlay_quiver(image, vectorField, level, offset):
    """Overlay a coloured quiver plot of complex subband coefficients on a
    grayscale image (values in [0, 255]): a phase visualisation.

    :param image: grayscale background image, values in [0, 255] (tensor
        or array)
    :param vectorField: an ``[M, N, 6]`` complex coefficient tensor or array
    :param level: 1-indexed transform level of *vectorField*
    :param offset: subband grid offset in units of ``2**level`` (typ. 0.5)
    :returns: the last quiver handle
    """
    import matplotlib.pyplot as plt
    from matplotlib import cm

    vectorField = np.array(_host(vectorField))  # a host copy, mutated below
    plt.imshow(_host(image), cmap=cm.gray, clim=(0, 255))

    rows, cols = vectorField.shape[0], vectorField.shape[1]
    g1, g2 = np.mgrid[0:rows, 0:cols]

    # 'spectral' was removed from matplotlib; nipy_spectral is its successor
    cmap = getattr(cm, "spectral", None) or cm.nipy_spectral
    scalefactor = np.abs(vectorField).max()
    vectorField[-1, -1, :] = scalefactor

    sc = 2 ** level
    hq = None
    for sb in range(vectorField.shape[2]):
        colour = cmap(sb / float(vectorField.shape[2]))
        hq = plt.quiver(g2 * sc + offset * sc, g1 * sc + offset * sc,
                        np.real(vectorField[:, :, sb]),
                        np.imag(vectorField[:, :, sb]),
                        color=colour, scale=scalefactor * sc)
        plt.quiverkey(hq, 1.05, 1.00 - 0.035 * sb, 0, "subband %d" % sb,
                      coordinates="axes", color=colour, labelcolor=colour,
                      labelpos="E")
    return hq
