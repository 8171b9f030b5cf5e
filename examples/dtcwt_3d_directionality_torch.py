#!/usr/bin/env python
"""The directional selectivity of the 28 3-D DTCWT subbands, on
``dtcwt_tpu_torch``.

Transform a zero volume, set one subband's centre coefficient at a time,
invert (28 ``Transform3d.inverse`` calls: on the card its synthesis
kernels, and the dual kernels along depth), and locate each reconstructed
wavelet's dominant orientation from the peak of its spectrum.  Prints the
unit direction vector of each subband and saves the wavelets.

Usage:
    python examples/dtcwt_3d_directionality_torch.py [output.npz] \\
        [--size 32] [--level 2] [--device cuda]
"""

import argparse

import os
import sys

# Allow running straight from a checkout.
sys.path.insert(0, os.path.realpath(
    os.path.join(os.path.dirname(__file__), '..')))

import numpy as np


def directions(size=32, level=2, device="cuda"):
    """``(dirs [28, 3], wavelets [28, size, size, size])`` as numpy arrays:
    each subband's reconstructed wavelet at level *level* of a *size*^3
    volume and the unit vector of its spectrum's peak frequency."""
    import torch
    import dtcwt_tpu_torch as dt

    t = dt.Transform3d(biort="near_sym_a", qshift="qshift_a", device=device)
    pyr = t.forward(np.zeros((size,) * 3, np.float32), nlevels=level)
    hp = torch.zeros_like(pyr.highpasses[level - 1])
    c = tuple(s // 2 for s in hp.shape[:3])

    waves, dirs = [], []
    for band in range(28):
        hp_b = hp.clone()
        hp_b[c + (band,)] = 1.0
        bands = tuple(pyr.highpasses[:level - 1]) + (hp_b,)
        rec = t.inverse(dt.Pyramid(pyr.lowpass, bands)).cpu().numpy()
        waves.append(rec)

        # dominant orientation: the centre frequency of the wavelet, the
        # peak of its spectrum's magnitude
        F = np.fft.fftn(rec)
        k = np.unravel_index(np.argmax(np.abs(F)), F.shape)
        freq = np.array([(ki if ki <= s // 2 else ki - s)
                         for ki, s in zip(k, F.shape)], float)
        n = np.linalg.norm(freq)
        dirs.append(freq / n if n else freq)
    return np.stack(dirs), np.stack(waves)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("output", nargs="?", default="dtcwt3d_directions.npz")
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--level", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dirs, waves = directions(args.size, args.level, args.device)
    for band, d in enumerate(dirs):
        print("subband %2d: direction (%+.2f, %+.2f, %+.2f)"
              % (band, d[0], d[1], d[2]))

    np.savez_compressed(args.output, directions=dirs, wavelets=waves)
    print("saved", args.output)


if __name__ == "__main__":
    main()
