#!/usr/bin/env python
"""Phase-aware resampling of DTCWT highpass subbands, on
``dtcwt_tpu_torch``.

Upsampling a complex subband without phase handling smears its
directional phase ramps; ``sampling.rescale_highpass`` unwraps each
subband's expected phase, interpolates the slowly varying residual and
rewraps it.  This example takes the level-3 subbands of the half-size
mandrill image, upsamples them x2 both ways, and compares each with the
level-3 subbands of the full-size image.  It reads the reference's test
image ``/root/reference/tests/mandrill.npz``, which must be present;
``resample(img, device)`` runs the same steps on any image.

Usage:
    python examples/resampling_highpass_coefficients_torch.py \\
        [output.npz] [--device cuda]
"""

import argparse

import os
import sys

# Allow running straight from a checkout.
sys.path.insert(0, os.path.realpath(
    os.path.join(os.path.dirname(__file__), '..')))

import numpy as np

MANDRILL = "/root/reference/tests/mandrill.npz"


def resample(img, device="cuda", nlevels=3, method="lanczos"):
    """The naive and phase-aware x2 upsamplings of the level-*nlevels*
    subbands of ``img[::2, ::2]`` and the same level's subbands of *img*
    (the target), as a dict of numpy arrays ``naive``, ``phase_aware``,
    ``reference``."""
    import dtcwt_tpu_torch as dt
    from dtcwt_tpu_torch import sampling

    t = dt.Transform2d(device=device)
    img = np.asarray(img)
    sb_small = t.forward(img[::2, ::2], nlevels=nlevels).highpasses[-1]
    sb_big = t.forward(img, nlevels=nlevels).highpasses[-1]
    shape = tuple(sb_big.shape[:2])
    return {"naive": sampling.rescale(sb_small, shape, method).cpu().numpy(),
            "phase_aware": sampling.rescale_highpass(
                sb_small, shape, method).cpu().numpy(),
            "reference": sb_big.cpu().numpy()}


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("output", nargs="?", default="resampled_highpass.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    with np.load(MANDRILL) as f:
        img = f["mandrill"].astype(np.float32)
    out = resample(img, args.device)
    err_naive = np.abs(out["naive"] - out["reference"]).mean()
    err_aware = np.abs(out["phase_aware"] - out["reference"]).mean()
    print("mean |err| vs true subband: naive=%.5f phase-aware=%.5f (%.1fx"
          " better)" % (err_naive, err_aware, err_naive / err_aware))

    np.savez_compressed(args.output, **out)
    print("saved", args.output)


if __name__ == "__main__":
    main()
