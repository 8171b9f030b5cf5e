#!/usr/bin/env python
"""Register two frames and save the inter-frame transform parameters, on
``dtcwt_tpu_torch``.

Usage:
    python examples/register_images_torch.py <prevframe> <nextframe> \\
        <output.npz> [--nlevels 5] [--device cuda]
    python examples/register_images_torch.py --demo <output.npz>

``--demo`` registers the tennis frame pair of the reference's test data,
``/root/reference/tests/tennis.npz``, which must be present.  Frames may be
``.npz`` / ``.npy`` arrays or (with Pillow installed) any image file;
images are converted to grayscale in [0, 1].  The output npz holds the
per-block affine parameter field ``avecs`` and the velocity field
``vxs`` / ``vys`` it implies.  ``--device cuda`` (the default) runs the
transform's kernels on the card and raises where there is none;
``--device cpu`` runs the plain PyTorch path.
"""

import argparse
import logging

import os
import sys

# Allow running straight from a checkout.
sys.path.insert(0, os.path.realpath(
    os.path.join(os.path.dirname(__file__), '..')))

import numpy as np

TENNIS = "/root/reference/tests/tennis.npz"


def load_frame(path):
    if path.endswith(".npz"):
        with np.load(path) as f:
            return np.asarray(f[list(f.keys())[0]], dtype=np.float32)
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    from PIL import Image  # optional dependency, as in the reference
    return np.asarray(Image.open(path).convert("L"), dtype=np.float32) / 255.0


def register(prev_img, next_img, nlevels=5, device="cuda"):
    """``(avecs, vxs, vys)`` as numpy arrays: the affine parameter field
    that registers *prev_img* onto *next_img*, and its bilinear velocity
    field on the parameter grid."""
    import dtcwt_tpu_torch as dt
    import dtcwt_tpu_torch.registration as reg

    t = dt.Transform2d(device=device)
    avecs = reg.estimatereg(t.forward(prev_img, nlevels=nlevels),
                            t.forward(next_img, nlevels=nlevels))
    vxs, vys = reg.velocityfield(avecs, avecs.shape[:2], method="bilinear")
    return avecs.cpu().numpy(), vxs.cpu().numpy(), vys.cpu().numpy()


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+",
                    help="<prevframe> <nextframe> <output.npz>, or with "
                         "--demo just <output.npz>")
    ap.add_argument("--demo", action="store_true",
                    help="use the tennis frame pair (%s)" % TENNIS)
    ap.add_argument("--nlevels", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO)

    if args.demo:
        (out,) = args.paths
        with np.load(TENNIS) as f:
            keys = sorted(f.keys())
            prev_img, next_img = (f[k].astype(np.float32) for k in keys[:2])
    else:
        prev_path, next_path, out = args.paths
        logging.info("Loading 'prev' image from %s", prev_path)
        prev_img = load_frame(prev_path)
        logging.info("Loading 'next' image from %s", next_path)
        next_img = load_frame(next_path)

    logging.info("Estimating registration (%d levels) on %s", args.nlevels,
                 args.device)
    avecs, vxs, vys = register(prev_img, next_img, args.nlevels, args.device)

    logging.info("Saving result to %s", out)
    np.savez_compressed(out, avecs=avecs, vxs=vxs, vys=vys)


if __name__ == "__main__":
    main()
