"""Time the ``filter`` kernel (``csrc/filter.cu``) on one NVIDIA GPU at the
main path's shapes, beside one ``F.conv2d`` (TF32 off) and the byte bound.

    python tools/time_filter.py      # from the repository's root

Prints one line per call: the six passes of the 256^3 ``discard_level_1``
round trip (f32), the four ``colfilter`` / ``rowfilter`` calls of the
4096^2 low-level path (f32 and bf16) and one 4 194 304-sample vector, each
with the kernel's device time (stream held), the library call's, the
bound, the kernel's share of it and its error against the plain version.
It uses ``chip_smoke.py``'s helpers and builds the kernels from ``csrc/``.
"""

import sys

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from dtcwt_tpu_torch.ops import _build  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_filter: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.library()
    x = cs.rand((cs.VOL,) * 3, 23, dev, torch.float32)
    tk = tl = tb = 0.0
    for f, axis in cs.discard_calls():
        kern, plain = cs.single_call("filter", x, f, axis)
        out = kern()
        err = cs.rel_err(out, plain())
        bms, _ = cs.bound(cs.nbytes(x) + cs.nbytes(out),
                          cs.single_macs("filter", f, out))
        ms = cs.cuda_ms(kern, hold=True, reps=20)
        lib, _ = cs.conv_filter(x, f[0], axis)
        lms = cs.cuda_ms(lib, hold=True, reps=20)
        tk, tl, tb = tk + ms, tl + lms, tb + bms
        print("256^3 axis %d m=%d: kernel %.4f conv %.4f bound %.4f share "
              "%.1f%% err %.3g" % (axis, np.asarray(f[0]).size, ms, lms, bms,
                                   100 * bms / ms, err), flush=True)
    print("six passes: kernel %.4f conv %.4f bound %.4f" % (tk, tl, tb))
    img = cs.rand((cs.N, cs.N), 21, dev, torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        xd = img.to(dtype)
        for name, fn, f, axis in cs.lowlevel_calls():
            if name != "filter":
                continue
            kern, plain = cs.single_call(name, xd, f, axis)
            out = kern()
            err = cs.rel_err(out, plain())
            bms, _ = cs.bound(cs.nbytes(xd) + cs.nbytes(out),
                              cs.single_macs(name, f, out))
            ms = cs.cuda_ms(kern, hold=True, reps=20)
            lib, _ = cs.conv_filter(xd, f[0], axis)
            lms = cs.cuda_ms(lib, hold=True, reps=20)
            print("4096^2 %s %s m=%d: kernel %.4f conv %.4f bound %.4f share "
                  "%.1f%% err %.3g" % (fn, dtype, np.asarray(f[0]).size, ms,
                                       lms, bms, 100 * bms / ms, err),
                  flush=True)
    v = cs.rand((cs.NVEC,), 3, dev, torch.float32)
    kern, plain = cs.single_call("filter", v, (np.ones(7) / 7,), 0)
    out = kern()
    print("4M vector err %.3g kernel %.4f ms" % (
        cs.rel_err(out, plain()), cs.cuda_ms(kern, hold=True, reps=20)))


if __name__ == "__main__":
    main()
