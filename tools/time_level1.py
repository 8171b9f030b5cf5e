"""Time the 2-D level-1 forward kernel ``fwd_level1`` (``csrc/level1.cu``) on
one NVIDIA GPU at the main path's shape, 4096^2, beside its byte bound and
its plain version.

    python tools/time_level1.py      # from the repository's root

Prints one line per family (near_sym_a, near_sym_b, near_sym_b_bp with its
third stream) and layout (f32 interleaved, f32 planes, bf16 planes): the
kernel's device time (stream held), the bound, the kernel's share of it,
the plain version's time and the error against it; for near_sym_a also the
kernel at each tile height the kernel takes (32 and 64 rows); then the
default families' 4096^2 3-level round trip and its trace.  It uses
``chip_smoke.py``'s helpers and builds the kernels from ``csrc/``; run from
the root of another checkout, it times that checkout's kernel (one
without ``_level1_geometry`` skips the tile heights).  Exits 1 if an error
is over its tolerance.
"""

import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
import dtcwt_tpu_torch as dt  # noqa: E402
from dtcwt_tpu_torch.ops import _build, level1  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("time_level1: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.library()
    q = dt.qshift("qshift_a")
    bad = 0
    for fam in ("near_sym_a", "near_sym_b", "near_sym_b_bp"):
        bb = dt.biort(fam)
        for label, dtype, layout in cs.LAYOUTS:
            pl = layout == "planes"
            inp = cs.level_inputs("level1", (cs.N, cs.N), dtype, pl, dev)
            kern, plain = cs.level_call("level1", inp, pl, bb, q)
            got = kern()
            torch.cuda.synchronize()
            err = cs.rel_err(got, plain())
            bad += err > cs.TOL[dtype]
            bms, by = cs.bound(cs.nbytes(inp) + cs.nbytes(got),
                               cs.level_macs("level1", inp, bb, q))
            del got
            ms = cs.cuda_ms(kern, hold=True, reps=20)
            pms = cs.cuda_ms(plain, hold=True, reps=5)
            print("level1 %s %dx%d %s: kernel %.4f ms, bound %.4f ms "
                  "(%s), %.1f%% of the bound, plain %.4f ms, rel err %.3g "
                  "(tol %g)" % (fam, cs.N, cs.N, label, ms, bms, by,
                                100 * bms / ms, pms, err, cs.TOL[dtype]),
                  flush=True)
            geometry = getattr(level1, "_level1_geometry", None)
            if fam == "near_sym_a" and geometry is not None:
                for th in (32, 64):
                    def forced(*a, _th=th, **k):
                        return geometry(*a, **k, th=_th)
                    with cs.patched([(level1, "_level1_geometry", forced)]):
                        e = cs.rel_err(kern(), plain())
                        bad += e > cs.TOL[dtype]
                        tms = cs.cuda_ms(kern, hold=True, reps=20)
                    print("level1 %s %dx%d %s, tiles of %d rows: kernel "
                          "%.4f ms, %.1f%% of the bound, rel err %.3g" % (
                              fam, cs.N, cs.N, label, th, tms,
                              100 * bms / tms, e),
                          flush=True)
            del inp, kern, plain
    t = dt.Transform2d()
    x = cs.rand((cs.N, cs.N), 0, dev, torch.float32)
    for label, dtype, layout in cs.LAYOUTS:
        xd = x.to(dtype)
        ms = cs.cuda_ms(lambda: t.inverse(t.forward(xd, cs.NLEVELS,
                                                    layout=layout)), reps=20)
        print("round trip 2-D %dx%d %d levels %s: %.3f ms" % (
            cs.N, cs.N, cs.NLEVELS, label, ms), flush=True)
    cs.print_trace("round trip 2-D f32 interleaved", lambda: t.inverse(
        t.forward(x, cs.NLEVELS)))
    print("errors over tolerance: %d" % bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
