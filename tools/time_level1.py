"""Time a 2-D level-1 kernel, the forward ``fwd_level1`` (``csrc/level1.cu``)
or the inverse ``inv_level1`` (``csrc/ilevel1.cu``), on one NVIDIA GPU at
the main path's shape, 4096^2, beside its byte bound and its plain version.

    python tools/time_level1.py level1     # from the repository's root
    python tools/time_level1.py ilevel1

Prints the kernels' build time, then one line per layout (f32
interleaved, f32 planes, bf16 planes) and family (near_sym_a,
near_sym_b, near_sym_b_bp with its third stream): the kernel's device
time (stream held), the bound, the kernel's share of it, the plain
version's time and the error against it; for the forward and near_sym_a
also the kernel at each tile height it takes (32 and 64 rows); then the
default and bandpass families' 4096^2 3-level round trips in each layout
and the traces (f32 interleaved) of the round trip, the forward and the
inverse: device time by kernel, the device's idle share, the host's time
to enqueue.  It uses ``chip_smoke.py``'s helpers and builds the kernels
from ``csrc/``; run from the root of another checkout, it times that
checkout's kernels.  Exits 1 if an error is over its tolerance.
"""

import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
import dtcwt_tpu_torch as dt  # noqa: E402
from dtcwt_tpu_torch.ops import _build, level1  # noqa: E402

FAMILIES = ("near_sym_a", "near_sym_b", "near_sym_b_bp")


def tile_heights(kern, plain, bms, dtype, label) -> int:
    """Time the forward kernel at each tile height it takes; return the
    number of errors over tolerance."""
    bad = 0
    geometry = level1._level1_geometry
    for th in (32, 64):
        def forced(*a, _th=th, **k):
            return geometry(*a, **k, th=_th)
        with cs.patched([(level1, "_level1_geometry", forced)]):
            e = cs.rel_err(kern(), plain())
            bad += e > cs.TOL[dtype]
            tms = cs.cuda_ms(kern, hold=True, reps=20)
        print("level1 near_sym_a %dx%d %s, tiles of %d rows: kernel %.4f ms, "
              "%.1f%% of the bound, rel err %.3g" % (
                  cs.N, cs.N, label, th, tms, 100 * bms / tms, e), flush=True)
    return bad


def main() -> int:
    name = sys.argv[1] if len(sys.argv) > 1 else ""
    if name not in ("level1", "ilevel1"):
        raise SystemExit("usage: python tools/time_level1.py level1|ilevel1")
    if not torch.cuda.is_available():
        raise SystemExit("time_level1: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    print("build: %.1f s" % (time.perf_counter() - t0), flush=True)
    q = dt.qshift("qshift_a")
    bad = 0
    for label, dtype, layout in cs.LAYOUTS:
        pl = layout == "planes"
        inp = cs.level_inputs(name, (cs.N, cs.N), dtype, pl, dev)
        for fam in FAMILIES:
            bb = dt.biort(fam)
            kern, plain = cs.level_call(name, inp, pl, bb, q)
            got = kern()
            torch.cuda.synchronize()
            err = cs.rel_err(got, plain())
            bad += err > cs.TOL[dtype]
            bms, by = cs.bound(cs.nbytes(inp) + cs.nbytes(got),
                               cs.level_macs(name, inp, bb, q))
            del got
            ms = cs.cuda_ms(kern, hold=True, reps=20)
            pms = cs.cuda_ms(plain, hold=True, reps=5)
            print("%s %s %dx%d %s: kernel %.4f ms, bound %.4f ms (%s), "
                  "%.1f%% of the bound, plain %.4f ms, rel err %.3g (tol %g)"
                  % (name, fam, cs.N, cs.N, label, ms, bms, by,
                     100 * bms / ms, pms, err, cs.TOL[dtype]), flush=True)
            if name == "level1" and fam == "near_sym_a":
                bad += tile_heights(kern, plain, bms, dtype, label)
            del kern, plain
        del inp
    x = cs.rand((cs.N, cs.N), 0, dev, torch.float32)
    for fams in ((), cs.BP_FAMS):
        t = dt.Transform2d(*fams)
        what = "bandpass " if fams else ""
        for label, dtype, layout in cs.LAYOUTS:
            xd = x.to(dtype)
            ms = cs.cuda_ms(lambda: t.inverse(t.forward(xd, cs.NLEVELS,
                                                        layout=layout)),
                            reps=20)
            print("round trip 2-D %s%dx%d %d levels %s: %.3f ms" % (
                what, cs.N, cs.N, cs.NLEVELS, label, ms), flush=True)
        cs.print_trace("round trip 2-D %sf32 interleaved" % what,
                       lambda: t.inverse(t.forward(x, cs.NLEVELS)))
        p = t.forward(x, cs.NLEVELS)
        cs.print_trace("forward 2-D %sf32 interleaved" % what,
                       lambda: t.forward(x, cs.NLEVELS))
        cs.print_trace("inverse 2-D %sf32 interleaved" % what,
                       lambda: t.inverse(p))
        del p
    print("errors over tolerance: %d" % bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
