"""Time a 2-D level kernel, the level-1 forward ``fwd_level1``
(``csrc/level1.cu``), the level-1 inverse ``inv_level1``
(``csrc/ilevel1.cu``), the qshift forward ``fwd_level2``
(``csrc/level2.cu``) or the qshift inverse ``inv_level2``
(``csrc/ilevel2.cu``), on one NVIDIA GPU at the main path's shapes, beside
its byte bound and its plain version.

    python tools/time_level1.py level1     # from the repository's root
    python tools/time_level1.py ilevel1
    python tools/time_level1.py level2
    python tools/time_level1.py ilevel2
    python tools/time_level1.py ilevel2 kernels   # stop after the kernels

Prints the kernels' build time, then one line per layout (f32
interleaved, f32 planes, bf16 planes), family (level 1: near_sym_a,
near_sym_b, near_sym_b_bp with its third stream; the qshift levels:
qshift_a, qshift_b, qshift_b_bp) and main-path shape (4096^2; the forward
qshift level 4096^2 and 2048^2, its inverse lowpass 1024^2 and 2048^2, and
the sum of both launches): the kernel's device time (stream held), the
bound, the kernel's share of it, the plain version's time and the error
against it; for the kernels with a host-chosen tile height also the kernel
at each height it takes (level 1: 32 and 64 rows; level 2: 4, 8 and 16
quad rows; its inverse: 4 and 8 band rows); then the default and
bandpass families' 4096^2
3-level round trips in each layout and the traces (f32 interleaved) of the
round trip, the forward and the inverse: device time by kernel, the
device's idle share, the host's time to enqueue, and the round trip's
enqueue split into the level wrappers, their ctypes launches and the
transform's glue.  The helpers come from this checkout's
``chip_smoke.py``, the package from the working directory: run from the
root of another checkout (``python /path/to/tools/time_level1.py
level2``), it times that checkout's kernels.  Exits 1 if an error is over
its tolerance.
"""

import importlib.util
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
import dtcwt_tpu_torch as dt  # noqa: E402
from dtcwt_tpu_torch.ops import _build, ilevel2, level1, level2  # noqa: E402

QSHIFT_LEVELS = ("level2", "ilevel2")
FAMILIES = {"level1": ("near_sym_a", "near_sym_b", "near_sym_b_bp"),
            "ilevel1": ("near_sym_a", "near_sym_b", "near_sym_b_bp"),
            "level2": ("qshift_a", "qshift_b", "qshift_b_bp"),
            "ilevel2": ("qshift_a", "qshift_b", "qshift_b_bp")}
# the tile heights of each kernel whose host chooses one: (module,
# geometry, keyword, values)
TILES = {"level1": (level1, "_level1_geometry", "th", (32, 64)),
         "level2": (level2, "_level2_geometry", "qh", (4, 8, 16)),
         "ilevel2": (ilevel2, "_ilevel2_geometry", "qh", (4, 8))}


def tile_heights(name, kern, plain, bms, dtype, what) -> int:
    """Time a kernel at each tile height it takes; return the number of
    errors over tolerance."""
    mod, attr, key, values = TILES[name]
    geometry = getattr(mod, attr, None)
    if geometry is None:           # a checkout without this tiling
        return 0
    bad = 0
    for v in values:
        def forced(*a, _v=v, **k):
            return geometry(*a, **dict(k, **{key: _v}))
        with cs.patched([(mod, attr, forced)]):
            e = cs.rel_err(kern(), plain())
            bad += e > cs.TOL[dtype]
            tms = cs.cuda_ms(kern, hold=True, reps=20)
        print("%s %s, %s %d: kernel %.4f ms, %.1f%% of the bound, rel err "
              "%.3g" % (name, what, key, v, tms, 100 * bms / tms, e),
              flush=True)
    return bad


def main() -> int:
    name = sys.argv[1] if len(sys.argv) > 1 else ""
    if name not in FAMILIES or sys.argv[2:] not in ([], ["kernels"]):
        raise SystemExit("usage: python tools/time_level1.py "
                         "level1|ilevel1|level2|ilevel2 [kernels]")
    if not torch.cuda.is_available():
        raise SystemExit("time_level1: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print("package: %s" % os.path.dirname(dt.__file__), flush=True)
    t0 = time.perf_counter()
    _build.library()
    print("build: %.1f s" % (time.perf_counter() - t0), flush=True)
    bad = 0
    shapes = (cs.MAIN_SHAPES_2D[name] if name in QSHIFT_LEVELS
              else [(cs.N, cs.N)])
    for label, dtype, layout in cs.LAYOUTS:
        pl = layout == "planes"
        inps = [cs.level_inputs(name, s, dtype, pl, dev) for s in shapes]
        for fam in FAMILIES[name]:
            if name in QSHIFT_LEVELS:
                bb, qq = dt.biort("near_sym_a"), dt.qshift(fam)
            else:
                bb, qq = dt.biort(fam), dt.qshift("qshift_a")
            tot = [0.0, 0.0, 0.0]
            for shape, inp in zip(shapes, inps):
                kern, plain = cs.level_call(name, inp, pl, bb, qq)
                got = kern()
                torch.cuda.synchronize()
                err = cs.rel_err(got, plain())
                bad += err > cs.TOL[dtype]
                bms, by = cs.bound(cs.nbytes(inp) + cs.nbytes(got),
                                   cs.level_macs(name, inp, bb, qq))
                del got
                ms = cs.cuda_ms(kern, hold=True, reps=20)
                pms = cs.cuda_ms(plain, hold=True, reps=5)
                for k, v in enumerate((ms, bms, pms)):
                    tot[k] += v
                what = "%s %s %s" % (fam, "x".join(map(str, shape)), label)
                print("%s %s: kernel %.4f ms, bound %.4f ms (%s), %.1f%% of "
                      "the bound, plain %.4f ms, rel err %.3g (tol %g)" % (
                          name, what, ms, bms, by, 100 * bms / ms, pms, err,
                          cs.TOL[dtype]), flush=True)
                if name in TILES:
                    bad += tile_heights(name, kern, plain, bms, dtype, what)
                del kern, plain
            if len(shapes) > 1:
                print("%s %s %s, its %d launches of one round trip: kernel "
                      "%.4f ms, bound %.4f ms, %.1f%% of the bound, plain "
                      "%.4f ms" % (name, fam, label, len(shapes), tot[0],
                                   tot[1], 100 * tot[1] / tot[0], tot[2]),
                      flush=True)
        del inps
    if sys.argv[2:] == ["kernels"]:
        print("errors over tolerance: %d" % bad)
        return 1 if bad else 0
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
        cs.print_host_split("round trip 2-D %sf32 interleaved" % what,
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
