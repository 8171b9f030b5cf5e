"""Time the four 3-D level kernels (``csrc/fpack.cu``, ``csrc/pack3d.cu``) on
one NVIDIA GPU at the main path's volumes, beside their byte bound and plain
versions.

    python tools/time_pack3d.py            # from the repository's root
    python tools/time_pack3d.py kernels    # stop after the kernel lines

Prints the card (``nvidia-smi`` name and power limit), the kernels' build
time and what ``nvcc -Xptxas -v`` reports for each instance of the
analysis kernel ``fwd_pack_kernel`` (``csrc/fpack.cu``) and of the
synthesis kernel ``inv_pack_kernel`` (``csrc/pack3d.cu``): registers,
shared memory, spills, and for the analysis instances the blocks an SM
that the registers and the host's dynamic shared memory leave.  Then one
line per kernel, layout (f32 interleaved, f32 planes, bf16
planes) and volume of the 256^3 3-level round trip: the kernel stage's
device time (stream held; the depth stage already run), the bound, the
kernel's share of it, the plain version's time and the error against it,
and the sum over the round trip's launches.  The inverse kernels
``inv_level1_pack`` and ``inv_level2_pack`` come first, then the forward
ones.  Then,
unless ``kernels`` is given: the 3-D round trip in each layout, the traces
of its f32 interleaved and f32 planes forms (device time by kernel, idle
share, host enqueue), the two-sided hw kernels of the sharded path (f32,
one launch per shard of the (1, 4) card mesh) and the trace of the 2-D
4096^2 round trip, so that the kernels a change should not move are
measured in the same call.  The helpers come from this checkout's
``chip_smoke.py``, the package from the working directory: run from the
root of another checkout (``python /path/to/tools/time_pack3d.py``), it
times that checkout's kernels.  Exits 1 if an error is over its tolerance.
"""

import importlib.util
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.getcwd())
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
import dtcwt_tpu_torch as dt  # noqa: E402
from dtcwt_tpu_torch.ops import _build  # noqa: E402

PACK_ORDER = ("inv_level1_pack", "inv_level2_pack", "fwd_level1_pack",
              "fwd_level2_pack")
CONTROL_HW = ("filter_hw22", "dfilt_hw22", "filter_sum_hw22",
              "ifilt_sum_hw22")


def ptxas_start(work):
    """Start ``nvcc -Xptxas -v`` on ``fpack.cu`` and ``pack3d.cu`` (objects
    in *work*)."""
    return [subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         _build.CSRC, "-c", "-o", os.path.join(work, src + ".o"),
         os.path.join(_build.CSRC, src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in ("fpack.cu", "pack3d.cu")]


# the analysis instance fwd_pack_kernel<T, PLANES, P, MT> in a mangled name
_FWD_NAME = re.compile(r"fwd_pack_kernelI(f|d|13__nv_bfloat16)Lb([01])E"
                       r"Li(\d+)ELi(\d+)E")
_DTYPES = {"f": torch.float32, "d": torch.float64,
           "13__nv_bfloat16": torch.bfloat16}


def _blocks_an_sm(regs: int, smem: int) -> int:
    """Blocks of 256 threads an H100 SM holds: 2048 threads, 65536
    registers allocated a warp at a time in units of 256, 228 KB of
    shared memory (1 KB of it a block's)."""
    warp_regs = -(-regs * 32 // 256) * 256
    return min(2048 // 256, 65536 // warp_regs // 8, 233472 // (smem + 1024))


def ptxas_print(procs) -> None:
    """Print the resource lines of ptxas's report for each instance of the
    two kernels, and the analysis instances' blocks an SM."""
    from dtcwt_tpu_torch.ops import hwtile
    for proc in procs:
        out, _ = proc.communicate()
        name = label = None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = label = None
                f = _FWD_NAME.search(m.group(1))
                if f:
                    label = (_DTYPES[f.group(1)], f.group(2) == "1",
                             int(f.group(3)), int(f.group(4)))
                    name = "fwd_pack_kernel<%s, %s, P=%d, MT=%d>" % (
                        str(label[0]).split(".")[-1],
                        "planes" if label[1] else "interleaved", *label[2:])
                elif "inv_pack_kernel" in m.group(1):
                    name = m.group(1)
                continue
            if name and ("Used" in line or "spill" in line):
                print("ptxas %s: %s" % (name, line.split(" : ")[-1].strip()),
                      flush=True)
                r = re.search(r"Used (\d+) registers", line)
                if label and r:
                    dtype, planes, P, mt = label
                    smem = hwtile._fwd_pack_geometry(P, mt, dtype,
                                                     planes).smem
                    print("ptxas %s: dynamic shared memory %d bytes, %d "
                          "blocks an SM" % (name, smem, _blocks_an_sm(
                              int(r.group(1)), smem)), flush=True)
        if proc.returncode:
            print("ptxas report failed (exit %d):\n%s" % (proc.returncode,
                                                          out))


def time_kernels(dev) -> int:
    """The kernel lines; returns the number of errors over tolerance."""
    bad = 0
    for name in PACK_ORDER:
        for label, dtype, layout in cs.LAYOUTS:
            pl = layout == "planes"
            tot = [0.0, 0.0, 0.0]
            for vol in cs.PACK_VOLS[name]:
                _, _, stage, stage_plain, ins = cs.pack_case(
                    name, vol, dtype, pl, dev)
                outs = stage()
                torch.cuda.synchronize()
                err = cs.rel_err(outs, stage_plain())
                bad += err > cs.TOL[dtype]
                bms, by = cs.bound(cs.nbytes(ins) + cs.nbytes(outs),
                                   cs.pack_macs(name, ins, outs))
                del outs
                ms = cs.cuda_ms(stage, hold=True, reps=20)
                pms = cs.cuda_ms(stage_plain, hold=True, reps=3, warmup=1)
                for k, v in enumerate((ms, bms, pms)):
                    tot[k] += v
                print("%s %s %s: kernel %.4f ms, bound %.4f ms (%s), %.1f%% "
                      "of the bound, plain %.4f ms, rel err %.3g (tol %g)" % (
                          name, "x".join(map(str, vol)), label, ms, bms, by,
                          100 * bms / ms, pms, err, cs.TOL[dtype]),
                      flush=True)
                del stage, stage_plain, ins
            print("%s %s, its %d launch(es) of one round trip: kernel %.4f "
                  "ms, bound %.4f ms, %.1f%% of the bound, plain %.4f ms" % (
                      name, label, len(cs.PACK_VOLS[name]), tot[0], tot[1],
                      100 * tot[1] / tot[0], tot[2]), flush=True)
    return bad


def time_controls(dev) -> None:
    """The round trips and the kernels off the changed path."""
    t3 = dt.Transform3d()
    x = cs.rand((cs.VOL,) * 3, 11, dev, torch.float32)
    for label, dtype, layout in cs.LAYOUTS:
        xd = x.to(dtype)
        run = lambda: t3.inverse(t3.forward(xd, cs.NLEVELS, layout=layout))
        print("round trip 3-D %d^3 %d levels %s: %.3f ms" % (
            cs.VOL, cs.NLEVELS, label, cs.cuda_ms(run, reps=20)), flush=True)
        if dtype == torch.float32:
            cs.print_trace("round trip 3-D %s" % label, run)
    del x
    for name in CONTROL_HW:
        ms = 0.0
        for shape in cs.HW_SHAPES[name]:
            kern, _, xs = cs.hw_case(name, shape, torch.float32, dev)
            ms += cs.cuda_ms(lambda: [kern() for _ in range(cs.SHARDS)],
                             hold=True, reps=20)
            del kern, xs
        print("%s f32, its %d launches of one sharded round trip: kernel "
              "%.4f ms" % (name, cs.SHARDS * len(cs.HW_SHAPES[name]), ms),
              flush=True)
    t2 = dt.Transform2d()
    x2 = cs.rand((cs.N, cs.N), 0, dev, torch.float32)
    cs.print_trace("round trip 2-D f32 interleaved",
                   lambda: t2.inverse(t2.forward(x2, cs.NLEVELS)))


def main() -> int:
    if sys.argv[1:] not in ([], ["kernels"]):
        raise SystemExit("usage: python tools/time_pack3d.py [kernels]")
    if not torch.cuda.is_available():
        raise SystemExit("time_pack3d: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print("package: %s" % os.path.dirname(dt.__file__), flush=True)
    print("nvidia-smi: " + smi, flush=True)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        procs = ptxas_start(work)
        t0 = time.perf_counter()
        _build.library()
        print("build: %.1f s" % (time.perf_counter() - t0), flush=True)
        ptxas_print(procs)
    bad = time_kernels(dev)
    if sys.argv[1:] != ["kernels"]:
        time_controls(dev)
    print("errors over tolerance: %d" % bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
