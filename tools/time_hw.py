"""Time the analysis kernel of the sharded 3-D path's (H, W) stage pairs,
``hw22_kernel`` (``csrc/hwana.cuh``: ``filter_hw22`` and ``dfilt_hw22``),
on one NVIDIA GPU at the shard shapes of the sharded 256^3 round trip,
beside its byte bound, its plain version and one ``torch.einsum`` over the
dense operators.

    python tools/time_hw.py            # from the repository's root
    python tools/time_hw.py kernels    # stop after the kernel lines

Prints the card (``nvidia-smi`` name and power limit), the kernels' build
time and what ``nvcc -Xptxas -v`` reports for each instance of
``hw22_kernel`` and of the synthesis kernel ``sum_hw22_kernel``
(registers, shared memory, spills), then one line per entry, dtype
(float32, bfloat16, float64) and shard shape: the device time of the round
trip's launches at that shape (one a shard of the (1, 4) card mesh, stream
held), the bound (bytes at 3.35 TB/s), the kernel's share of it, the
einsum's time (in the same dtype, TF32 off), the plain version's (float32)
and the error against the plain version; then the sum over the round
trip's launches.  Then, unless ``kernels`` is given, the controls:
``filter_sum_hw22`` and ``ifilt_sum_hw22`` at their shard shapes in the
three dtypes, the four 3-D level kernels' stages at the 256^3 round
trip's volumes (float32 interleaved), the dual kernels' launches in the
3-D 256^3 round trip and in the sharded one (each entry's launches
replayed with the stream held, against their byte bound), the sharded
256^3 round trip traced (device time, idle share, wall, the hw kernels'
device time) and the 2-D 4096^2 round trip traced.  The helpers come from
this checkout's ``chip_smoke.py``, the package from the working
directory: run from the root of another checkout (``python
/path/to/tools/time_hw.py``), it times that checkout's kernels.  Exits 1
if an error is over its tolerance.
"""

import collections
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

SUBJECTS = ("filter_hw22", "dfilt_hw22")
CONTROLS = ("filter_sum_hw22", "ifilt_sum_hw22")
DTYPES = (("f32", torch.float32), ("bf16", torch.bfloat16),
          ("f64", torch.float64))
PACK_ORDER = ("fwd_level1_pack", "fwd_level2_pack", "inv_level1_pack",
              "inv_level2_pack")


def ptxas_start(work):
    """Start ``nvcc -Xptxas -v`` on ``hw.cu`` (an object in *work*)."""
    src = os.path.join(_build.CSRC, "hw.cu")
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         _build.CSRC, "-c", "-o", os.path.join(work, "hw.o"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_print(proc) -> None:
    """Print the resource lines of ptxas's report for each instance of the
    analysis and the synthesis kernel."""
    out, _ = proc.communicate()
    name = None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if "hw22_kernel" in m.group(1) else None
            continue
        if name and ("Used" in line or "spill" in line):
            print("ptxas %s: %s" % (name, line.split(" : ")[-1].strip()),
                  flush=True)
    if proc.returncode:
        print("ptxas report failed (exit %d):\n%s" % (proc.returncode, out))


def time_kernels(dev) -> int:
    """The subject's lines; returns the number of errors over tolerance."""
    bad = 0
    shards = lambda fn: (lambda: [fn() for _ in range(cs.SHARDS)])
    for name in SUBJECTS:
        for label, dtype in DTYPES:
            tot = [0.0, 0.0, 0.0]
            for shape in cs.HW_SHAPES[name]:
                kern, plain, xs = cs.hw_case(name, shape, dtype, dev)
                out = kern()
                torch.cuda.synchronize()
                err = cs.rel_err(out, plain())
                bad += err > cs.TOL[dtype]
                bms, by = cs.bound(
                    cs.SHARDS * (cs.nbytes(xs) + cs.nbytes(out)),
                    cs.SHARDS * cs.hw_macs(name, shape))
                del out
                ms = cs.cuda_ms(shards(kern), hold=True, reps=20)
                lib, _ = cs.hw_einsum(name, xs)
                lms = cs.cuda_ms(shards(lib), hold=True, reps=5)
                pms = (cs.cuda_ms(shards(plain), hold=True, reps=3, warmup=1)
                       if dtype == torch.float32 else float("nan"))
                for k, v in enumerate((ms, bms, lms)):
                    tot[k] += v
                print("%s %s x %d shards %s: kernel %.4f ms, bound %.4f ms "
                      "(%s), %.1f%% of the bound, einsum %.4f ms, plain %.4f "
                      "ms, rel err %.3g (tol %g)" % (
                          name, "x".join(map(str, shape)), cs.SHARDS, label,
                          ms, bms, by, 100 * bms / ms, lms, pms, err,
                          cs.TOL[dtype]), flush=True)
                del kern, plain, xs, lib
            print("%s %s, its %d launches of one sharded round trip: kernel "
                  "%.4f ms, bound %.4f ms, %.1f%% of the bound, einsum %.4f "
                  "ms" % (name, label, cs.SHARDS * len(cs.HW_SHAPES[name]),
                          tot[0], tot[1], 100 * tot[1] / tot[0], tot[2]),
                  flush=True)
    return bad


def time_controls(dev) -> None:
    """The kernels and round trips off the changed path, and the sharded
    round trip that runs it."""
    for name in CONTROLS:
        for label, dtype in DTYPES:
            ms = 0.0
            for shape in cs.HW_SHAPES[name]:
                kern, _, xs = cs.hw_case(name, shape, dtype, dev)
                ms += cs.cuda_ms(lambda: [kern() for _ in range(cs.SHARDS)],
                                 hold=True, reps=20)
                del kern, xs
            print("%s %s, its %d launches of one sharded round trip: "
                  "kernel %.4f ms" % (name, label, cs.SHARDS
                                      * len(cs.HW_SHAPES[name]), ms),
                  flush=True)
    for name in PACK_ORDER:
        ms = 0.0
        for vol in cs.PACK_VOLS[name]:
            _, _, stage, _, ins = cs.pack_case(name, vol, torch.float32,
                                               False, dev)
            ms += cs.cuda_ms(stage, hold=True, reps=20)
            del stage, ins
        print("%s f32 interleaved, its %d launch(es) of one 3-D round trip:"
              " kernel %.4f ms" % (name, len(cs.PACK_VOLS[name]), ms),
              flush=True)
    from dtcwt_tpu_torch.parallel import ShardedTransform3d, make_mesh
    st = ShardedTransform3d(make_mesh((1, cs.SHARDS), ("data", "depth"),
                                      ["cuda"] * cs.SHARDS))
    t3 = dt.Transform3d()
    x = cs.rand((1,) + (cs.VOL,) * 3, 31, dev, torch.float32)
    run = lambda: st.inverse(st.forward(x, cs.NLEVELS))
    wall, enqueue, device = cs.trace(run)
    busy = sum(device.values())
    hw = collections.Counter()
    for k, v in device.items():
        if "hw22" in k:
            hw[k.split("(")[0].split("dtcwt::")[-1]] += v
    print("trace round trip sharded 3-D %d^3 f32 interleaved on the (1, %d) "
          "card mesh: wall %.3f ms, device %.3f ms (idle %.1f%%), host "
          "enqueue %.3f ms; hw kernels: %s" % (
              cs.VOL, cs.SHARDS, wall, busy,
              100 * (1 - busy / wall) if busy else float("nan"), enqueue,
              ", ".join("%s %.4f ms" % kv for kv in sorted(hw.items()))),
          flush=True)
    time_dual_3d("3-D %d^3 f32 interleaved" % cs.VOL, lambda: t3.inverse(
        t3.forward(x, cs.NLEVELS)))
    time_dual_3d("sharded 3-D %d^3 f32 interleaved" % cs.VOL, run)
    del x, st
    t2 = dt.Transform2d()
    x2 = cs.rand((cs.N, cs.N), 0, dev, torch.float32)
    cs.print_trace("round trip 2-D f32 interleaved",
                   lambda: t2.inverse(t2.forward(x2, cs.NLEVELS)))


def time_dual_3d(what, run) -> None:
    """The dual kernels' launches in one round trip *run* (rows 8-11 of
    the kernel table on a 3-D path): each entry's launches recorded with
    their inputs, then replayed with the stream held; their byte bound
    (inputs read once, outputs written once, at 3.35 TB/s)."""
    from dtcwt_tpu_torch.ops import dual
    launch, calls = dual._launch, collections.defaultdict(list)

    def record(name, ins, *a, **k):
        outs = launch(name, ins, *a, **k)
        calls[name].append(((name, ins) + a, k, cs.nbytes(ins)
                            + cs.nbytes(outs)))
        return outs
    dual._launch = record
    try:
        run()
        torch.cuda.synchronize()
    finally:
        dual._launch = launch
    for name in sorted(calls):
        cl = calls[name]
        ms = cs.cuda_ms(lambda: [launch(*a, **k) for a, k, _ in cl],
                        hold=True, reps=20)
        bms, _ = cs.bound(sum(b for _, _, b in cl), 0)
        print("dual %s in the %s round trip: %d launches, kernel %.4f ms, "
              "bound %.4f ms (bytes), %.1f%% of the bound" % (
                  name, what, len(cl), ms, bms, 100 * bms / ms), flush=True)
    del calls


def main() -> int:
    if sys.argv[1:] not in ([], ["kernels"]):
        raise SystemExit("usage: python tools/time_hw.py [kernels]")
    if not torch.cuda.is_available():
        raise SystemExit("time_hw: no CUDA device")
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
        proc = ptxas_start(work)
        t0 = time.perf_counter()
        _build.library()
        print("build: %.1f s" % (time.perf_counter() - t0), flush=True)
        ptxas_print(proc)
    bad = time_kernels(dev)
    if sys.argv[1:] != ["kernels"]:
        time_controls(dev)
    print("errors over tolerance: %d" % bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
