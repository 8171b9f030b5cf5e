"""Time the one-branch stream kernels of ``csrc/single.cu``, ``dfilt`` and
``ifilt`` (rows 6 and 7 of PERF.md's kernel table), on one NVIDIA GPU at
the low-level path's 4096^2 calls, beside their byte bound and plain
version; then the dual kernels (rows 8-11) and the rest as controls.

    python tools/time_dual.py            # from the repository's root
    python tools/time_dual.py kernels    # stop after the kernel lines
    python tools/time_dual.py longest    # only the largest tap bounds

Prints the card (``nvidia-smi`` name and power limit), the kernels' build
time and, where it built the library, what ``nvcc -Xptxas -v`` reports
for each kernel instance of ``dual.cu`` and ``single.cu`` (registers,
shared memory, spills).  Then each of the low-level path's four calls
that run rows 6 and 7 (``coldfilt`` and ``rowdfilt`` with qshift_a's
(h0b, h0a), ``colifilt`` and ``rowifilt`` with (g0b, g0a), on a 4096^2
image), alone with the stream held, in float32, bfloat16 and float64: its
device time, the bound of its bytes at 3.35 TB/s, the share of it, the
plain version's time; and each row's sum over its 2 calls.  Then the same
four calls at the largest tap bound (random qshift pairs of 32 taps for
``dfilt``, of 64 for ``ifilt``, sum(ha * hb) positive).  Then, unless
``kernels`` is given, the controls: the dual kernels' launches recorded
from four float32 round trips (the 1-D ``[131072, 128]`` one at 8 levels,
the 4 194 304-sample vector, the 3-D 256^3 one at 3 levels and the sharded
256^3 one on the (1, 4) card mesh) and replayed with the stream held, one
line per entry, path and launch shape and the sum over the round trip;
the four hw kernels at their shard shapes; the 3-D, sharded, 1-D, vector
and 2-D 4096^2 round trips traced (device time, idle share, wall).  The
helpers come from this checkout's ``chip_smoke.py``, the package from the
working directory: run from the root of another checkout (``python
/path/to/tools/time_dual.py``), it times that checkout's kernels.
``longest`` times, after the build, only the largest tap bounds: the four
calls above, then the four dual entries (random filters of 31 taps,
qshift pairs of 32 for ``dfilt2`` and of 64 for ``ifilt2_sum``) on the
3-D round trip's depth axis, in the three dtypes.  Exits 1 if a call
disagrees with its plain version.
"""

import collections
import glob
import importlib.util
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
import dtcwt_tpu_torch as dt  # noqa: E402
from dtcwt_tpu_torch.ops import _build, dual  # noqa: E402

SUBJECTS = ("dfilt", "ifilt")
CONTROLS = ("filter2", "dfilt2", "filter2_sum", "ifilt2_sum")
DTYPES = (("f32", torch.float32), ("bf16", torch.bfloat16),
          ("f64", torch.float64))


def ptxas_start(work, name):
    """Start ``nvcc -Xptxas -v`` on ``csrc/<name>.cu`` (an object in
    *work*)."""
    src = os.path.join(_build.CSRC, name + ".cu")
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         _build.CSRC, "-c", "-o", os.path.join(work, name + ".o"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_print(proc) -> None:
    """Print the resource lines of ptxas's report for each kernel
    instance."""
    out, _ = proc.communicate()
    name = None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and ("Used" in line or "spill" in line):
            print("ptxas %s: %s" % (name, line.split(" : ")[-1].strip()),
                  flush=True)
    if proc.returncode:
        print("ptxas report failed (exit %d):\n%s" % (proc.returncode, out))


def record(run):
    """The stream kernels' launches of one call of *run*: {entry: [(launch
    function, args, kwargs)]}, each launch as the wrappers made it
    (``dual._launch_stream``)."""
    calls = collections.defaultdict(list)
    launch = dual._launch_stream

    def rec(name, *a, **k):
        calls[name].append((launch, (name,) + a, k))
        return launch(name, *a, **k)
    dual._launch_stream = rec
    try:
        run()
        torch.cuda.synchronize()
    finally:
        dual._launch_stream = launch
    return calls


def cast(obj, dtype):
    """*obj* with every floating tensor in it (lists and tuples searched)
    cast to *dtype*."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dtype) if obj.is_floating_point() else obj
    if isinstance(obj, (list, tuple)):
        return type(obj)(cast(o, dtype) for o in obj)
    return obj


def inputs(args):
    """The input tensors of a recorded launch's arguments."""
    return args[1]


def shape_key(args, kwargs):
    """(input shape, axis, side) of a recorded launch,
    ``_launch_stream(name, ins, f, n, axis, side)``."""
    side = args[5] if len(args) > 5 else kwargs.get("side")
    return tuple(args[1][0].shape), args[4], side


def filter_args(fn, args, kwargs):
    """(inputs, filters, n, axis, side) of a recorded launch, the filters
    as the entries take them (two filters or two pairs)."""
    name, ins, f, n, axis = args[:5]
    side = args[5] if len(args) > 5 else kwargs.get("side")
    f = (tuple(f) if name in ("filter2", "filter2_sum")
         else (tuple(f[:2]), tuple(f[2:])))
    return ins, f, n, axis, side


def plain_of(fn, args, kwargs):
    """The plain version of a recorded launch."""
    ins, f, _, axis, side = filter_args(fn, args, kwargs)
    name = args[0]
    if side is None:
        return lambda: getattr(dual, name + "_axis_reference")(*ins, *f,
                                                               axis)
    return lambda: getattr(dual, name + "_fromext_axis_reference")(
        *ins, side, *f, axis)


def time_entry(name, path, calls, dtypes) -> int:
    """One entry's lines on one path; returns the number of launches that
    disagree with their plain version."""
    bad = 0
    groups = collections.OrderedDict()
    for fn, a, k in calls:
        groups.setdefault(shape_key(a, k), []).append((fn, a, k))
    for label, dtype in dtypes:
        tot = [0.0, 0.0]
        for (shape, axis, side), cl in groups.items():
            cl = [(fn, cast(a, dtype), k) for fn, a, k in cl]
            outs = [fn(*a, **k) for fn, a, k in cl]
            torch.cuda.synchronize()
            got = outs[0]       # both branches' outputs, or the sum
            err = cs.rel_err(tuple(got) if len(got) > 1 else got[0],
                             plain_of(*cl[0])())
            bad += err > cs.TOL[dtype]
            nbytes = sum(cs.nbytes(inputs(a)) + cs.nbytes(o)
                         for (_, a, _), o in zip(cl, outs))
            del outs
            bms, _ = cs.bound(nbytes, 0)
            ms = cs.cuda_ms(lambda: [fn(*a, **k) for fn, a, k in cl],
                            hold=True, reps=20)
            tot[0] += ms
            tot[1] += bms
            print("%s %s %s %s axis %d side %s x %d: kernel %.4f ms, bound "
                  "%.4f ms, %.1f%% of the bound, rel err %.3g" % (
                      name, path, label, "x".join(map(str, shape)), axis,
                      side, len(cl), ms, bms, 100 * bms / ms, err),
                  flush=True)
            del cl
        n = sum(len(cl) for cl in groups.values())
        print("%s %s %s, its %d launches of one round trip: kernel %.4f ms, "
              "bound %.4f ms, %.1f%% of the bound" % (
                  name, path, label, n, tot[0], tot[1],
                  100 * tot[1] / tot[0]), flush=True)
    return bad


def round_trips(dev):
    """(label, float32 round trip) of the five paths."""
    t1, t3 = dt.Transform1d(), dt.Transform3d()
    x1 = cs.rand((cs.N1, cs.C1), 41, dev, torch.float32)
    xv = cs.rand((cs.NVEC,), 42, dev, torch.float32)
    x3 = cs.rand((cs.VOL,) * 3, 31, dev, torch.float32)
    xs = x3[None]       # the sharded transform takes [B, D, H, W]
    from dtcwt_tpu_torch.parallel import ShardedTransform3d, make_mesh
    st = ShardedTransform3d(make_mesh((1, cs.SHARDS), ("data", "depth"),
                                      ["cuda"] * cs.SHARDS))
    return [
        ("1-D", lambda: t1.inverse(t1.forward(x1, cs.NLEVELS1))),
        ("vector", lambda: t1.inverse(t1.forward(xv, cs.NLEVELS1))),
        ("3-D", lambda: t3.inverse(t3.forward(x3, cs.NLEVELS))),
        ("sharded", lambda: st.inverse(st.forward(xs, cs.NLEVELS)))]


def time_dual_3d(what, run) -> None:
    """The dual kernels' launches in one round trip *run*: each entry's
    launches recorded with their inputs, then replayed with the stream
    held; their byte bound (inputs read once, outputs written once, at
    3.35 TB/s)."""
    calls = record(run)
    for name in sorted(calls):
        cl = calls[name]
        outs = [fn(*a, **k) for fn, a, k in cl]
        nbytes = sum(cs.nbytes(inputs(a)) + cs.nbytes(o)
                     for (_, a, _), o in zip(cl, outs))
        del outs
        ms = cs.cuda_ms(lambda: [fn(*a, **k) for fn, a, k in cl],
                        hold=True, reps=20)
        bms, _ = cs.bound(nbytes, 0)
        print("dual %s in the %s round trip: %d launches, kernel %.4f ms, "
              "bound %.4f ms (bytes), %.1f%% of the bound" % (
                  name, what, len(cl), ms, bms, 100 * bms / ms), flush=True)
    del calls


def single_calls(longest=False):
    """(row, public name, filters, axis) of the low-level path's calls that
    run rows 6 and 7 at 4096^2 (chip_smoke.lowlevel_calls), or, with
    *longest*, the same calls with random pairs at the largest tap bound:
    32 taps for dfilt, 64 for ifilt, sum(ha * hb) positive."""
    calls = [c for c in cs.lowlevel_calls() if c[0] in SUBJECTS]
    if not longest:
        return calls
    rs = np.random.RandomState(7)
    pairs = {}
    for name, m in (("dfilt", 32), ("ifilt", 64)):
        ha, hb = rs.randn(m), rs.randn(m)
        pairs[name] = (ha, hb if np.sum(ha * hb) > 0 else -hb)
    return [(name, fn, pairs[name], axis) for name, fn, _, axis in calls]


def time_single(dev, longest=False) -> int:
    """Rows 6 and 7 at the low-level path's 4096^2 calls, each call alone
    with the stream held in the three dtypes, and each row's sum over its
    2 calls; returns the number of calls over tolerance."""
    bad = 0
    what = "longest " if longest else ""
    img = cs.rand((cs.N, cs.N), 21, dev, torch.float32)
    for label, dtype in DTYPES:
        x = img.to(dtype)
        tot = {n: [0.0, 0.0, 0.0] for n in SUBJECTS}
        for name, fn, f, axis in single_calls(longest):
            kern, plain = cs.single_call(name, x, f, axis)
            out = kern()
            err = cs.rel_err(out, plain())
            bad += err > cs.TOL[dtype]
            bms, _ = cs.bound(cs.nbytes(x) + cs.nbytes(out), 0)
            del out
            ms = cs.cuda_ms(kern, hold=True, reps=20)
            pms = cs.cuda_ms(plain, hold=True, reps=3, warmup=1)
            for i, v in enumerate((ms, bms, pms)):
                tot[name][i] += v
            print("%s %s(%s) %s %dx%d axis %d (%d taps): kernel %.4f ms, "
                  "bound %.4f ms, %.1f%% of the bound, plain %.4f ms, rel "
                  "err %.3g" % (name, what, fn, label, cs.N, cs.N, axis,
                                np.asarray(f[0]).size, ms, bms,
                                100 * bms / ms, pms, err), flush=True)
        for name in SUBJECTS:
            ms, bms, pms = tot[name]
            print("%s %s%s, its 2 launches of the low-level path: kernel "
                  "%.4f ms, bound %.4f ms, %.1f%% of the bound, plain %.4f "
                  "ms" % (name, what, label, ms, bms, 100 * bms / ms, pms),
                  flush=True)
        del x
    return bad


def time_controls(dev, trips) -> None:
    for name in cs.HW_NAMES:
        ms = 0.0
        for shape in cs.HW_SHAPES[name]:
            kern, _, xs = cs.hw_case(name, shape, torch.float32, dev)
            ms += cs.cuda_ms(lambda: [kern() for _ in range(cs.SHARDS)],
                             hold=True, reps=20)
            del kern, xs
        print("%s f32, its %d launches of one sharded round trip: kernel "
              "%.4f ms" % (name, cs.SHARDS * len(cs.HW_SHAPES[name]), ms),
              flush=True)
    for label, run in trips:
        cs.print_trace("round trip %s f32" % label, run)
    t2 = dt.Transform2d()
    x = cs.rand((cs.N, cs.N), 0, dev, torch.float32)
    cs.print_trace("round trip 2-D 4096^2 f32",
                   lambda: t2.inverse(t2.forward(x, cs.NLEVELS)))


def time_longest(dev) -> int:
    """The four entries at their largest tap bound, every tap random:
    filters of 31 taps (filter2, filter2_sum; bound 33), qshift pairs of 32
    (dfilt2; bound 32) and of 64 (ifilt2_sum; bound 33), along the depth
    axis of the 3-D 256^3 round trip's volumes, in the three dtypes,
    against their byte bound and plain version; returns the number over
    tolerance."""
    rs = np.random.RandomState(5)
    cases = (("filter2", (1, 256, 256, 256), 1,
              (rs.randn(31), rs.randn(31))),
             ("dfilt2", (1, 256, 256, 256), 1,
              ((rs.randn(32), rs.randn(32)), (rs.randn(32), rs.randn(32)))),
             ("filter2_sum", (1, 256, 256, 256), 2,
              (rs.randn(31), rs.randn(31))),
             ("ifilt2_sum", (1, 128, 256, 256), 2,
              ((rs.randn(64), rs.randn(64)), (rs.randn(64), rs.randn(64)))))
    bad = 0
    for name, shape, n_in, f in cases:
        kern = getattr(dual, name + "_axis")
        plain = getattr(dual, name + "_axis_reference")
        for label, dtype in DTYPES:
            ins = [cs.rand(shape, 51 + i, dev, dtype) for i in range(n_in)]
            out = kern(*ins, *f, -3)
            err = cs.rel_err(out, plain(*ins, *f, -3))
            bad += err > cs.TOL[dtype]
            bms, _ = cs.bound(cs.nbytes(ins) + cs.nbytes(out), 0)
            del out
            ms = cs.cuda_ms(lambda: kern(*ins, *f, -3), hold=True, reps=20)
            print("%s longest %s %s axis -3: kernel %.4f ms, bound %.4f ms, "
                  "%.1f%% of the bound, rel err %.3g" % (
                      name, label, "x".join(map(str, shape)), ms, bms,
                      100 * bms / ms, err), flush=True)
            del ins
    return bad


def main() -> int:
    if sys.argv[1:] not in ([], ["kernels"], ["longest"]):
        raise SystemExit("usage: python tools/time_dual.py "
                         "[kernels|longest]")
    if not torch.cuda.is_available():
        raise SystemExit("time_dual: no CUDA device")
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
        built = glob.glob(os.path.join(_build.BUILD_DIR, "*.so"))
        procs = [] if built else [ptxas_start(work, n)
                                  for n in ("dual", "single")]
        t0 = time.perf_counter()
        _build.library()
        print("build: %.1f s" % (time.perf_counter() - t0), flush=True)
        for proc in procs:
            ptxas_print(proc)
    with torch.no_grad():
        if sys.argv[1:] == ["longest"]:
            bad = time_single(dev, longest=True) + time_longest(dev)
        else:
            bad = time_single(dev) + time_single(dev, longest=True)
        if not sys.argv[1:]:
            trips = round_trips(dev)
            for label, run in trips:
                calls = record(run)
                for name in CONTROLS:
                    bad += time_entry(name, label, calls[name], DTYPES[:1])
                del calls
            time_controls(dev, trips)
    print("launches over tolerance: %d" % bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
