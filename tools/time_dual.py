"""Time the analysis entries of the dual kernels, ``filter2`` and
``dfilt2`` (rows 8 and 9 of PERF.md's kernel table), on one NVIDIA GPU at
every launch shape of the round trips that run them, beside their byte
bound and, for ``filter2``, one ``F.conv2d`` call.

    python tools/time_dual.py            # from the repository's root
    python tools/time_dual.py kernels    # stop after the kernel lines
    python tools/time_dual.py longest    # only the largest tap bounds

Prints the card (``nvidia-smi`` name and power limit), the kernels' build
time and, where it built the library, what ``nvcc -Xptxas -v`` reports
for each kernel instance of ``dual.cu`` and ``single.cu`` (registers,
shared memory, spills).  Then it records the dual kernels' launches of
four float32 round trips (the 1-D ``[131072, 128]`` one at 8 levels, the
4 194 304-sample vector, the 3-D 256^3 one at 3 levels and the sharded
256^3 one on the (1, 4) card mesh) and replays each entry's launches with
the stream held, in float32, bfloat16 and float64 (the recorded inputs
cast): one line per entry, path, dtype and launch shape (its launches'
device time, the bound of their bytes at 3.35 TB/s, the share of it and
``F.conv2d``'s time in the same dtype, TF32 off) and the sum over the
round trip.  Then, unless ``kernels`` is given, the controls: the
synthesis sums ``filter2_sum`` and ``ifilt2_sum`` replayed on the same
paths (float32), ``dfilt`` and ``ifilt`` at the low-level path's 4096^2,
the four hw kernels at their shard shapes, the 3-D, sharded, 1-D and 2-D
4096^2 round trips traced (device time, idle share, wall).  The helpers
come from this checkout's ``chip_smoke.py``, the package from the working
directory: run from the root of another checkout (``python
/path/to/tools/time_dual.py``), it times that checkout's kernels (an
older checkout's launches are recorded as its wrappers made them).
``longest`` times, after the build, only the four entries at their
largest tap bound (random filters of 31 taps, qshift pairs of 32 for
``dfilt2`` and of 64 for ``ifilt2_sum``) on the 3-D round trip's depth
axis in the three dtypes.  Exits 1 if a replayed launch disagrees with
its plain version.
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
import torch.nn.functional as F

sys.path.insert(0, os.getcwd())
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
import dtcwt_tpu_torch as dt  # noqa: E402
from dtcwt_tpu_torch.ops import _build, dual, fb, single  # noqa: E402

SUBJECTS = ("filter2", "dfilt2")
CONTROLS = ("filter2_sum", "ifilt2_sum")
# the package's launch functions of the dual entries, recorded: this
# checkout's _launch_stream, and an older checkout's _launch (analysis
# entries) and _launch_sum (sums)
LAUNCHERS = ("_launch", "_launch_sum", "_launch_stream")
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
    """The dual kernels' launches of one call of *run*: {entry: [(launch
    function, args, kwargs)]}, each launch as the wrappers made it
    (``dual._launch_stream``, or an older package's ``dual._launch`` and
    ``dual._launch_sum``)."""
    calls = collections.defaultdict(list)
    saved = {n: getattr(dual, n) for n in LAUNCHERS if hasattr(dual, n)}

    def recorder(fn):
        def rec(name, *a, **k):
            calls[name].append((fn, (name,) + a, k))
            return fn(name, *a, **k)
        return rec
    for n, fn in saved.items():
        setattr(dual, n, recorder(fn))
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for n, fn in saved.items():
            setattr(dual, n, fn)
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
    if isinstance(args[1], list):
        return args[1]
    return [args[1], args[2]]


def shape_key(args, kwargs):
    """(input shape, axis, side) of a recorded launch."""
    x = inputs(args)[0]
    if isinstance(args[1], list):   # _launch_stream(name, ins, f, n, axis,
        #                             side); an older _launch(name, ins,
        #                             plans, groups, axis, side)
        axis, side = args[4], (args[5] if len(args) > 5 else
                                kwargs.get("side"))
    else:                           # _launch_sum(name, a, b, f, axis, n, ..)
        axis, side = args[4], (args[6] if len(args) > 6 else
                                kwargs.get("side"))
    return tuple(x.shape), axis, side


def filter_args(fn, args, kwargs):
    """(inputs, filters, n, axis, side) of a recorded launch, the filters
    as the entries take them (two filters or two pairs), or None for an
    older package's analysis launch (its filters are plans)."""
    name = args[0]
    if fn.__name__ == "_launch_stream":
        _, ins, f, n, axis = args[:5]
        side = args[5] if len(args) > 5 else kwargs.get("side")
    elif fn.__name__ == "_launch_sum":
        _, a, b, f, axis, n = args[:6]
        ins, side = [a, b], args[6] if len(args) > 6 else kwargs.get("side")
    else:
        return None
    f = (tuple(f) if name in ("filter2", "filter2_sum")
         else (tuple(f[:2]), tuple(f[2:])))
    return ins, f, n, axis, side


def plain_of(fn, args, kwargs):
    """The plain version of a recorded launch, or None."""
    got = filter_args(fn, args, kwargs)
    if got is None:
        return None
    ins, f, _, axis, side = got
    name = args[0]
    if side is None:
        return lambda: getattr(dual, name + "_axis_reference")(*ins, *f,
                                                               axis)
    return lambda: getattr(dual, name + "_fromext_axis_reference")(
        *ins, side, *f, axis)


def conv_call(fn, args, kwargs, dtype):
    """One F.conv2d computing a recorded filter2 launch (both branches'
    reversed taps as two output channels) or filter2_sum launch (as two
    input channels), on inputs extended outside the timed call, or None."""
    got = filter_args(fn, args, kwargs)
    if got is None or args[0] not in ("filter2", "filter2_sum"):
        return None
    ins, h, n, axis, side = got
    h = [np.asarray(v, np.float64).reshape(-1) for v in h]
    p = max(v.size for v in h) // 2
    w = torch.zeros((2, 1, 2 * p + 1, 1), dtype=torch.float64)
    for c, v in enumerate(h):
        off = p - v.size // 2
        w[c, 0, off:off + v.size, 0] = torch.from_numpy(v[::-1].copy())
    x = ins[0]
    ax = fb._norm_axis(axis, x.ndim)
    outer = int(np.prod(x.shape[:ax], dtype=np.int64))
    ext = []
    for t in ins:
        if side is None:
            e = fb.symmetric_extend(t, p, axis)
        else:
            e = t.narrow(axis, side - p, n + 2 * p)
        ext.append(e.reshape(outer, e.shape[ax], -1))
    inp = torch.stack(ext, 1).to(dtype).contiguous()
    weight = w.to(x.device, dtype)
    if len(ins) == 2:
        weight = weight.transpose(0, 1).contiguous()
    return lambda: F.conv2d(inp, weight)


def time_entry(name, path, calls, dtypes, conv=True) -> int:
    """One entry's lines on one path; returns the number of launches that
    disagree with their plain version."""
    bad = 0
    groups = collections.OrderedDict()
    for fn, a, k in calls:
        groups.setdefault(shape_key(a, k), []).append((fn, a, k))
    for label, dtype in dtypes:
        tot = [0.0, 0.0, 0.0]
        for (shape, axis, side), cl in groups.items():
            cl = [(fn, cast(a, dtype), k) for fn, a, k in cl]
            outs = [fn(*a, **k) for fn, a, k in cl]
            torch.cuda.synchronize()
            plain = plain_of(*cl[0])
            err = float("nan")
            if plain is not None:
                got = outs[0]
                err = cs.rel_err(tuple(got) if isinstance(got, list)
                                 else got, plain())
                bad += err > cs.TOL[dtype]
            nbytes = sum(cs.nbytes(inputs(a)) + cs.nbytes(o)
                         for (_, a, _), o in zip(cl, outs))
            del outs
            bms, _ = cs.bound(nbytes, 0)
            ms = cs.cuda_ms(lambda: [fn(*a, **k) for fn, a, k in cl],
                            hold=True, reps=20)
            lms = float("nan")
            lib = conv_call(*cl[0], dtype) if conv else None
            if lib is not None:
                try:
                    lms = len(cl) * cs.cuda_ms(lib, hold=True, reps=10)
                except RuntimeError as e:   # a dtype the library lacks
                    print("conv2d %s: %s" % (label, str(e)[:120]))
            del lib
            for i, v in enumerate((ms, bms, lms)):
                tot[i] += v
            print("%s %s %s %s axis %d side %s x %d: kernel %.4f ms, bound "
                  "%.4f ms, %.1f%% of the bound, conv2d %.4f ms, rel err "
                  "%.3g" % (name, path, label, "x".join(map(str, shape)),
                            axis, side, len(cl), ms, bms, 100 * bms / ms,
                            lms, err), flush=True)
            del cl
        n = sum(len(cl) for cl in groups.values())
        print("%s %s %s, its %d launches of one round trip: kernel %.4f ms, "
              "bound %.4f ms, %.1f%% of the bound, conv2d %.4f ms" % (
                  name, path, label, n, tot[0], tot[1],
                  100 * tot[1] / tot[0], tot[2]), flush=True)
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


def time_controls(dev, trips) -> None:
    b, q = dt.biort("near_sym_a"), dt.qshift("qshift_a")
    x = cs.rand((cs.N, cs.N), 0, dev, torch.float32)
    for name, fn, f in (("dfilt", single.dfilt_axis, (q[1], q[0])),
                        ("ifilt", single.ifilt_axis, (q[3], q[2]))):
        ms = cs.cuda_ms(lambda: [fn(x, *f, ax) for ax in (-2, -1)] * 2,
                        hold=True, reps=20)
        print("%s f32 4096^2, its 4 launches of the low-level path: kernel "
              "%.4f ms" % (name, ms), flush=True)
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
    if sys.argv[1:] == ["longest"]:
        with torch.no_grad():
            bad = time_longest(dev)
        print("launches over tolerance: %d" % bad)
        return 1 if bad else 0
    trips = round_trips(dev)
    bad = 0
    recorded = []
    with torch.no_grad():
        for label, run in trips:
            calls = record(run)
            recorded.append((label, calls))
            for name in SUBJECTS:
                bad += time_entry(name, label, calls[name], DTYPES)
        if sys.argv[1:] != ["kernels"]:
            for label, calls in recorded:
                for name in CONTROLS:
                    time_entry(name, label, calls[name], DTYPES[:1], False)
            del recorded
            time_controls(dev, trips)
    print("launches over tolerance: %d" % bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
