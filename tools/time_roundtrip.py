"""Time the main paths' round trips without gradients on one NVIDIA GPU:
the 2-D 4096^2 3-level round trip (f32 interleaved and planes), the 3-D
256^3 3-level one (f32 interleaved) and the 1-D [131072, 128] 8-level one
(f32 interleaved), each called as a user calls it, on an input that does
not require grad.

    python tools/time_roundtrip.py          # from the repository's root
    python tools/time_roundtrip.py 100      # repetitions (default 50)
    python tools/time_roundtrip.py summarize PAIRS BASE CHANGE
    python tools/time_roundtrip.py routes   # the route rule's host cost

Prints the card's name and power limit, then one line per round trip: the
wall time a caller waits (CUDA events, host work included), the device
time (a spin kernel holds the stream while the host enqueues, so the
events time only the device's work) and the host's time to enqueue one
round trip (``time.perf_counter`` with the stream held), each the median
of the repetitions.  The helpers come from this checkout's
``chip_smoke.py``, the package from the working directory: run by its
absolute path from the root of another checkout, it times that checkout's
package, so that two versions can be compared in one call (parent,
change, change, parent).

``summarize`` reads a file of such runs from two checkouts, each run's
lines after a header ``== pair N SIDE`` (SIDE BASE or CHANGE, the order
alternating from pair to pair), and prints for each round trip and time
the medians over the pairs of both sides, the spread between the base's
quartiles and the number of pairs in which the change was slower.

``routes`` counts, for each round trip, the calls of the wrappers' route
rule (``_build.within_bound``, where the package has one) and times those
calls again on the host, alone: what the rule adds to the enqueue.
"""

import importlib.util
import os
import re
import statistics
import subprocess
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
from dtcwt_tpu_torch.ops import _build  # noqa: E402


def host_ms(fn, reps: int) -> float:
    """Median milliseconds the host takes to enqueue *fn*, with a spin
    kernel holding the stream so that nothing waits for the device."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    cycles = int((3e3 * (time.perf_counter() - t0) + 1.0)
                 * cs._sleep_cycles_per_ms())
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    return statistics.median(times)


def cases(dev):
    """(label, round trip) of each main path, inputs made from a seed."""
    g = torch.Generator(device=dev).manual_seed(0)
    x2 = torch.rand((4096, 4096), generator=g, device=dev)
    x3 = torch.rand((256, 256, 256), generator=g, device=dev)
    x1 = torch.rand((131072, 128), generator=g, device=dev)
    t2, t3, t1 = dt.Transform2d(), dt.Transform3d(), dt.Transform1d()
    return [
        ("2-D 4096x4096 3 levels f32 interleaved",
         lambda: t2.inverse(t2.forward(x2, 3))),
        ("2-D 4096x4096 3 levels f32 planes",
         lambda: t2.inverse(t2.forward(x2, 3, layout="planes"))),
        ("3-D 256^3 3 levels f32 interleaved",
         lambda: t3.inverse(t3.forward(x3, 3))),
        ("1-D 131072x128 8 levels f32 interleaved",
         lambda: t1.inverse(t1.forward(x1, 8))),
    ]


def summarize(path: str, base: str, change: str) -> int:
    """Medians, the base's quartile spread and the change's losses over the
    pairs of runs in *path* (see the module's docstring)."""
    runs, side = {}, None
    head = re.compile(r"== pair (\d+) (\S+)")
    line_re = re.compile(r"round trip (.*), no grad: wall ([\d.]+) ms, "
                         r"device ([\d.]+) ms, host enqueue ([\d.]+) ms")
    with open(path) as f:
        for line in f:
            m = head.match(line)
            if m:
                side = (int(m.group(1)), m.group(2))
                continue
            m = line_re.match(line)
            if m and side:
                runs.setdefault(m.group(1), {})[side] = [
                    float(v) for v in m.groups()[1:]]
    for label, got in runs.items():
        pairs = sorted({n for n, s in got if (n, base) in got
                        and (n, change) in got})
        for k, what in enumerate(("wall", "device", "host enqueue")):
            b = [got[(n, base)][k] for n in pairs]
            c = [got[(n, change)][k] for n in pairs]
            q = statistics.quantiles(b, n=4)
            print("%s, %s: %s median %.4f ms (quartile spread %.4f), %s "
                  "median %.4f ms, %s slower in %d of %d pairs" % (
                      label, what, base, statistics.median(b), q[2] - q[0],
                      change, statistics.median(c), change,
                      sum(y > x for x, y in zip(b, c)), len(pairs)))
    return 0


def routes() -> int:
    """The route rule's calls a round trip and their host time."""
    if not hasattr(_build, "within_bound"):
        print("package %s has no route rule" % os.path.dirname(dt.__file__))
        return 0
    rule = _build.within_bound
    calls = []

    def counting(name, lengths):
        calls.append((name, list(lengths)))
        return rule(name, lengths)
    _build.within_bound = counting
    reps = 1000
    for label, fn in cases(torch.device("cuda")):
        fn()
        torch.cuda.synchronize()
        calls.clear()
        fn()
        torch.cuda.synchronize()
        got = list(calls)
        t0 = time.perf_counter()
        for _ in range(reps):
            for name, lengths in got:
                rule(name, lengths)
        ms = 1e3 * (time.perf_counter() - t0) / reps
        print("route rule %s: %d calls a round trip, %.4f ms of host time "
              "a round trip (%.2f us a call)" % (
                  label, len(got), ms, 1e3 * ms / max(1, len(got))))
    _build.within_bound = rule
    return 0


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "summarize":
        return summarize(*sys.argv[2:])
    if sys.argv[1:] == ["routes"]:
        return routes()
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print("package %s" % os.path.dirname(dt.__file__))
    print("nvidia-smi: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    t0 = time.perf_counter()
    _build.library()
    print("kernels built or loaded in %.1f s" % (time.perf_counter() - t0))
    for label, fn in cases(torch.device("cuda")):
        wall = cs.cuda_ms(fn, reps=reps, warmup=3)
        device = cs.cuda_ms(fn, reps=reps, warmup=3, hold=True)
        host = host_ms(fn, reps)
        print("round trip %s, no grad: wall %.4f ms, device %.4f ms, host "
              "enqueue %.4f ms (median of %d)" % (label, wall, device, host,
                                                 reps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
