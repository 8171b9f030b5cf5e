"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU and check
them.

    python3 chip_smoke.py

The main paths, each through the entry points a user calls, with the
default filters (near_sym_a / qshift_a), in three layouts (interleaved
complex float32, float32 planes, bfloat16 planes):

* 2-D: ``dtcwt_tpu_torch.Transform2d()``, ``forward(x, nlevels=3)`` then
  ``inverse``, on a 4096 x 4096 image (four level kernels); and the same
  with the bandpass families, ``Transform2d("near_sym_b_bp",
  "qshift_b_bp")`` and ``compat.dtwavexfm2b`` / ``dtwaveifm2b`` (the four
  level kernels' third filter stream);
* 1-D: ``dtcwt_tpu_torch.Transform1d()``, ``forward(x, nlevels=8)`` then
  ``inverse``, on a ``[131072, 128]`` multichannel signal (2**24 samples;
  the four dual-stream kernels), and the single 4 194 304-sample vector at
  8 levels;
* 3-D: ``dtcwt_tpu_torch.Transform3d()``, ``forward(v, nlevels=3)`` then
  ``inverse``, on a 256 x 256 x 256 volume (the four level kernels of
  ``csrc/pack3d.cu``, each level's depth stage on the dual-stream kernels);
  and the same with ``discard_level_1=True`` (level 1 is three passes of
  the single-stream ``filter`` kernel each way, levels 2-3 as before);
* the low-level API: ``dtcwt_tpu_torch.ops.colfilter`` / ``rowfilter``
  (near_sym_a's h0o and h1o), ``coldfilt`` / ``rowdfilt`` (qshift_a's
  (h0b, h0a)) and ``colifilt`` / ``rowifilt`` ((g0b, g0a)) on a 4096 x 4096
  image, float32 and bfloat16 (``filter`` of ``csrc/filter.cu``, ``dfilt``
  and ``ifilt`` of ``csrc/single.cu``: the one-branch instances of the
  dual kernels' ``csrc/streamana.cuh`` and ``csrc/streamsum.cuh``);
* ``compat``: ``dtwavexfm3(v, 3, discard_level_1=True)`` / ``dtwaveifm3``
  at 256^3, ``dtwavexfm2`` / ``dtwaveifm2`` at 4096^2 and ``dtwavexfm`` /
  ``dtwaveifm`` at ``[131072, 128]``, and ``Transform2d.forward_channels``
  on a ``[2, 1024, 1024, 3]`` nhwc batch;
* the sharded 3-D transform: ``dtcwt_tpu_torch.parallel.ShardedTransform3d``
  on ``make_mesh((1, 4), ("data", "depth"), ["cuda"] * 4)`` (four shards of
  the one card), ``forward(v, nlevels=3)`` then ``inverse`` on a ``[1, 256,
  256, 256]`` volume with every level depth-sharded: the (H, W) stage pair
  of each shard on the four kernels of ``csrc/hw.cu`` (the analysis
  kernel's design in ``csrc/hwana.cuh``, the synthesis kernel's in
  ``csrc/hwsum.cuh``), the depth stages on
  the dual kernels' from-extension mode after a halo exchange;
* gradients: the 2-D round trip (both float32 layouts), the 3-D round trip
  (interleaved) and the 1-D round trip with inputs that require grad:
  each transform's level chain runs as one ``ops/linearize`` Function,
  whose backward launches the opposite qshift level kernels and the dual
  kernels' from-extension mode (``ops/adjoint``'s level-1 adjoints), or,
  for the 1-D transform, differentiates the plain chain.

Phases, each printing its own lines:

1. device: the card, and its name and power limit from nvidia-smi;
2. build: every CUDA kernel from ``dtcwt_tpu_torch/csrc``, timed;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes (float32, and bfloat16) and at small odd shapes
   in float64 for every family (the 2-D level kernels' bandpass variants
   included), including signals shorter than the filter (``fwd_level2``,
   ``inv_level2`` and ``inv_level1`` at shapes that cross their tiles both
   ways, and at the main path's shape with their inputs at a storage
   offset); each 2-D
   level
   kernel's bandpass variant also at the main path's shapes in three
   layouts; the dual-stream kernels also on axes -1, -2 and -3, on one
   signal (``inner = 1``) and in their from-extension mode; each 3-D level
   kernel as its entry (depth stage included) and alone, and at float64 in
   shapes the JAX package's kernels refuse (H or W not a multiple of 32,
   above 512, shorter than the filter); the single-stream kernels at 4096^2
   along axes -2 and -1 (float32, bfloat16), at 256^3 along -1, -2 and -3,
   and at float64 over every family's filters, the bandpass ones included,
   in both modes; the hw kernels at the sharded round trip's shard shapes
   (float32, bfloat16) and at float64 over the families at shapes the JAX
   envelope refuses;
4. main paths: each round trip in all three layouts with the plain versions
   patched to raise, the launch counts (2-D 1/2/2/1, 1-D 1/7/7/1, 3-D
   ``filter2`` 1, ``fwd_level1_pack`` 1, ``dfilt2`` 2, ``fwd_level2_pack``
   2, ``inv_level2_pack`` 2, ``ifilt2_sum`` 2, ``inv_level1_pack`` 1,
   ``filter2_sum`` 1 per round trip), the reconstruction error and agreement
   with the plain path on the card; a 4 x 1000 x 1500 batch (pad and crop)
   against the plain path; the bandpass 2-D round trip in three layouts
   (launches 1/2/2/1), every leaf and the reconstruction against the plain
   path on the card, its reconstruction error beside the plain path's (the
   bandpass families do not reconstruct perfectly), ``compat.dtwavexfm2b``
   / ``dtwaveifm2b`` equal to its result with the same launches, and a
   float64 2 x 517 x 389 case (pads, crops, scales) against the CPU at
   1e-12; the 4M-sample vector; a small float64 1-D case
   against the CPU; 3-D pads and crops in both ``ext_mode`` values; the
   discard_level_1 round trip in three layouts (launches ``filter`` 6,
   ``dfilt2`` 2, ``fwd_level2_pack`` 2, ``inv_level2_pack`` 2,
   ``ifilt2_sum`` 2), against the plain path, a float64 case against the
   CPU and the reference's gate on an ellipsoid (median abs error < 1e-3);
   the low-level path (``filter`` 8, ``dfilt`` 4, ``ifilt`` 4 launches);
   each compat entry equal to its Transform's result with the same
   launches; the nhwc channel adapter equal to ``forward`` on moved axes;
   the sharded round trip in three layouts (launches ``filter_hw22`` 4,
   ``dfilt_hw22`` 8, ``filter2`` 16, ``dfilt2`` 32, ``ifilt2_sum`` 32,
   ``ifilt_sum_hw22`` 8, ``filter2_sum`` 16, ``filter_sum_hw22`` 4), every
   leaf against ``Transform3d`` on the card and against the plain path; a
   ``[1, 32, 256, 256]`` volume whose levels 2-3 gather (their inverse
   merges on ``ifilt_sum_hw22``); a (1, 2, 2) rows mesh; float64 card
   against CPU meshes; the gradient round trips, each direction's
   backward with the plain versions patched to raise (2-D: the forward's
   ``inv_level2`` 2, ``filter2_sum`` 3, the inverse's ``filter2`` 3,
   ``fwd_level2`` 2; 3-D: ``inv_level2_pack`` 2, ``ifilt2_sum`` 2,
   ``filter2_sum`` 7, and ``filter2`` 7, ``fwd_level2_pack`` 2,
   ``dfilt2`` 2), its gradients against the plain path's autograd on the
   card within 2e-5;
5. timing: CUDA events, median of 10 runs after 2 warm-up runs (for a round
   trip the time its caller waits; for a kernel, its plain version and a
   library call the device's time alone, the stream held while the host
   enqueues them): each kernel at its main-path shapes against its plain
   version and, where one PyTorch call computes the same function
   (``F.conv2d`` for ``filter2``, ``filter2_sum`` and ``filter``, TF32
   off; for ``filter`` beside each 256^3 pass and each 4096^2 call, f32
   and bf16, with each pass's share of its bound), that call; the bound of each kernel (its bytes at 3.35 TB/s or its float32
   operations at 67 TFLOP/s, whichever is longer); ``inv_level1`` also
   for near_sym_b, antonini and legall in each layout against its bound;
   each round trip against the plain path (the bandpass 2-D round trip
   too, and each level kernel's
   bandpass variant at its main-path shapes against its bound, its plain
   version and the same kernel without the third stream on near_sym_b /
   qshift_b); for the f32 interleaved round trips (3-D: both f32
   layouts; the discard round trip: interleaved), a ``torch.profiler``
   trace: device time by kernel, the
   device's idle share and the host's time to enqueue (for the 2-D round
   trip also split into the level wrappers' calls, their ctypes launches
   and the transform's glue).  A 3-D level kernel
   is timed alone, on its depth stage's outputs, against the plain version
   of that stage.  The sharded round trip against ``Transform3d`` and the
   plain path, with a trace (f32 interleaved); each hw kernel's launches of
   one round trip against the plain version, the bound and one
   ``torch.einsum("ah,nhw,wb->nab")`` over the dense operators (TF32 off).
   Each gradient round trip: the primal, the backward alone, their ratio,
   the plain route's backward and the byte bound of the backward's
   launches; a trace of the 2-D backward by kernel and by aten operator.

Tolerances, relative to the largest reference value: float32 1e-5 (sums in
another order), bfloat16 1e-2 (one bfloat16 step of the stored outputs),
float64 1e-12.  Reconstruction: float32 1e-4, bfloat16 0.04 (2-D, 1-D) and
0.08 (3-D; tests/test_bf16.py's storage grades).

The last three lines are the nvidia-smi line, the JSON list of kernels and
``{"ok": true, "device": {...}}``; they are printed only when every phase
passed.  Without a GPU, or outside the repository, the script fails before
them.
"""

from __future__ import annotations

import collections
import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

N = 4096
NLEVELS = 3
N1, C1, NLEVELS1 = 131072, 128, 8      # the 1-D main path
NVEC = 4194304                         # the single long vector
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float64: 1e-12}
REC_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.04}
LAYOUTS = (("f32 interleaved", torch.float32, "interleaved"),
           ("f32 planes", torch.float32, "planes"),
           ("bf16 planes", torch.bfloat16, "planes"))
BIORTS = ("antonini", "legall", "near_sym_a", "near_sym_b")
QSHIFTS = ("qshift_06", "qshift_a", "qshift_b", "qshift_c", "qshift_d",
           "qshift_32")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOP_PER_S = 67e12         # float32 outside the tensor cores
_ANA_SRC = "dtcwt_tpu_torch/csrc/streamana.cuh"
_SUM_SRC = "dtcwt_tpu_torch/csrc/streamsum.cuh"
_PACK_SRC = "dtcwt_tpu_torch/csrc/pack3d.cu"
_IPACK_SRC = "dtcwt_tpu_torch/csrc/ipack.cuh"
_FILTER_SRC = "dtcwt_tpu_torch/csrc/filter.cu"
_HWANA_SRC = "dtcwt_tpu_torch/csrc/hwana.cuh"
_HWSUM_SRC = "dtcwt_tpu_torch/csrc/hwsum.cuh"
KERNELS = {   # name -> (CUDA source, the TPU kernel it replaces)
    "level1": ("dtcwt_tpu_torch/csrc/level1.cu",
               "dtcwt_tpu/ops/pallas_level1.py:374"),
    "level2": ("dtcwt_tpu_torch/csrc/level2.cu",
               "dtcwt_tpu/ops/pallas_level2.py:438"),
    "ilevel2": ("dtcwt_tpu_torch/csrc/ilevel2.cu",
                "dtcwt_tpu/ops/pallas_ilevel2.py:455"),
    "ilevel1": ("dtcwt_tpu_torch/csrc/ilevel1.cu",
                "dtcwt_tpu/ops/pallas_ilevel1.py:434"),
    "filter2": (_ANA_SRC, "dtcwt_tpu/ops/pallas_dual.py:173"),
    "dfilt2": (_ANA_SRC, "dtcwt_tpu/ops/pallas_dual.py:294"),
    "ifilt2_sum": (_SUM_SRC, "dtcwt_tpu/ops/pallas_dual.py:533"),
    "filter2_sum": (_SUM_SRC, "dtcwt_tpu/ops/pallas_dual.py:409"),
    "fwd_level1_pack": (_PACK_SRC, "dtcwt_tpu/ops/pallas_pack3d.py:607"),
    "inv_level1_pack": (_IPACK_SRC, "dtcwt_tpu/ops/pallas_pack3d.py:647"),
    "fwd_level2_pack": (_PACK_SRC, "dtcwt_tpu/ops/pallas_pack3d.py:503"),
    "inv_level2_pack": (_IPACK_SRC, "dtcwt_tpu/ops/pallas_pack3d.py:549"),
    "filter": (_FILTER_SRC, "dtcwt_tpu/ops/pallas_fb.py:492"),
    "dfilt": (_ANA_SRC, "dtcwt_tpu/ops/pallas_fb.py:642"),
    "ifilt": (_SUM_SRC, "dtcwt_tpu/ops/pallas_fb.py:791"),
    "filter_hw22": (_HWANA_SRC, "dtcwt_tpu/ops/pallas_hw.py:145"),
    "dfilt_hw22": (_HWANA_SRC, "dtcwt_tpu/ops/pallas_hw.py:155"),
    "filter_sum_hw22": (_HWSUM_SRC, "dtcwt_tpu/ops/pallas_hw.py:223"),
    "ifilt_sum_hw22": (_HWSUM_SRC, "dtcwt_tpu/ops/pallas_hw.py:234"),
}
LAUNCHES_2D = {"level1": 1, "level2": 2, "ilevel2": 2, "ilevel1": 1}
LAUNCHES_1D = {"filter2": 1, "dfilt2": 7, "ifilt2_sum": 7, "filter2_sum": 1}

failures = []


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def rel_err(got, want) -> float:
    if isinstance(got, tuple):
        return max(rel_err(g, w) for g, w in zip(got, want))
    g = torch.view_as_real(got) if got.is_complex() else got
    w = torch.view_as_real(want) if want.is_complex() else want
    scale = float(w.double().abs().max().clamp_min(1e-30))
    return float((g.double() - w.double()).abs().max()) / scale


def abs_err(got, want) -> float:
    if isinstance(got, tuple):
        return max(abs_err(g, w) for g, w in zip(got, want))
    g = torch.view_as_real(got) if got.is_complex() else got
    w = torch.view_as_real(want) if want.is_complex() else want
    return float((g.double() - w.double()).abs().max())


def tensors(obj):
    """Every tensor in a nest of tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    return [t for o in obj for t in tensors(o)]


def nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(obj))


def bound(nbytes_: int, macs: int):
    """(ms, "bytes" or "operations"): the least time for *nbytes_* of
    device memory traffic and *macs* float32 multiply-adds."""
    t_bytes = nbytes_ / HBM_BYTES_PER_S
    t_ops = 2 * macs / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cuda_ms(fn, reps: int = 10, warmup: int = 2, hold: bool = False
            ) -> float:
    """Median milliseconds of *fn* over *reps* runs, each between two CUDA
    events, after *warmup* runs.  Without *hold* that is the time a caller
    waits, host work included.  With *hold* a spin kernel holds the stream
    while the host enqueues *fn*, so the events time only the device's work
    (a kernel's time, whatever its launch costs the host)."""
    host = 0.0
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host = max(host, time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = int((3 * host * 1e3 + 1.0) * _sleep_cycles_per_ms()) if hold \
        else 0
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


_SLEEP_RATE = []


def _sleep_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` per millisecond, measured once."""
    if not _SLEEP_RATE:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        end.synchronize()
        _SLEEP_RATE.append(1e7 / start.elapsed_time(end))
    return _SLEEP_RATE[0]


def trace(fn, reps: int = 10):
    """Per call of *fn*: wall milliseconds, host milliseconds to enqueue it,
    and device milliseconds by kernel name from ``torch.profiler`` (empty
    where the profiler sees no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = collections.Counter()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device[e.key] += e.self_device_time_total / 1e3 / reps
    return wall, enqueue, device


def print_trace(what, fn) -> None:
    wall, enqueue, device = trace(fn)
    busy = sum(device.values())
    if not busy:
        print("trace %s: wall %.3f ms, host enqueue %.3f ms per round trip; "
              "device time not measured (the profiler saw no device "
              "activity)" % (what, wall, enqueue), flush=True)
        return
    top = ", ".join("%s %.4f ms" % (
        k.replace("(anonymous namespace)::", "").split("(")[0][:60], v)
                    for k, v in device.most_common(6))
    print("trace %s: wall %.3f ms, device %.3f ms (idle %.1f%%), host "
          "enqueue %.3f ms per round trip; device time by kernel: %s" % (
              what, wall, busy, 100 * (1 - busy / wall), enqueue, top),
          flush=True)


# the C entries of the 2-D level kernels, timed by print_host_split
LEVEL_ENTRIES = ("dtcwt_level1", "dtcwt_level2", "dtcwt_ilevel2",
                 "dtcwt_ilevel1")


def print_host_split(what, fn, reps: int = 20) -> None:
    """Split the host's time to enqueue *fn* (a 2-D round trip, as trace()
    measures it) into the level wrappers' calls, their ctypes launches (the
    C entries, part of the wrappers' time) and the rest, the glue of
    Transform2d; each wrapper and C entry timed with time.perf_counter."""
    from dtcwt_tpu_torch.ops import _build, ilevel1, ilevel2, level1, level2
    spent = collections.Counter()

    def timed(f, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t0
                spent[key + " calls"] += 1
        return run

    lib = _build.library()

    class Timed:
        """The kernel library with the level kernels' C entries timed."""

        def __getattr__(self, n):
            f = getattr(lib, n)
            return timed(f, "launches") if n in LEVEL_ENTRIES else f
    proxy = Timed()
    pairs = [(m, n, timed(getattr(m, n), "wrappers")) for m, n in (
        (level1, "fwd_level1"), (level2, "fwd_level2"),
        (ilevel2, "inv_level2"), (ilevel1, "inv_level1"))]
    with patched(pairs + [(_build, "library", lambda: proxy)]):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        spent.clear()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
    wrap = spent["wrappers"] * 1e3 / reps
    launch = spent["launches"] * 1e3 / reps
    print("host split %s: enqueue %.3f ms per round trip = level wrappers "
          "%.3f ms (%d calls; their ctypes launches %.3f ms, the wrappers' "
          "own work %.3f ms) + glue %.3f ms (Transform2d)" % (
              what, enqueue, wrap, spent["wrappers calls"] // reps, launch,
              wrap - launch, enqueue - wrap), flush=True)


def rand(shape, seed, device, dtype):
    return torch.from_numpy(np.random.RandomState(seed).rand(*shape)).to(
        device, dtype)


def rand_bands(shape, seed, device, dtype, planes):
    """Random subbands of a [..., h, w] grid in either layout."""
    rng = np.random.RandomState(seed)
    hw = tuple(shape) + (6,)
    if planes:
        ph = tuple(shape[:-2]) + (6,) + tuple(shape[-2:])
        return {"bands": (torch.from_numpy(rng.rand(*ph)).to(device, dtype),
                          torch.from_numpy(rng.rand(*ph)).to(device, dtype))}
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    return {"yh": torch.complex(torch.from_numpy(rng.rand(*hw)),
                                torch.from_numpy(rng.rand(*hw))).to(device,
                                                                    cdt)}


@contextlib.contextmanager
def patched(pairs):
    """Temporarily set module attributes: [(module, name, value), ...]."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, v in pairs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def refuse(*_a, **_k):
    raise RuntimeError("a plain version ran on the CUDA path")


# --- the 2-D level kernels and the bandpass families' path -----------------

LEVEL_NAMES = ("level1", "level2", "ilevel2", "ilevel1")
# the shapes each 2-D level kernel sees in one 4096^2 3-level round trip: x
# [R, C] (forward) or the lowpass z [H, W] (inverse)
MAIN_SHAPES_2D = {"level1": [(N, N)], "level2": [(N, N), (N // 2, N // 2)],
                  "ilevel2": [(N // 4, N // 4), (N // 2, N // 2)],
                  "ilevel1": [(N, N)]}
BP_FAMS = ("near_sym_b_bp", "qshift_b_bp")
BP_SHAPE_64 = (2, 517, 389)    # odd: pads before levels 2-3, crops after


def level_inputs(name, shape, dtype, planes, dev, seed=0):
    """Random inputs of 2-D level kernel *name*: x [..., R, C] (forward),
    or the lowpass z [..., H, W] and the level's subbands (inverse)."""
    if name in ("level1", "level2"):
        return rand(shape, seed, dev, dtype)
    z = rand(shape, seed, dev, dtype)
    return (z, rand_bands(tuple(shape[:-2]) + (shape[-2] // 2,
                                               shape[-1] // 2),
                          seed + 1, dev, dtype, planes))


def level_call(name, inp, planes, bb, qq):
    """(kernel wrapper, plain version) of 2-D level kernel *name* on *inp*
    with the biort filters *bb* and qshift filters *qq* in the transform's
    call order, the third stream included where the family has one (a 6- or
    12-tuple)."""
    from dtcwt_tpu_torch.ops import ilevel1, ilevel2, level1, level2
    if name == "level1":
        kw = {"planes": planes, "h2o": bb[4] if len(bb) == 6 else None}
        return ((lambda: level1.fwd_level1(inp, bb[0], bb[2], **kw)),
                (lambda: level1.fwd_level1_reference(inp, bb[0], bb[2],
                                                     **kw)))
    if name == "level2":
        f = (qq[0], qq[1], qq[4], qq[5])
        kw = {"planes": planes}
        if len(qq) == 12:
            kw.update(h2a=qq[8], h2b=qq[9])
        return ((lambda: level2.fwd_level2(inp, *f, **kw)),
                (lambda: level2.fwd_level2_reference(inp, *f, **kw)))
    z, band = inp
    if name == "ilevel2":
        kw = dict(g0a=qq[2], g0b=qq[3], g1a=qq[6], g1b=qq[7], **band)
        if len(qq) == 12:
            kw.update(g2a=qq[10], g2b=qq[11])
        return ((lambda: ilevel2.inv_level2(z, **kw)),
                (lambda: ilevel2.inv_level2_reference(z, **kw)))
    kw = dict(g0o=bb[1], g1o=bb[3], **band)
    if len(bb) == 6:
        kw["g2o"] = bb[5]
    return ((lambda: ilevel1.inv_level1(z, **kw)),
            (lambda: ilevel1.inv_level1_reference(z, **kw)))


def level_macs(name, inp, bb, qq) -> int:
    """Multiply-adds of one call of 2-D level kernel *name* on *inp*.  With
    filters m0, m1 (and the third stream's m2), per input (forward) or
    output (inverse) pixel of a level-1 kernel: 3 (m0 + m1), or 3 m0 +
    2 m1 + 2 m2 (the third stream replaces a row stage and adds a column
    stage); per R x C input of level 2: 2 m (2.5 m), per H x W lowpass of
    its inverse: 8 m (10 m)."""
    n = (inp if name in ("level1", "level2") else inp[0]).numel()
    if name in ("level1", "ilevel1"):
        m0, m1 = (bb[0].size, bb[2].size) if name == "level1" else (
            bb[1].size, bb[3].size)
        if len(bb) == 4:
            return 3 * n * (m0 + m1)
        m2 = bb[4 if name == "level1" else 5].size
        return n * (3 * m0 + 2 * m1 + 2 * m2)
    bp = len(qq) == 12
    if name == "level2":
        return n * qq[0].size * (5 if bp else 4) // 2
    return n * qq[2].size * (10 if bp else 8)


def level_no_plain():
    """Patches that make the four level modules' plain versions raise."""
    from dtcwt_tpu_torch.ops import ilevel1, ilevel2, level1, level2
    return [(level1, "fwd_level1_reference", refuse),
            (level2, "fwd_level2_reference", refuse),
            (ilevel2, "inv_level2_reference", refuse),
            (ilevel1, "inv_level1_reference", refuse)]


def level_plain_path():
    """Patches that route the four level wrappers to their plain versions."""
    from dtcwt_tpu_torch.ops import ilevel1, ilevel2, level1, level2
    return [(level1, "fwd_level1", level1.fwd_level1_reference),
            (level2, "fwd_level2", level2.fwd_level2_reference),
            (ilevel2, "inv_level2", ilevel2.inv_level2_reference),
            (ilevel1, "inv_level1", ilevel1.inv_level1_reference)]


# fwd_level2's tiles are 4, 8 or 16 quad rows by 64 quads: shapes that
# cross tile edges both ways, tall and wide images, rows too short or odd
# for its vector stores, images shorter than the filters
LEVEL2_SHAPES = [(2, 40, 56), (2, 8, 12), (132, 260), (3, 132, 264),
                 (4100, 8), (8, 4100), (2, 76, 264)]
# inv_level1's tiles are 16 (float64: 8) rows by 128 columns: shapes that
# cross tile edges both ways, tall and wide images, rows too short or odd
# for its 4-wide stores, images shorter than the filters
# inv_level2's tiles are 4, 8 or 16 band rows by 32 band columns (lowpass
# z tiles of 8, 16 or 32 rows by 64 columns): shapes that cross tile edges
# both ways, tall and wide images, a batch, images shorter than the filters
ILEVEL2_SHAPES = [(2, 20, 28), (2, 4, 6), (66, 130), (3, 66, 132),
                  (2050, 4), (4, 2050), (2, 38, 134)]
ILEVEL1_SHAPES = [(2, 36, 52), (2, 4, 6), (130, 200), (3, 130, 200),
                  (4096, 2), (2, 4096), (2, 38, 6), (6, 202), (4, 518)]


def at_offset(t):
    """A copy of *t* (or of each tensor of a tuple) stored one element past
    the start of its buffer, as a caller's tensor at a storage offset."""
    if isinstance(t, tuple):
        return tuple(at_offset(u) for u in t)
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = buf[1:].view(t.shape)
    v.copy_(t)
    return v


def check_offsets(name, dev, bb, qq) -> None:
    """Phase 3: 2-D level kernel *name* at the main path's first shape with
    its inputs at a storage offset (no 16-byte alignment), each layout:
    fwd_level2's image, inv_level2's and inv_level1's lowpass and
    subbands."""
    shape = MAIN_SHAPES_2D[name][0]
    for label, dtype, layout in LAYOUTS:
        pl = layout == "planes"
        inp = level_inputs(name, shape, dtype, pl, dev, seed=7)
        if isinstance(inp, tuple):
            z, band = inp
            inp = (at_offset(z), {k: at_offset(v) for k, v in band.items()})
        else:
            inp = at_offset(inp)
        kern, plain = level_call(name, inp, pl, bb, qq)
        got = kern()
        torch.cuda.synchronize()
        err = rel_err(got, plain())
        check(err <= TOL[dtype], "kernel %s %s %s, inputs at a storage "
              "offset: rel err %.3g (tol %g)" % (
                  name, "x".join(map(str, shape)), label, err, TOL[dtype]))
        del inp, got


def time_ilevel1_families(dev, qq) -> None:
    """Phase 5: inv_level1 at the main path's shape for each biorthogonal
    family beside near_sym_a (timed with the main path) and near_sym_b_bp
    (timed with the bandpass path), in each layout, against its bound."""
    import dtcwt_tpu_torch as dt
    for label, dtype, layout in LAYOUTS:
        pl = layout == "planes"
        inp = level_inputs("ilevel1", (N, N), dtype, pl, dev)
        for fam in ("near_sym_b", "antonini", "legall"):
            bb = dt.biort(fam)
            kern = level_call("ilevel1", inp, pl, bb, qq)[0]
            ms = cuda_ms(kern, hold=True)
            bms, by = bound(nbytes(inp) + nbytes(kern()),
                            level_macs("ilevel1", inp, bb, qq))
            print("time inv_level1 %s %dx%d %s: kernel %.4f ms, bound %.4f "
                  "ms (%s), %.1f%% of the bound" % (
                      fam, N, N, label, ms, bms, by, 100 * bms / ms),
                  flush=True)
        del inp


def leaves(p):
    """Every tensor leaf of a pyramid: lowpass, subbands, scales."""
    from dtcwt_tpu_torch.transforms.pyramid import PlanePyramid
    hp = (p.highpasses_re + p.highpasses_im if isinstance(p, PlanePyramid)
          else p.highpasses)
    return [p.lowpass] + [h for h in hp if h is not None] + list(
        p.scales or ())


def check_bandpass(dev) -> None:
    """Phases 3 and 4 for the bandpass families (near_sym_b_bp /
    qshift_b_bp): each level kernel's third-stream variant against its
    plain version at the main path's shapes, then the 4096^2 round trip in
    three layouts with the plain versions patched to raise, compat.
    dtwavexfm2b / dtwaveifm2b, and a float64 case against the CPU."""
    import dtcwt_tpu_torch as dt
    from dtcwt_tpu_torch import compat
    from dtcwt_tpu_torch.ops import _build
    bb, qq = dt.biort(BP_FAMS[0]), dt.qshift(BP_FAMS[1])
    for name, shapes in MAIN_SHAPES_2D.items():
        for label, dtype, layout in LAYOUTS:
            pl = layout == "planes"
            worst = 0.0
            for shape in shapes:
                kern, plain = level_call(
                    name, level_inputs(name, shape, dtype, pl, dev), pl, bb,
                    qq)
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                worst = max(worst, rel_err(got, want))
                del got, want, kern, plain
            check(worst <= TOL[dtype], "kernel %s bandpass (%s) %s %s: worst "
                  "rel err %.3g (tol %g)" % (
                      name, "/".join(BP_FAMS), shapes, label, worst,
                      TOL[dtype]))

    t = dt.Transform2d(*BP_FAMS)
    x32 = torch.from_numpy(np.random.RandomState(0).rand(N, N).astype(
        np.float32)).to(dev)
    pyr_f32 = None
    for label, dtype, layout in LAYOUTS:
        x = x32.to(dtype)
        _build.reset_launches()
        with patched(level_no_plain()):
            pyr = t.forward(x, nlevels=NLEVELS, layout=layout)
            rec = t.inverse(pyr)
            torch.cuda.synchronize()
        counts = dict(_build.launches)
        check(counts == LAUNCHES_2D, "main path 2-D bandpass %s: launches %s"
              % (label, counts))
        hp = pyr.highpasses if layout == "interleaved" else pyr.highpasses_re
        shapes_ok = (tuple(rec.shape) == (N, N) and rec.dtype == dtype
                     and tuple(pyr.lowpass.shape) == (N // 4, N // 4)
                     and len(hp) == NLEVELS)
        finite = all(bool(torch.isfinite(
            torch.view_as_real(a) if a.is_complex() else a.float()).all())
            for a in leaves(pyr) + [rec])
        with patched(level_plain_path()):
            pp = t.forward(x, nlevels=NLEVELS, layout=layout)
            rp = t.inverse(pp)
        e = max(rel_err(a, c) for a, c in zip(
            leaves(pyr) + [rec], leaves(pp) + [rp]))
        err = float((rec.float() - x.float()).abs().max())
        err_plain = float((rp.float() - x.float()).abs().max())
        check(shapes_ok and finite and e <= TOL[dtype] * 10,
              "main path 2-D bandpass %s: 4096x4096 %d-level round trip, "
              "kernel vs plain path on the card, every leaf and the "
              "reconstruction: worst rel err %.3g (tol %g), shapes %s, "
              "finite %s; reconstruction max abs err %.4f (plain path %.4f; "
              "the bandpass families do not reconstruct perfectly)" % (
                  label, NLEVELS, e, TOL[dtype] * 10, shapes_ok, finite, err,
                  err_plain))
        if label == "f32 interleaved":
            pyr_f32 = pyr
        del pyr, rec, pp, rp

    # compat: the MATLAB-style bandpass entries give Transform2d's result
    fams = {"biort": BP_FAMS[0], "qshift": BP_FAMS[1]}
    _build.reset_launches()
    with patched(level_no_plain()):
        yl, yh = compat.dtwavexfm2b(x32, NLEVELS, **fams)
        rc = compat.dtwaveifm2b(yl, yh, **fams)
        torch.cuda.synchronize()
    counts = dict(_build.launches)
    same = torch.equal(yl, pyr_f32.lowpass) and all(
        torch.equal(a, c) for a, c in zip(yh, pyr_f32.highpasses))
    same = same and torch.equal(rc, t.inverse(pyr_f32))
    check(same and counts == LAUNCHES_2D,
          "compat.dtwavexfm2b / dtwaveifm2b (%s) 4096x4096: equal to "
          "Transform2d's f32 result %s, launches %s" % (
              "/".join(BP_FAMS), same, counts))
    del x32, pyr_f32, yl, yh, rc

    # float64 against the CPU: odd sizes (pad and crop), include_scale
    x64 = np.random.RandomState(5).rand(*BP_SHAPE_64)
    tc = dt.Transform2d(*BP_FAMS, device="cpu")
    # the reconstruction of an odd-sized image keeps the duplicated edge
    rec_err = lambda r, x: float((r[..., :x.shape[-2], :x.shape[-1]]
                                  - torch.from_numpy(x)).abs().max())
    for layout in ("interleaved", "planes"):
        pg = t.forward(x64, NLEVELS, include_scale=True, layout=layout)
        rg = t.inverse(pg)
        pc = tc.forward(torch.from_numpy(x64), NLEVELS, include_scale=True,
                        layout=layout)
        rcpu = tc.inverse(pc)
        e = max(rel_err(a.cpu(), c) for a, c in zip(
            leaves(pg) + [rg], leaves(pc) + [rcpu]))
        check(e <= TOL[torch.float64],
              "2-D bandpass float64 %s %s, %d levels (pads and crops, "
              "include_scale): card vs CPU, every leaf and the "
              "reconstruction, rel err %.3g (tol %g); reconstruction max abs "
              "err card %.4f, CPU %.4f" % (
                  "x".join(map(str, BP_SHAPE_64)), layout, NLEVELS, e,
                  TOL[torch.float64],
                  rec_err(rg.cpu(), x64), rec_err(rcpu, x64)))


def time_bandpass(dev) -> None:
    """Phase 5 for the bandpass families: the round trip against the plain
    path with a trace (f32 interleaved), and each level kernel's bandpass
    variant at its main-path shapes against its bound, its plain version
    and the same kernel without the third stream on near_sym_b / qshift_b
    (the same filter lengths)."""
    import dtcwt_tpu_torch as dt
    t = dt.Transform2d(*BP_FAMS)
    x = torch.from_numpy(np.random.RandomState(0).rand(N, N).astype(
        np.float32)).to(dev)
    for label, dtype, layout in LAYOUTS:
        xd = x.to(dtype)
        ms = cuda_ms(lambda: t.inverse(t.forward(xd, NLEVELS, layout=layout)))
        with patched(level_plain_path()):
            pms = cuda_ms(lambda: t.inverse(t.forward(xd, NLEVELS,
                                                      layout=layout)))
        print("time round trip 2-D bandpass 4096x4096 %d levels %s: kernels "
              "%.3f ms, plain %.3f ms" % (NLEVELS, label, ms, pms),
              flush=True)
        if layout == "interleaved":
            print_trace("round trip 2-D bandpass %s" % label,
                        lambda: t.inverse(t.forward(xd, NLEVELS)))
    del x, xd
    bp = (dt.biort(BP_FAMS[0]), dt.qshift(BP_FAMS[1]))
    nobp = (dt.biort("near_sym_b"), dt.qshift("qshift_b"))
    for name, shapes in MAIN_SHAPES_2D.items():
        tot = collections.Counter()
        for shape in shapes:
            for label, dtype, layout in LAYOUTS:
                pl = layout == "planes"
                inp = level_inputs(name, shape, dtype, pl, dev)
                kern, plain = level_call(name, inp, pl, *bp)
                ms = cuda_ms(kern, hold=True)
                pms = cuda_ms(plain, hold=True)
                nms = cuda_ms(level_call(name, inp, pl, *nobp)[0], hold=True)
                bms, by = bound(nbytes(inp) + nbytes(kern()),
                                level_macs(name, inp, *bp))
                if dtype == torch.float32 and not pl:
                    tot.update(ms=ms, plain_ms=pms, nobp_ms=nms, bound_ms=bms)
                print("time %s bandpass %s %s: kernel %.4f ms, without the "
                      "third stream (near_sym_b / qshift_b) %.4f ms, plain "
                      "%.4f ms, bound %.4f ms (%s), %.1f%% of the bound "
                      "(without the third stream %.1f%%)" % (
                          name, "x".join(map(str, shape)), label, ms, nms,
                          pms, bms, by, 100 * bms / ms, 100 * bms / nms),
                      flush=True)
                del inp, kern, plain
        print("time %s bandpass, f32 interleaved, its %d launch(es) of one "
              "round trip: kernel %.4f ms, without the third stream %.4f ms, "
              "plain %.4f ms, bound %.4f ms" % (
                  name, len(shapes), tot["ms"], tot["nobp_ms"],
                  tot["plain_ms"], tot["bound_ms"]), flush=True)


# --- the 3-D main path ------------------------------------------------------

PACK_NAMES = ("fwd_level1_pack", "fwd_level2_pack", "inv_level2_pack",
              "inv_level1_pack")


def pack_case(name, vol, dtype, planes, dev, seed=0):
    """Inputs of one 3-D level entry whose level reads a [1, *vol] volume
    (forward) or produces one (inverse): the entry's arguments, and the
    kernel stage's own inputs (the depth stage already run) with its
    launch and its plain version.  Returns (entry, entry_plain, stage,
    stage_plain, stage_inputs)."""
    import dtcwt_tpu_torch as dt
    from dtcwt_tpu_torch.ops import dual, fb, pack3d
    from dtcwt_tpu_torch.ops.ilevel2 import ifilt_streams
    from dtcwt_tpu_torch.ops.level2 import dfilt_streams
    b, q = dt.biort("near_sym_a"), dt.qshift("qshift_a")
    level1 = "level1" in name
    if name.startswith("fwd"):
        x = rand((1,) + tuple(vol), seed, dev, dtype)
        if level1:
            f = (b[0], b[2])
            split = lambda v, ax: fb.filter2_axis(v, *f, ax)
            depth = lambda v: dual.filter2_axis(v, *f, -3)
            plans = pack3d._filter_plans(*f)
            Ho, Wo = vol[1], vol[2]
        else:
            f = ((q[1], q[0]), (q[5], q[4]))
            split = lambda v, ax: fb.dfilt2_axis(v, *f, ax)
            depth = lambda v: dual.dfilt2_axis(v, *f, -3)
            plans = [dfilt_streams(*p) for p in f]
            Ho, Wo = vol[1] // 2, vol[2] // 2
        entry = getattr(pack3d, name)
        plain = getattr(pack3d, name + "_reference")
        lo, hi = depth(x.float() if dtype == torch.bfloat16 else x)

        def stage_plain():
            octs = {}
            for i, v in enumerate((lo, hi)):
                for k, vk in enumerate(split(v, -1)):
                    for j, vj in enumerate(split(vk, -2)):
                        octs[(i, j, k)] = vj
            return (octs[(0, 0, 0)].to(dtype),
                    pack3d.pack_octants(octs, planes, dtype))

        def flat(out):
            lll, bands = out
            return (lll,) + (tuple(bands) if planes else (bands,))

        return ((lambda: flat(entry(x, *f, planes=planes))),
                (lambda: flat(plain(x, *f, planes=planes))),
                (lambda: pack3d._launch(name, (lo, hi), (), plans, dtype,
                                        planes, Ho, Wo, True)[:3 if planes
                                                              else 2]),
                (lambda: flat(stage_plain())), (lo, hi))
    # inverse: the level's lowpass and subbands
    D, H, W = vol if level1 else tuple(s // 2 for s in vol)
    lll = rand((1, D, H, W), seed, dev, dtype)
    bshape = (1, 28, D // 2, H // 2, W // 2)
    re = rand(bshape, seed + 1, dev, dtype)
    im = rand(bshape, seed + 2, dev, dtype)
    bands = (re, im) if planes else (
        torch.complex(re, im).movedim(-4, -1).contiguous(), None)
    if level1:
        f = (b[1], b[3])
        merge = lambda a, c, ax: fb.filter2_sum_axis(a, c, *f, ax)
        plans = pack3d._filter_plans(*f)
        Ho, Wo = H, W
    else:
        f = ((q[3], q[2]), (q[7], q[6]))
        merge = lambda a, c, ax: fb.ifilt2_sum_axis(a, c, *f, ax)
        plans = [ifilt_streams(*p) for p in f]
        Ho, Wo = 2 * H, 2 * W
    entry = getattr(pack3d, name)
    plain = getattr(pack3d, name + "_reference")

    def stage_plain():
        octs = pack3d.unpack_octants(bands if planes else bands[0])
        octs[(0, 0, 0)] = lll.float() if dtype == torch.bfloat16 else lll
        return tuple(merge(merge(octs[(i, 0, 0)], octs[(i, 0, 1)], -1),
                           merge(octs[(i, 1, 0)], octs[(i, 1, 1)], -1), -2)
                     for i in range(2))

    return ((lambda: entry(lll, *bands, *f)), (lambda: plain(lll, *bands, *f)),
            (lambda: tuple(pack3d._launch(name, (lll,), bands, plans, None,
                                          planes, Ho, Wo, False)[:2])),
            stage_plain, (lll,) + tuple(a for a in bands if a is not None))


def pack_macs(name, ins, outs) -> int:
    """Multiply-adds of one kernel stage (default filters): the W and H
    stages of both branches over the slices it reads (analysis) or writes
    (synthesis)."""
    import dtcwt_tpu_torch as dt
    b, q = dt.biort("near_sym_a"), dt.qshift("qshift_a")
    taps = {"fwd_level1_pack": b[0].size + b[2].size,
            "inv_level1_pack": b[1].size + b[3].size,
            "fwd_level2_pack": q[0].size, "inv_level2_pack": q[2].size}[name]
    n = sum(t.numel() for t in (ins if name.startswith("fwd") else outs))
    return 3 * n * taps


# per 3-level 256^3 round trip: the volume each call of a level entry reads
# (forward) or writes (inverse)
VOL = 256
PACK_VOLS = {"fwd_level1_pack": [(VOL,) * 3],
             "fwd_level2_pack": [(VOL,) * 3, (VOL // 2,) * 3],
             "inv_level2_pack": [(VOL // 2,) * 3, (VOL,) * 3],
             "inv_level1_pack": [(VOL,) * 3]}
LAUNCHES_3D = {"filter2": 1, "fwd_level1_pack": 1, "dfilt2": 2,
               "fwd_level2_pack": 2, "inv_level2_pack": 2, "ifilt2_sum": 2,
               "inv_level1_pack": 1, "filter2_sum": 1}
REC_TOL_3D = {torch.float32: 1e-4, torch.bfloat16: 0.08}


def check_3d(dev, report) -> dict:
    """Phase 3 and 4 for the 3-D path: each level kernel against its plain
    version, then the 256^3 round trip in three layouts with the launch
    counts.  Returns the counts of the f32 interleaved round trip."""
    import dtcwt_tpu_torch as dt
    from dtcwt_tpu_torch.ops import dual, pack3d
    for name in PACK_NAMES:
        for label, dtype, layout in LAYOUTS:
            pl = layout == "planes"
            worst = 0.0
            for vol in PACK_VOLS[name]:
                entry, plain, stage, stage_plain, _ = pack_case(
                    name, vol, dtype, pl, dev)
                for k, p in ((entry, plain), (stage, stage_plain)):
                    got = k()
                    torch.cuda.synchronize()
                    want = p()
                    worst = max(worst, rel_err(got, want))
                    if dtype == torch.float32 and not pl:
                        report[name]["max_abs_err"] = max(
                            report[name]["max_abs_err"], abs_err(got, want))
                    del got, want
            check(worst <= TOL[dtype], "kernel %s volumes %s %s (entry and "
                  "kernel stage): worst rel err %.3g (tol %g)" % (
                      name, PACK_VOLS[name], label, worst, TOL[dtype]))
    # float64 at small shapes the JAX envelope refuses: H or W not a
    # multiple of 32, above 512, or shorter than the filter; every family
    small = {1: [(4, 6, 10), (6, 36, 44), (2, 520, 6)],
             2: [(8, 8, 12), (8, 36, 20), (4, 516, 8)]}
    for name in PACK_NAMES:
        level = 1 if "level1" in name else 2
        fams = BIORTS if level == 1 else QSHIFTS
        worst = 0.0
        for fam in fams:
            taps = dt.biort(fam) if level == 1 else dt.qshift(fam)
            if level == 1:
                f = (taps[0], taps[2]) if name.startswith("fwd") else \
                    (taps[1], taps[3])
                if f[0].size % 2 == 0:
                    continue
            else:
                f = (((taps[1], taps[0]), (taps[5], taps[4]))
                     if name.startswith("fwd")
                     else ((taps[3], taps[2]), (taps[7], taps[6])))
            for seed, vol in enumerate(small[level]):
                for pl in (False, True):
                    fn = getattr(pack3d, name)
                    ref = getattr(pack3d, name + "_reference")
                    if name.startswith("fwd"):
                        x = rand((2,) + vol, seed, dev, torch.float64)
                        got = fn(x, *f, planes=pl)
                        torch.cuda.synchronize()
                        want = ref(x, *f, planes=pl)
                        got = (got[0],) + (tuple(got[1]) if pl
                                           else (got[1],))
                        want = (want[0],) + (tuple(want[1]) if pl
                                             else (want[1],))
                    else:
                        D, H, W = vol if level == 1 else tuple(
                            s // 2 for s in vol)
                        lll = rand((2, D, H, W), seed, dev, torch.float64)
                        bs = (2, 28, D // 2, H // 2, W // 2)
                        re = rand(bs, seed + 1, dev, torch.float64)
                        im = rand(bs, seed + 2, dev, torch.float64)
                        bands = (re, im) if pl else (torch.complex(
                            re, im).movedim(-4, -1).contiguous(), None)
                        got = fn(lll, *bands, *f)
                        torch.cuda.synchronize()
                        want = ref(lll, *bands, *f)
                    worst = max(worst, rel_err(got, want))
        check(worst <= TOL[torch.float64],
              "kernel %s float64, families %s, [2, *%s], both layouts: "
              "worst rel err %.3g (tol %g)" % (
                  name, ",".join(fams), small[level], worst,
                  TOL[torch.float64]))

    t3 = dt.Transform3d()
    x32 = rand((VOL,) * 3, 11, dev, torch.float32)
    no_plain = ([(pack3d, n + "_reference", refuse) for n in PACK_NAMES]
                + [(dual, n + "_axis_reference", refuse) for n in
                   ("filter2", "dfilt2", "ifilt2_sum", "filter2_sum")])
    plain_path = [(pack3d, n, getattr(pack3d, n + "_reference"))
                  for n in PACK_NAMES]
    from dtcwt_tpu_torch.ops import _build
    launches = {}
    for label, dtype, layout in LAYOUTS:
        x = x32.to(dtype)
        _build.reset_launches()
        with patched(no_plain):
            pyr = t3.forward(x, nlevels=NLEVELS, layout=layout)
            rec = t3.inverse(pyr)
            torch.cuda.synchronize()
        counts = dict(_build.launches)
        if not launches:
            launches = counts
        check(counts == LAUNCHES_3D,
              "main path 3-D %s: launches %s" % (label, counts))
        hp = pyr.highpasses if layout == "interleaved" else pyr.highpasses_re
        shapes_ok = (tuple(rec.shape) == (VOL,) * 3 and rec.dtype == dtype
                     and tuple(pyr.lowpass.shape) == (VOL // 4,) * 3
                     and len(hp) == NLEVELS)
        finite = bool(torch.isfinite(rec.float()).all()) and all(
            bool(torch.isfinite(torch.view_as_real(h) if h.is_complex()
                                else h.float()).all()) for h in hp)
        err = float((rec.float() - x.float()).abs().max())
        check(shapes_ok and finite and err <= REC_TOL_3D[dtype],
              "main path 3-D %s: %d^3 %d-level round trip, reconstruction "
              "max abs err %.3g (tol %g), shapes %s, finite %s" % (
                  label, VOL, NLEVELS, err, REC_TOL_3D[dtype], shapes_ok,
                  finite))
        with patched(plain_path):
            rec_plain = t3.inverse(t3.forward(x, nlevels=NLEVELS,
                                              layout=layout))
        e = rel_err(rec, rec_plain)
        check(e <= TOL[dtype] * 10, "main path 3-D %s: kernel vs plain path "
              "on the card, reconstruction rel err %.3g (tol %g)" % (
                  label, e, TOL[dtype] * 10))
        del pyr, rec, rec_plain
    # pads and crops at levels 2 and 3 in both ext_modes, a batch, every
    # leaf against the plain path, float32
    for em, shape in ((4, (2, 50, 70, 90)), (8, (40, 56, 72))):
        tm = dt.Transform3d(ext_mode=em)
        xb = rand(shape, 12, dev, torch.float32)
        pk = tm.forward(xb, NLEVELS, include_scale=True)
        rk = tm.inverse(pk)
        with patched(plain_path):
            pp = tm.forward(xb, NLEVELS, include_scale=True)
            rp = tm.inverse(pp)
        e = max([rel_err(pk.lowpass, pp.lowpass), rel_err(rk, rp)]
                + [rel_err(a, c) for a, c in zip(pk.highpasses + pk.scales,
                                                 pp.highpasses + pp.scales)])
        rec_e = float((rk - xb).abs().max())
        check(e <= TOL[torch.float32] and rec_e <= REC_TOL_3D[torch.float32],
              "3-D ext_mode %d %s (pad + crop): kernel vs plain rel err %.3g,"
              " reconstruction max abs err %.3g" % (em, "x".join(map(
                  str, shape)), e, rec_e))
    return launches


def time_3d(dev, report) -> None:
    """Phase 5 for the 3-D path: the round trip against the plain path in
    three layouts, a profiler trace, and each level kernel alone (device
    time, stream held) against its plain version and its bound."""
    import dtcwt_tpu_torch as dt
    from dtcwt_tpu_torch.ops import pack3d
    t3 = dt.Transform3d()
    x = rand((VOL,) * 3, 11, dev, torch.float32)
    plain_path = [(pack3d, n, getattr(pack3d, n + "_reference"))
                  for n in PACK_NAMES]
    for label, dtype, layout in LAYOUTS:
        xd = x.to(dtype)
        run = lambda: t3.inverse(t3.forward(xd, NLEVELS, layout=layout))
        ms = cuda_ms(run)
        with patched(plain_path):
            pms = cuda_ms(run, reps=3, warmup=1)
        print("time round trip 3-D %d^3 %d levels %s: kernels %.3f ms, "
              "plain %.3f ms" % (VOL, NLEVELS, label, ms, pms), flush=True)
        if dtype == torch.float32:
            print_trace("round trip 3-D %s" % label, run)
    del x
    for name in PACK_NAMES:
        for label, dtype, layout in LAYOUTS:
            pl = layout == "planes"
            tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bound_by": "bytes"}
            for vol in PACK_VOLS[name]:
                entry, _, stage, stage_plain, ins = pack_case(
                    name, vol, dtype, pl, dev)
                outs = stage()
                bms, by = bound(nbytes(ins) + nbytes(outs),
                                pack_macs(name, ins, outs))
                ms = cuda_ms(stage, hold=True)
                pms = cuda_ms(stage_plain, hold=True, reps=3, warmup=1)
                ems = cuda_ms(entry, hold=True)
                for k, v in (("ms", ms), ("plain_ms", pms),
                             ("bound_ms", bms)):
                    tot[k] += v
                if by != "bytes":
                    tot["bound_by"] = by
                print("time %s %s %s: kernel %.4f ms, plain %.4f ms, bound "
                      "%.4f ms (%s); the entry with its depth stage %.4f ms"
                      % (name, "x".join(map(str, vol)), label, ms, pms, bms,
                         by, ems), flush=True)
                del entry, stage, stage_plain, ins, outs
            print("time %s %s, its %d launch(es) of one round trip: kernel "
                  "%.4f ms, plain %.4f ms, bound %.4f ms" % (
                      name, label, len(PACK_VOLS[name]), tot["ms"],
                      tot["plain_ms"], tot["bound_ms"]), flush=True)
            if dtype == torch.float32 and not pl:
                report[name].update(tot)


# --- the single-stream kernels: the low-level API, the 3-D discard path
# and compat ------------------------------------------------------------------

SINGLE_NAMES = ("filter", "dfilt", "ifilt")
# per 3-level 256^3 discard_level_1 round trip
LAUNCHES_DISCARD = {"filter": 6, "dfilt2": 2, "fwd_level2_pack": 2,
                    "inv_level2_pack": 2, "ifilt2_sum": 2}
# the low-level path: LOWLEVEL at 4096^2 in float32 and bfloat16
LAUNCHES_LOWLEVEL = {"filter": 8, "dfilt": 4, "ifilt": 4}


def lowlevel_calls():
    """The low-level API's main path on a 4096^2 image: (kernel, public
    name, filters, axis) of each call, default filters."""
    import dtcwt_tpu_torch as dt
    b, q = dt.biort("near_sym_a"), dt.qshift("qshift_a")
    out = []
    for h in (b[0], b[2]):
        out += [("filter", "colfilter", (h,), -2),
                ("filter", "rowfilter", (h,), -1)]
    return out + [("dfilt", "coldfilt", (q[1], q[0]), -2),
                  ("dfilt", "rowdfilt", (q[1], q[0]), -1),
                  ("ifilt", "colifilt", (q[3], q[2]), -2),
                  ("ifilt", "rowifilt", (q[3], q[2]), -1)]


def discard_calls():
    """The six filter passes of one 256^3 discard_level_1 round trip:
    (filters, axis); forward W, H, D with h0o, inverse H, D, W with g0o."""
    import dtcwt_tpu_torch as dt
    b = dt.biort("near_sym_a")
    return ([((b[0],), ax) for ax in (-1, -2, -3)]
            + [((b[1],), ax) for ax in (-2, -3, -1)])


def single_call(name, x, f, axis, side=None):
    """(kernel wrapper, plain version) of single kernel *name*."""
    from dtcwt_tpu_torch.ops import single
    if side is None:
        k = getattr(single, name + "_axis")
        p = getattr(single, name + "_axis_reference")
        return (lambda: k(x, *f, axis)), (lambda: p(x, *f, axis))
    k = getattr(single, name + "_fromext_axis")
    p = getattr(single, name + "_fromext_axis_reference")
    return (lambda: k(x, side, *f, axis)), (lambda: p(x, side, *f, axis))


def single_macs(name, f, out) -> int:
    """Multiply-adds of one call: every output sample sums m taps (filter,
    dfilt) or m / 2 (ifilt)."""
    m = np.asarray(f[0]).size
    return out.numel() * (m // 2 if name == "ifilt" else m)


def single_plain_path():
    """Patches that route every entry of the discard round trip to its plain
    version."""
    from dtcwt_tpu_torch.ops import pack3d, single
    return ([(pack3d, n, getattr(pack3d, n + "_reference"))
             for n in PACK_NAMES]
            + [(single, "filter_axis", single.filter_axis_reference)])


def single_no_plain():
    """Patches that make every plain version of the kernels raise."""
    from dtcwt_tpu_torch.ops import dual, pack3d, single
    return ([(pack3d, n + "_reference", refuse) for n in PACK_NAMES]
            + [(dual, n + "_axis_reference", refuse) for n in
               ("filter2", "dfilt2", "ifilt2_sum", "filter2_sum")]
            + [(single, n + suffix, refuse) for n in SINGLE_NAMES
               for suffix in ("_axis_reference", "_fromext_axis_reference")])


def ellipsoid(n, dev):
    """tests/test_transform3d.py's ellipsoid (the reference's gate for
    discard_level_1), n^3, float32."""
    g = torch.arange(-(n >> 1), n >> 1, device=dev, dtype=torch.float32)
    X, Y, Z = torch.meshgrid(g, g, g, indexing="ij")
    r = torch.sqrt(X * X + (1.2 * Y) ** 2 + (1.4 * Z) ** 2)
    return (r <= 0.4 * n).float()


def check_single(dev, report):
    """Phase 3 and 4 for the single-stream kernels: each kernel against its
    plain version, then the 256^3 discard_level_1 round trip, the low-level
    API path, the compat entries and the 2-D channel adapter.  Returns the
    launch counts of the discard round trip (f32 interleaved) and of the
    low-level path."""
    import dtcwt_tpu_torch as dt
    from dtcwt_tpu_torch import compat, ops
    from dtcwt_tpu_torch.ops import _build, fb
    # phase 3: the main-path shapes
    img = rand((N, N), 21, dev, torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        worst = dict.fromkeys(SINGLE_NAMES, 0.0)
        for name, _, f, axis in lowlevel_calls():
            kern, plain = single_call(name, img.to(dtype), f, axis)
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            worst[name] = max(worst[name], rel_err(got, want))
            if dtype == torch.float32 and name != "filter":
                report[name]["max_abs_err"] = max(
                    report[name]["max_abs_err"], abs_err(got, want))
            del got, want
        for name in SINGLE_NAMES:
            check(worst[name] <= TOL[dtype], "kernel %s %dx%d axes -2 and -1"
                  " %s: worst rel err %.3g (tol %g)" % (
                      name, N, N, dtype, worst[name], TOL[dtype]))
    del img
    vol = rand((VOL,) * 3, 22, dev, torch.float32)
    worst = 0.0
    for f, axis in discard_calls():
        kern, plain = single_call("filter", vol, f, axis)
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        worst = max(worst, rel_err(got, want))
        report["filter"]["max_abs_err"] = max(
            report["filter"]["max_abs_err"], abs_err(got, want))
        del got, want
    check(worst <= TOL[torch.float32], "kernel filter %d^3 axes -1, -2, -3 "
          "(h0o and g0o) float32: worst rel err %.3g (tol %g)" % (
              VOL, worst, TOL[torch.float32]))
    del vol
    # float64 at small shapes: every family's filters (bandpass included;
    # both signs of sum(ha*hb)), axes -1/-2/-3, signals shorter than the
    # filter, one signal (inner = 1), both modes
    dual_small = [((8, 20, 36), (-1, -2, -3)), ((4, 8, 4), (-1, -2, -3)),
                  ((1028, 1), (0,)), ((12, 130), (0,))]
    side = 32
    fams = {"filter": dt.BIORT_NAMES, "dfilt": dt.QSHIFT_NAMES,
            "ifilt": dt.QSHIFT_NAMES}
    for name in SINGLE_NAMES:
        worst = 0.0
        for fam in fams[name]:
            if name == "filter":
                filters = [(h,) for h in dt.biort(fam)]
            else:
                qq = dt.qshift(fam)
                first = 0 if name == "dfilt" else 2
                filters = [(qq[i + 1], qq[i])
                           for i in range(first, len(qq), 4)]
            for f in filters:
                for seed, (shape, axes) in enumerate(dual_small):
                    x = rand(shape, seed, dev, torch.float64)
                    for axis in axes:
                        for s in (None, side):
                            xin = x if s is None else fb.symmetric_extend(
                                x, s, axis).contiguous()
                            kern, plain = single_call(name, xin, f, axis, s)
                            got = kern()
                            torch.cuda.synchronize()
                            worst = max(worst, rel_err(got, plain()))
        check(worst <= TOL[torch.float64],
              "kernel %s float64, families %s, shapes %s on every axis, "
              "axis and from-extension modes: worst rel err %.3g (tol %g)"
              % (name, ",".join(fams[name]), [s for s, _ in dual_small],
                 worst, TOL[torch.float64]))

    # phase 4: the discard_level_1 round trip in three layouts
    t3 = dt.Transform3d()
    x32 = rand((VOL,) * 3, 23, dev, torch.float32)
    launches = {}
    for label, dtype, layout in LAYOUTS:
        x = x32.to(dtype)
        _build.reset_launches()
        with patched(single_no_plain()):
            pyr = t3.forward(x, nlevels=NLEVELS, layout=layout,
                             discard_level_1=True)
            rec = t3.inverse(pyr)
            torch.cuda.synchronize()
        counts = dict(_build.launches)
        if not launches:
            launches = counts
        check(counts == LAUNCHES_DISCARD,
              "main path 3-D discard_level_1 %s: launches %s" % (label,
                                                                 counts))
        hp = pyr.highpasses if layout == "interleaved" else pyr.highpasses_re
        shapes_ok = (tuple(rec.shape) == (VOL,) * 3 and rec.dtype == dtype
                     and tuple(pyr.lowpass.shape) == (VOL // 4,) * 3
                     and len(hp) == NLEVELS and hp[0] is None)
        finite = bool(torch.isfinite(rec.float()).all()) and all(
            bool(torch.isfinite(torch.view_as_real(h) if h.is_complex()
                                else h.float()).all()) for h in hp[1:])
        with patched(single_plain_path()):
            pp = t3.forward(x, nlevels=NLEVELS, layout=layout,
                            discard_level_1=True)
            rec_plain = t3.inverse(pp)
        e = max([rel_err(rec, rec_plain), rel_err(pyr.lowpass, pp.lowpass)]
                + [rel_err(a, c) for a, c in zip(hp[1:], (
                    pp.highpasses if layout == "interleaved"
                    else pp.highpasses_re)[1:])])
        check(shapes_ok and finite and e <= TOL[dtype] * 10,
              "main path 3-D discard_level_1 %s: %d^3 %d-level round trip, "
              "kernel vs plain path on the card (lowpass, levels 2-3, "
              "reconstruction) rel err %.3g (tol %g), shapes %s, finite %s"
              % (label, VOL, NLEVELS, e, TOL[dtype] * 10, shapes_ok, finite))
        del pyr, rec, pp, rec_plain
    del x32
    # the reference's behavioural gate: a lowpass-only level 1 still
    # reconstructs an ellipsoid to a median abs error under 1e-3
    ell = ellipsoid(VOL, dev)
    rec = t3.inverse(t3.forward(ell, NLEVELS, discard_level_1=True))
    med = float((rec - ell).abs().median())
    check(med < 1e-3, "main path 3-D discard_level_1: %d^3 ellipsoid "
          "reconstruction median abs err %.3g (reference gate 1e-3)"
          % (VOL, med))
    del ell, rec
    xs = np.random.RandomState(24).rand(20, 24, 28)
    tc = dt.Transform3d(device="cpu")
    e = 0.0
    for layout in ("interleaved", "planes"):
        pg = t3.forward(xs, NLEVELS, layout=layout, discard_level_1=True,
                        include_scale=True)
        pc = tc.forward(torch.from_numpy(xs), NLEVELS, layout=layout,
                        discard_level_1=True, include_scale=True)
        hg = pg.highpasses if layout == "interleaved" else \
            pg.highpasses_re + pg.highpasses_im
        hc = pc.highpasses if layout == "interleaved" else \
            pc.highpasses_re + pc.highpasses_im
        e = max([e, rel_err(t3.inverse(pg).cpu(), tc.inverse(pc))]
                + [rel_err(a.cpu(), c) for a, c in zip(
                    (pg.lowpass,) + pg.scales + tuple(
                        h for h in hg if h is not None),
                    (pc.lowpass,) + pc.scales + tuple(
                        h for h in hc if h is not None))])
    check(e <= TOL[torch.float64], "3-D discard_level_1 float64 20x24x28 "
          "(pad + crop at level 3), both layouts: card vs CPU, every leaf, "
          "rel err %.3g (tol %g)" % (e, TOL[torch.float64]))

    # the low-level API at 4096^2, float32 and bfloat16
    img = rand((N, N), 25, dev, torch.float32)
    outs = []
    _build.reset_launches()
    with patched(single_no_plain()):
        for dtype in (torch.float32, torch.bfloat16):
            xd = img.to(dtype)
            for name, fn, f, axis in lowlevel_calls():
                outs.append((name, fn, f, axis, xd,
                             getattr(ops, fn)(xd, *f)))
        torch.cuda.synchronize()
    low_launches = dict(_build.launches)
    check(low_launches == LAUNCHES_LOWLEVEL,
          "main path low-level API %dx%d (colfilter, rowfilter with h0o and"
          " h1o; coldfilt, rowdfilt; colifilt, rowifilt; f32 and bf16): "
          "launches %s" % (N, N, low_launches))
    worst = 0.0
    for name, fn, f, axis, xd, got in outs:
        want = single_call(name, xd, f, axis)[1]()
        worst = max(worst, rel_err(got, want) / TOL[xd.dtype])
    check(worst <= 1.0, "main path low-level API %dx%d: every call against "
          "its plain version, worst rel err / tol %.3g" % (N, N, worst))
    del outs, img

    # each compat entry at its main-path size: the Transform's result, with
    # the same launch counts
    def same(a, b):
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(same(u, v) for u, v in zip(a, b))
        if a is None or b is None:
            return a is None and b is None
        return torch.equal(a, b)

    v = rand((VOL,) * 3, 26, dev, torch.float32)
    im = rand((N, N), 27, dev, torch.float32)
    sig = rand((N1, C1), 28, dev, torch.float32)
    entries = (
        ("dtwavexfm3 / dtwaveifm3, discard_level_1, %d^3" % VOL,
         lambda: compat.dtwavexfm3(v, NLEVELS, discard_level_1=True),
         lambda yl, yh: compat.dtwaveifm3(yl, yh),
         lambda: t3.forward(v, NLEVELS, discard_level_1=True), t3,
         LAUNCHES_DISCARD),
        ("dtwavexfm2 / dtwaveifm2, %dx%d" % (N, N),
         lambda: compat.dtwavexfm2(im, NLEVELS),
         lambda yl, yh: compat.dtwaveifm2(yl, yh),
         lambda: dt.Transform2d().forward(im, NLEVELS), dt.Transform2d(),
         LAUNCHES_2D),
        ("dtwavexfm / dtwaveifm, %dx%d, %d levels" % (N1, C1, NLEVELS1),
         lambda: compat.dtwavexfm(sig, NLEVELS1),
         lambda yl, yh: compat.dtwaveifm(yl, yh),
         lambda: dt.Transform1d().forward(sig, NLEVELS1), dt.Transform1d(),
         LAUNCHES_1D))
    for what, xfm, ifm, fwd, tr, want_counts in entries:
        _build.reset_launches()
        with patched(single_no_plain()):
            yl, yh = xfm()
            rec = ifm(yl, yh)
            torch.cuda.synchronize()
        counts = dict(_build.launches)
        p = fwd()
        ok = (same((yl, yh), (p.lowpass, p.highpasses))
              and torch.equal(rec, tr.inverse(p)))
        check(ok and counts == want_counts, "main path compat %s: equal to "
              "the Transform's result %s, launches %s" % (what, ok, counts))
        del yl, yh, rec, p
    del v, im, sig

    # the 2-D channel adapter against forward on the moved axes
    t2 = dt.Transform2d()
    xc = rand((2, 1024, 1024, 3), 29, dev, torch.float32)
    pc = t2.forward_channels(xc, "nhwc", NLEVELS)
    pm = t2.forward(xc.movedim(-1, 1), NLEVELS)
    ok = torch.equal(pc.lowpass, pm.lowpass.movedim(1, -1)) and all(
        torch.equal(a, b.movedim(1, -2))
        for a, b in zip(pc.highpasses, pm.highpasses))
    rec_e = float((t2.inverse_channels(pc, "nhwc") - xc).abs().max())
    check(ok and rec_e <= REC_TOL[torch.float32],
          "main path forward_channels(x, 'nhwc') 2x1024x1024x3: equal to "
          "forward on the moved axes %s, inverse_channels reconstruction "
          "max abs err %.3g" % (ok, rec_e))
    return launches, low_launches


def conv_filter(x, h, axis):
    """One F.conv2d computing ``filter_axis(x, h, axis)`` of a [D, H, W]
    volume or an [H, W] image (axis -2 or -1) from its input pre-extended
    by len(h)//2 a side (the extension made here, outside the timed call):
    (call, its output in the shape of *x*)."""
    from dtcwt_tpu_torch.ops import fb
    h = np.asarray(h, np.float64).reshape(-1)
    m = h.size
    ext = fb.symmetric_extend(x, m // 2, axis).contiguous()
    w = torch.from_numpy(h[::-1].copy()).to(x.device, x.dtype)
    D, H, W = ext.shape if ext.ndim == 3 else (1,) + tuple(ext.shape)
    if axis == -3:
        inp, weight = ext.reshape(1, 1, D, H * W), w.view(1, 1, m, 1)
    elif axis == -2:
        inp, weight = ext.reshape(D, 1, H, W), w.view(1, 1, m, 1)
    else:
        inp, weight = ext.reshape(1, 1, D * H, W), w.view(1, 1, 1, m)
    return (lambda: F.conv2d(inp, weight)), (lambda y: y.reshape(x.shape))


def time_single(dev, report) -> None:
    """Phase 5 for the single-stream kernels: the discard_level_1 round
    trip against the plain path in three layouts with a profiler trace,
    each kernel alone at its main-path shapes (device time, stream held)
    against its plain version and its bound, and filter's library call."""
    import dtcwt_tpu_torch as dt
    t3 = dt.Transform3d()
    x = rand((VOL,) * 3, 23, dev, torch.float32)
    for label, dtype, layout in LAYOUTS:
        xd = x.to(dtype)
        run = lambda: t3.inverse(t3.forward(xd, NLEVELS, layout=layout,
                                            discard_level_1=True))
        ms = cuda_ms(run)
        with patched(single_plain_path()):
            pms = cuda_ms(run, reps=3, warmup=1)
        print("time round trip 3-D discard_level_1 %d^3 %d levels %s: "
              "kernels %.3f ms, plain %.3f ms" % (VOL, NLEVELS, label, ms,
                                                  pms), flush=True)
        if dtype == torch.float32 and layout == "interleaved":
            print_trace("round trip 3-D discard_level_1 %s" % label, run)
    # filter: the six passes of the discard round trip, f32
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
           "library_ms": 0.0}
    for f, axis in discard_calls():
        kern, plain = single_call("filter", x, f, axis)
        out = kern()
        bms, by = bound(nbytes(x) + nbytes(out), single_macs("filter", f,
                                                             out))
        ms = cuda_ms(kern, hold=True)
        pms = cuda_ms(plain, hold=True, reps=3, warmup=1)
        lib, shape = conv_filter(x, f[0], axis)
        lms = cuda_ms(lib, hold=True)
        lerr = rel_err(shape(lib()), out)
        for k, v in (("ms", ms), ("plain_ms", pms), ("bound_ms", bms),
                     ("library_ms", lms)):
            tot[k] += v
        if by != "bytes":
            tot["bound_by"] = by
        print("time filter %d^3 axis %d (%d taps) f32: kernel %.4f ms (%.1f%%"
              " of the bound), plain %.4f ms, bound %.4f ms (%s), library "
              "F.conv2d (TF32 off) %.4f ms (rel err against the kernel %.3g)"
              % (VOL, axis, np.asarray(f[0]).size, ms, 100 * bms / ms, pms,
                 bms, by, lms, lerr), flush=True)
        del out, lib
    print("time filter, its 6 launches of one discard_level_1 round trip: "
          "kernel %.4f ms (%.1f%% of the bound), plain %.4f ms, bound %.4f "
          "ms, F.conv2d %.4f ms" % (
              tot["ms"], 100 * tot["bound_ms"] / tot["ms"], tot["plain_ms"],
              tot["bound_ms"], tot["library_ms"]), flush=True)
    report["filter"].update(tot)
    del x
    # the low-level path at 4096^2; dfilt and ifilt report its f32 calls
    img = rand((N, N), 21, dev, torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        tot = {n: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bound_by": "bytes"} for n in SINGLE_NAMES}
        xd = img.to(dtype)
        for name, fn, f, axis in lowlevel_calls():
            kern, plain = single_call(name, xd, f, axis)
            out = kern()
            bms, by = bound(nbytes(xd) + nbytes(out),
                            single_macs(name, f, out))
            ms = cuda_ms(kern, hold=True)
            pms = cuda_ms(plain, hold=True, reps=3, warmup=1)
            for k, v in (("ms", ms), ("plain_ms", pms), ("bound_ms", bms)):
                tot[name][k] += v
            if by != "bytes":
                tot[name]["bound_by"] = by
            lib_note = ""
            if name == "filter":
                lib, shape = conv_filter(xd, f[0], axis)
                lms = cuda_ms(lib, hold=True)
                lib_note = (", library F.conv2d (TF32 off) %.4f ms (rel err "
                            "against the kernel %.3g)" % (
                                lms, rel_err(shape(lib()), out)))
                del lib
            print("time %s (%s) %dx%d axis %d (%d taps) %s: kernel %.4f ms "
                  "(%.1f%% of the bound), plain %.4f ms, bound %.4f ms (%s)%s"
                  % (name, fn, N, N, axis, np.asarray(f[0]).size, dtype, ms,
                     100 * bms / ms, pms, bms, by, lib_note), flush=True)
            del out
        if dtype == torch.float32:
            for name in ("dfilt", "ifilt"):
                report[name].update(tot[name])
    del img


# --- the sharded 3-D path and the two-sided (H, W) kernels ------------------

HW_NAMES = ("filter_hw22", "dfilt_hw22", "filter_sum_hw22", "ifilt_sum_hw22")
SHARDS = 4      # the card mesh: (1, 4) over ("data", "depth"), ["cuda"] * 4
# per 256^3 3-level round trip on the card mesh, every level depth-sharded
# (local depths 64, 64, 32): the shard each hw entry reads, once per shard
HW_SHAPES = {"filter_hw22": [(1, 64, VOL, VOL)],
             "dfilt_hw22": [(1, 64, VOL, VOL), (1, 32, VOL // 2, VOL // 2)],
             "filter_sum_hw22": [(1, 64, VOL, VOL)],
             "ifilt_sum_hw22": [(1, 32, VOL // 4, VOL // 4),
                                (1, 64, VOL // 2, VOL // 2)]}
LAUNCHES_SHARDED = {"filter_hw22": 4, "dfilt_hw22": 8, "filter2": 16,
                    "dfilt2": 32, "ifilt2_sum": 32, "ifilt_sum_hw22": 8,
                    "filter2_sum": 16, "filter_sum_hw22": 4}
# [1, 32, 256, 256] on the card mesh: level 1 depth-sharded, levels 2-3
# gathered (the inverse's (H, W) merge on ifilt_sum_hw22, JAX's
# transform3d_dist.py:557 route)
LAUNCHES_DEGRADE = {"filter_hw22": 4, "filter2": 16, "dfilt2": 2,
                    "fwd_level2_pack": 2, "ifilt2_sum": 8,
                    "ifilt_sum_hw22": 2, "filter2_sum": 16,
                    "filter_sum_hw22": 4}
DUAL_NAMES = ("filter2", "dfilt2", "ifilt2_sum", "filter2_sum")


def hw_filters(name, fam=None):
    """The filters of one hw entry: a biort family's (h0o, h1o) / (g0o,
    g1o), a qshift family's analysis or synthesis pairs (default filters
    near_sym_a / qshift_a)."""
    import dtcwt_tpu_torch as dt
    if name in ("filter_hw22", "filter_sum_hw22"):
        b = dt.biort(fam or "near_sym_a")
        return (b[0], b[2]) if name == "filter_hw22" else (b[1], b[3])
    q = dt.qshift(fam or "qshift_a")
    return (((q[1], q[0]), (q[5], q[4])) if name == "dfilt_hw22"
            else ((q[3], q[2]), (q[7], q[6])))


def hw_case(name, shape, dtype, dev, fam=None, seed=0):
    """(kernel call, plain call, inputs) of one hw entry on random inputs
    of *shape*; the analysis outputs flattened to (u00, u01, u10, u11)."""
    from dtcwt_tpu_torch.ops import hw
    f = hw_filters(name, fam)
    n = 4 if "sum" in name else 1
    xs = [rand(shape, seed + i, dev, dtype) for i in range(n)]
    k, p = getattr(hw, name), getattr(hw, name + "_reference")
    flat = (lambda u: u) if n == 4 else (
        lambda u: tuple(v for row in u for v in row))
    return (lambda: flat(k(*xs, *f))), (lambda: flat(p(*xs, *f))), xs


def hw_macs(name, shape) -> int:
    """Multiply-adds of one call: the W stage of every input image and the
    H stage of every output, each output sample summing its stream's taps
    (filter and dfilt m, ifilt m / 2)."""
    f = hw_filters(name)
    N = int(np.prod(shape[:-2]))
    H, W = shape[-2:]
    if name in ("filter_hw22", "filter_sum_hw22"):
        taps, HO, WO = sum(np.asarray(h).size for h in f), H, W
    elif name == "dfilt_hw22":
        taps, HO, WO = 2 * np.asarray(f[0][0]).size, H // 2, W // 2
    else:
        taps, HO, WO = np.asarray(f[0][0]).size, 2 * H, 2 * W
    if "sum" in name:
        return N * taps * (2 * H * WO + HO * WO)
    return N * taps * (H * WO + 2 * HO * WO)


def hw_einsum(name, xs):
    """One ``torch.einsum("ah,nhw,wb->nab")`` computing the same map with the
    dense operators (the plain single-stream filters on an identity, built
    here outside the timed call): (call, its outputs as the kernel's)."""
    from dtcwt_tpu_torch.ops import fb
    f = hw_filters(name)
    x = xs[0]
    lead, (H, W) = tuple(x.shape[:-2]), tuple(x.shape[-2:])

    def op(n, g):
        eye = torch.eye(n, dtype=torch.float64)
        if name in ("filter_hw22", "filter_sum_hw22"):
            return fb.filter_axis(eye, g, 0)
        if name == "dfilt_hw22":
            return fb.dfilt_axis(eye, *g, 0)
        return fb.ifilt_axis(eye, *g, 0)

    to = lambda m: m.to(x.device, x.dtype).contiguous()
    A = [op(H, g) for g in f]                 # [HO, H] from the left
    Bt = [op(W, g) for g in f]                # [WO, W], B = Bt^T
    HO, WO = A[0].shape[0], Bt[0].shape[0]
    if "sum" not in name:
        a, bm = to(torch.cat(A, 0)), to(torch.cat(Bt, 0).T)
        v = x.reshape((-1, H, W))
        call = lambda: torch.einsum("ah,nhw,wb->nab", a, v, bm)

        def shape(y):
            return tuple(y[:, j * HO:(j + 1) * HO, k * WO:(k + 1) * WO]
                         .reshape(lead + (HO, WO))
                         for j in range(2) for k in range(2))
        return call, shape
    a, bm = to(torch.cat(A, 1)), to(torch.cat(Bt, 1).T)
    v = torch.cat([torch.cat(xs[0:2], -1), torch.cat(xs[2:4], -1)],
                  -2).reshape((-1, 2 * H, 2 * W))
    return (lambda: torch.einsum("ah,nhw,wb->nab", a, v, bm)), (
        lambda y: y.reshape(lead + (HO, WO)))


def sharded_no_plain():
    """Patches that make every plain version of the sharded path raise."""
    from dtcwt_tpu_torch.ops import dual, hw
    return (single_no_plain()
            + [(hw, n + "_reference", refuse) for n in HW_NAMES]
            + [(dual, n + "_fromext_axis_reference", refuse)
               for n in DUAL_NAMES])


def sharded_plain_path():
    """Patches that route every kernel entry of the sharded path to its
    plain version."""
    from dtcwt_tpu_torch.ops import dual, hw, pack3d, single
    return ([(hw, n, getattr(hw, n + "_reference")) for n in HW_NAMES]
            + [(dual, n + s, getattr(dual, n + s + "_reference"))
               for n in DUAL_NAMES for s in ("_axis", "_fromext_axis")]
            + [(single, n, getattr(single, n + "_reference"))
               for n in ("filter_axis", "filter_fromext_axis")]
            + [(pack3d, n, getattr(pack3d, n + "_reference"))
               for n in PACK_NAMES])


def check_sharded(dev, report) -> dict:
    """Phase 3 and 4 for the sharded 3-D path: each hw kernel against its
    plain version, then the 256^3 3-level round trip on the (1, 4) card
    mesh in three layouts with the launch counts, against Transform3d and
    the plain path; a plan that gathers, a rows mesh, float64 against the
    CPU.  Returns the launch counts of the f32 interleaved round trip."""
    import dtcwt_tpu_torch as dt
    from dtcwt_tpu_torch.ops import _build
    from dtcwt_tpu_torch.parallel import ShardedTransform3d, make_mesh
    for name in HW_NAMES:
        for dtype in (torch.float32, torch.bfloat16):
            worst = 0.0
            for shape in HW_SHAPES[name]:
                kern, plain, _ = hw_case(name, shape, dtype, dev)
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                worst = max(worst, rel_err(got, want))
                if dtype == torch.float32:
                    report[name]["max_abs_err"] = max(
                        report[name]["max_abs_err"], abs_err(got, want))
                del got, want
            check(worst <= TOL[dtype], "kernel %s shards %s %s: worst rel err"
                  " %.3g (tol %g)" % (name, HW_SHAPES[name], dtype, worst,
                                      TOL[dtype]))
    # float64 at shapes the JAX envelope refuses (H or W off its 8 x 128
    # grid, above 512, shorter than the filter), every family
    small = [(3, 12, 20), (2, 2, 8, 132), (1, 520, 8), (2, 4, 4)]
    for name in HW_NAMES:
        fams = (("antonini", "near_sym_a", "near_sym_b")
                if name in ("filter_hw22", "filter_sum_hw22") else QSHIFTS)
        worst = 0.0
        for fam in fams:
            for seed, shape in enumerate(small):
                kern, plain, _ = hw_case(name, shape, torch.float64, dev,
                                         fam, seed)
                got = kern()
                torch.cuda.synchronize()
                worst = max(worst, rel_err(got, plain()))
        check(worst <= TOL[torch.float64], "kernel %s float64, families %s, "
              "shapes %s: worst rel err %.3g (tol %g)" % (
                  name, ",".join(fams), small, worst, TOL[torch.float64]))

    mesh = make_mesh((1, SHARDS), ("data", "depth"), ["cuda"] * SHARDS)
    st, t3 = ShardedTransform3d(mesh), dt.Transform3d()
    x32 = rand((1,) + (VOL,) * 3, 31, dev, torch.float32)
    launches = {}
    for label, dtype, layout in LAYOUTS:
        x = x32.to(dtype)
        _build.reset_launches()
        with patched(sharded_no_plain()):
            pyr = st.forward(x, NLEVELS, layout=layout)
            rec = st.inverse(pyr)
            torch.cuda.synchronize()
        counts = dict(_build.launches)
        if not launches:
            launches = counts
        check(counts == LAUNCHES_SHARDED, "main path sharded 3-D %s: "
              "launches %s" % (label, counts))
        lv = leaves(pyr)
        shapes_ok = (tuple(rec.shape) == (1,) + (VOL,) * 3
                     and rec.dtype == dtype and len(lv) == 1 + NLEVELS * (
                         1 if layout == "interleaved" else 2)
                     and tuple(pyr.lowpass.shape) == (1,) + (VOL // 4,) * 3)
        finite = all(bool(torch.isfinite(torch.view_as_real(h) if
                                         h.is_complex() else h.float()).all())
                     for h in lv + [rec])
        err = float((rec.float() - x.float()).abs().max())
        check(shapes_ok and finite and err <= REC_TOL_3D[dtype],
              "main path sharded 3-D %s: %d^3 %d-level round trip on the "
              "(1, %d) card mesh, reconstruction max abs err %.3g (tol %g), "
              "shapes %s, finite %s" % (label, VOL, NLEVELS, SHARDS, err,
                                        REC_TOL_3D[dtype], shapes_ok, finite))
        p3 = t3.forward(x, NLEVELS, layout=layout)
        e = max([rel_err(a, b) for a, b in zip(lv, leaves(p3))]
                + [rel_err(rec, t3.inverse(p3))])
        check(e <= TOL[dtype], "main path sharded 3-D %s: against "
              "Transform3d on the card, every leaf and the reconstruction, "
              "rel err %.3g (tol %g)" % (label, e, TOL[dtype]))
        del p3
        with patched(sharded_plain_path()):
            pp = st.forward(x, NLEVELS, layout=layout)
            rec_plain = st.inverse(pp)
        e = max([rel_err(a, b) for a, b in zip(lv, leaves(pp))]
                + [rel_err(rec, rec_plain)])
        check(e <= TOL[dtype] * 10, "main path sharded 3-D %s: kernels vs "
              "plain path on the card, every leaf and the reconstruction, rel"
              " err %.3g (tol %g)" % (label, e, TOL[dtype] * 10))
        del pyr, rec, pp, rec_plain
    del x32

    # levels 2-3 gathered: JAX's transform3d_dist.py:557 route
    xg = rand((1, 32, VOL, VOL), 32, dev, torch.float32)
    _build.reset_launches()
    with patched(sharded_no_plain()):
        pg = st.forward(xg, NLEVELS)
        rg = st.inverse(pg)
        torch.cuda.synchronize()
    counts = dict(_build.launches)
    p3 = t3.forward(xg, NLEVELS)
    e = max(rel_err(a, b) for a, b in zip(leaves(pg), leaves(p3)))
    rec_e = float((rg - xg).abs().max())
    check(counts == LAUNCHES_DEGRADE and e <= TOL[torch.float32]
          and rec_e <= REC_TOL_3D[torch.float32],
          "sharded 3-D 1x32x%dx%d (levels 2-3 gathered): launches %s, "
          "against Transform3d rel err %.3g, reconstruction max abs err %.3g"
          % (VOL, VOL, counts, e, rec_e))
    del xg, pg, rg, p3
    # a (1, 2, 2) rows mesh: each axis alone on the dual kernels
    mr = make_mesh((1, 2, 2), ("data", "depth", "rows"), ["cuda"] * 4)
    sr = ShardedTransform3d(mr, rows_axis="rows")
    xr = rand((1,) + (VOL // 2,) * 3, 33, dev, torch.float32)
    _build.reset_launches()
    with patched(sharded_no_plain()):
        pr = sr.forward(xr, NLEVELS)
        rr = sr.inverse(pr)
        torch.cuda.synchronize()
    counts = dict(_build.launches)
    p3 = t3.forward(xr, NLEVELS)
    e = max(rel_err(a, b) for a, b in zip(leaves(pr), leaves(p3)))
    rec_e = float((rr - xr).abs().max())
    check(e <= TOL[torch.float32] and rec_e <= REC_TOL_3D[torch.float32]
          and set(counts) == set(DUAL_NAMES),
          "sharded 3-D %d^3 on the (1, 2, 2) rows mesh: launches %s, against"
          " Transform3d rel err %.3g, reconstruction max abs err %.3g" % (
              VOL // 2, counts, e, rec_e))
    del xr, pr, rr, p3
    # float64: card mesh against CPU mesh, every leaf, both layouts
    v = np.random.RandomState(34).rand(2, 32, 32, 16)
    e = 0.0
    for shape, names, rows in (((2, 2), ("data", "depth"), None),
                               ((1, 2, 2), ("data", "depth", "rows"),
                                "rows")):
        n = int(np.prod(shape))
        sg = ShardedTransform3d(make_mesh(shape, names, ["cuda"] * n),
                                rows_axis=rows)
        sc = ShardedTransform3d(make_mesh(shape, names, ["cpu"] * n),
                                rows_axis=rows)
        for layout in ("interleaved", "planes"):
            pg = sg.forward(v, NLEVELS, layout=layout, include_scale=True)
            pc = sc.forward(torch.from_numpy(v), NLEVELS, layout=layout,
                            include_scale=True)
            e = max([e, rel_err(sg.inverse(pg).cpu(), sc.inverse(pc))]
                    + [rel_err(a.cpu(), b) for a, b in zip(leaves(pg),
                                                            leaves(pc))])
    check(e <= TOL[torch.float64], "sharded 3-D float64 2x32x32x16 on (2, 2)"
          " and (1, 2, 2) card meshes, both layouts: card vs CPU, every leaf,"
          " rel err %.3g (tol %g)" % (e, TOL[torch.float64]))
    return launches


def time_sharded(dev, report) -> None:
    """Phase 5 for the sharded path: the round trip on the card mesh against
    Transform3d and the plain path in three layouts with a profiler trace
    (f32 interleaved), and each hw kernel alone (device time, stream held)
    against its plain version, its bound and one einsum over the dense
    operators; per round trip, one launch per shard at each of its
    shapes."""
    import dtcwt_tpu_torch as dt
    from dtcwt_tpu_torch.parallel import ShardedTransform3d, make_mesh
    mesh = make_mesh((1, SHARDS), ("data", "depth"), ["cuda"] * SHARDS)
    st, t3 = ShardedTransform3d(mesh), dt.Transform3d()
    x = rand((1,) + (VOL,) * 3, 31, dev, torch.float32)
    for label, dtype, layout in LAYOUTS:
        xd = x.to(dtype)
        run = lambda: st.inverse(st.forward(xd, NLEVELS, layout=layout))
        ms = cuda_ms(run)
        single_ms = cuda_ms(lambda: t3.inverse(t3.forward(
            xd, NLEVELS, layout=layout)))
        with patched(sharded_plain_path()):
            pms = cuda_ms(run, reps=3, warmup=1)
        print("time round trip sharded 3-D %d^3 %d levels on the (1, %d) "
              "card mesh %s: kernels %.3f ms, Transform3d %.3f ms, plain "
              "%.3f ms" % (VOL, NLEVELS, SHARDS, label, ms, single_ms, pms),
              flush=True)
        if dtype == torch.float32 and layout == "interleaved":
            print_trace("round trip sharded 3-D %s" % label, run)
    del x
    for name in HW_NAMES:
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "bound_by": "bytes", "library_ms": 0.0}
        for shape in HW_SHAPES[name]:
            kern, plain, xs = hw_case(name, shape, torch.float32, dev)
            outs = kern()
            bms, by = bound(SHARDS * (nbytes(xs) + nbytes(outs)),
                            SHARDS * hw_macs(name, shape))
            shards = lambda fn: (lambda: [fn() for _ in range(SHARDS)])
            ms = cuda_ms(shards(kern), hold=True)
            pms = cuda_ms(shards(plain), hold=True, reps=3, warmup=1)
            lib, as_outs = hw_einsum(name, xs)
            lms = cuda_ms(shards(lib), hold=True)
            lerr = rel_err(as_outs(lib()), outs)
            for k, v in (("ms", ms), ("plain_ms", pms), ("bound_ms", bms),
                         ("library_ms", lms)):
                tot[k] += v
            if by != "bytes":
                tot["bound_by"] = by
            print("time %s %s x %d shards f32: kernel %.4f ms, plain %.4f ms,"
                  " bound %.4f ms (%s), library einsum (TF32 off) %.4f ms "
                  "(rel err against the kernel %.3g)" % (
                      name, "x".join(map(str, shape)), SHARDS, ms, pms, bms,
                      by, lms, lerr), flush=True)
            del outs, xs, lib
        print("time %s, its %d launches of one sharded round trip: kernel "
              "%.4f ms, plain %.4f ms, bound %.4f ms, einsum %.4f ms" % (
                  name, SHARDS * len(HW_SHAPES[name]), tot["ms"],
                  tot["plain_ms"], tot["bound_ms"], tot["library_ms"]),
              flush=True)
        report[name].update(tot)


# --- gradients: the transforms' backward (ops/linearize, ops/adjoint) ------

GRAD_TOL = 2e-5     # float32 against the plain path's autograd (adjoint rung)
# the explicit backward's launches in one 3-level round trip: the forward's
# adjoint (the gradient of the input) and the inverse's (of the pyramid)
LAUNCHES_GRAD = {
    ("2-D", "forward"): {"ilevel2": 2, "filter2_sum": 3},
    ("2-D", "inverse"): {"filter2": 3, "level2": 2},
    ("3-D", "forward"): {"inv_level2_pack": 2, "ifilt2_sum": 2,
                         "filter2_sum": 7},
    ("3-D", "inverse"): {"filter2": 7, "fwd_level2_pack": 2, "dfilt2": 2}}
_DUAL_ENTRIES = ("filter2_axis", "dfilt2_axis", "filter2_sum_axis",
                 "ifilt2_sum_axis", "filter2_fromext_axis",
                 "filter2_sum_fromext_axis")


def grad_paths(dev):
    """(label, kind, transform, input, layout, entries) of each gradient
    round trip at full width: 2-D 4096^2 in both float32 layouts, 3-D
    256^3 interleaved and 1-D [131072, 128] (the plain route); *entries*
    are the (module, name) of the level entries its chain calls."""
    import dtcwt_tpu_torch as dt
    from dtcwt_tpu_torch.ops import dual, ilevel1, ilevel2, level1, level2
    from dtcwt_tpu_torch.ops import pack3d
    l2d = ((level1, "fwd_level1"), (level2, "fwd_level2"),
           (ilevel2, "inv_level2"), (ilevel1, "inv_level1"))
    l3d = tuple((pack3d, n) for n in PACK_NAMES)
    l1d = tuple((dual, n) for n in _DUAL_ENTRIES[:4])
    x2 = rand((N, N), 30, dev, torch.float32)
    return [("2-D %dx%d %d levels f32 %s" % (N, N, NLEVELS, lay), "2-D",
             dt.Transform2d(), x2, lay, l2d)
            for lay in ("interleaved", "planes")] + [
        ("3-D %d^3 %d levels f32 interleaved" % (VOL, NLEVELS), "3-D",
         dt.Transform3d(), rand((VOL,) * 3, 31, dev, torch.float32),
         "interleaved", l3d),
        ("1-D [%d, %d] %d levels f32 interleaved" % (N1, C1, NLEVELS1),
         "1-D", dt.Transform1d(), rand((N1, C1), 32, dev, torch.float32),
         "interleaved", l1d)]


def grad_no_plain(entries):
    """Patches that make the plain versions of *entries* and of the dual
    entries (the level-1 adjoints' kernels) raise."""
    from dtcwt_tpu_torch.ops import dual
    pairs = set(entries) | {(dual, n) for n in _DUAL_ENTRIES}
    return [(m, n + "_reference", refuse) for m, n in pairs]


def grad_plain_path(entries):
    """Patches for the plain path's autograd on the card: *entries* routed
    to their plain versions, and the transforms kept off linear_vjp."""
    from dtcwt_tpu_torch.ops import linearize
    return [(m, n, getattr(m, n + "_reference")) for m, n in entries] + [
        (linearize, "needs_vjp", lambda _: False)]


def cot_like(a, seed):
    """A random output gradient of *a*'s shape, dtype and device."""
    g = torch.Generator(device=a.device).manual_seed(seed)
    return torch.randn(a.shape, generator=g, dtype=a.dtype, device=a.device)


def grads(tr, x, layout, nl, seed):
    """(input gradient of the forward, pyramid gradients of the inverse,
    the launch counts of each backward) of an *nl*-level round trip's two
    directions on random output gradients."""
    from dtcwt_tpu_torch.ops import _build, linearize
    xg = x.detach().requires_grad_()
    p = tr.forward(xg, nl, layout=layout)
    leaves, spec = linearize._tree(p)
    cots = [cot_like(a, seed + i) for i, a in enumerate(leaves)]
    torch.cuda.synchronize()
    _build.reset_launches()
    (gx,) = torch.autograd.grad(leaves, xg, cots)
    torch.cuda.synchronize()
    fwd_counts = dict(_build.launches)
    pl = [a.detach().requires_grad_() for a in leaves]
    z = tr.inverse(linearize._fill(spec, pl))
    v = cot_like(z, seed + 100)
    torch.cuda.synchronize()
    _build.reset_launches()
    gp = torch.autograd.grad(z, pl, v)
    torch.cuda.synchronize()
    return gx, gp, fwd_counts, dict(_build.launches)


def check_grad(dev) -> None:
    """Phase 4 for the gradients: each round trip's forward and inverse
    gradients on the card (the explicit adjoints, with every plain version
    patched to raise; 1-D: the plain route) against the plain path's
    autograd on the card, with the backward's launch counts."""
    for label, kind, tr, x, layout, entries in grad_paths(dev):
        nl = NLEVELS1 if kind == "1-D" else NLEVELS
        if kind == "1-D":
            gx, gp, cf, ci = grads(tr, x, layout, nl, 40)
        else:
            with patched(grad_no_plain(entries)):
                gx, gp, cf, ci = grads(tr, x, layout, nl, 40)
            for way, counts in (("forward", cf), ("inverse", ci)):
                check(counts == LAUNCHES_GRAD[(kind, way)],
                      "grad %s: the %s's backward launches %s (want %s)" % (
                          label, way, counts, LAUNCHES_GRAD[(kind, way)]))
        with patched(grad_plain_path(entries)):
            rx, rp, _, _ = grads(tr, x, layout, nl, 40)
        e = max([rel_err(gx, rx)] + [rel_err(a, b) for a, b in zip(gp, rp)])
        finite = all(bool(torch.isfinite(torch.view_as_real(g) if
                                         g.is_complex() else g).all())
                     for g in (gx,) + tuple(gp))
        check(e <= GRAD_TOL and finite and len(gp) == len(rp),
              "grad %s: forward and inverse gradients (%d pyramid leaves) "
              "against the plain path's autograd on the card: rel err %.3g "
              "(tol %g), finite %s" % (label, len(gp), e, GRAD_TOL, finite))
        del gx, gp, rx, rp


def launch_bytes(fn) -> tuple:
    """(bytes, launches) of the kernel launches of one call of *fn*: each
    launch's input tensors read once and its outputs written once,
    recorded at the launch sites (the stream kernels, the 3-D level
    kernels, the 2-D qshift level kernels)."""
    from dtcwt_tpu_torch.ops import dual, ilevel2, level2, pack3d
    seen = []

    def flat(obj):
        if isinstance(obj, torch.Tensor):
            return [obj]
        if isinstance(obj, dict):
            obj = list(obj.values())
        if isinstance(obj, (tuple, list)):
            return [t for o in obj for t in flat(o)]
        return []

    def rec(f):
        def run(*a, **k):
            out = f(*a, **k)
            seen.append(nbytes(flat(a) + flat(k)) + nbytes(flat(out)))
            return out
        return run
    sites = [(dual, "_launch_stream"), (pack3d, "_launch"),
             (level2, "fwd_level2"), (ilevel2, "inv_level2")]
    with patched([(m, n, rec(getattr(m, n))) for m, n in sites]):
        fn()
        torch.cuda.synchronize()
    return sum(seen), len(seen)


def print_op_trace(what, fn) -> None:
    """A torch.profiler trace of *fn*: wall and device time, and the device
    time by kernel and by aten operator (the glue's share)."""
    from torch.profiler import ProfilerActivity, profile
    wall, enqueue, device = trace(fn)
    busy = sum(device.values())
    if not busy:
        print("trace %s: wall %.3f ms, host enqueue %.3f ms; device time "
              "not measured (the profiler saw no device activity)"
              % (what, wall, enqueue), flush=True)
        return
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    ops = collections.Counter()
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.key.startswith("aten::")):
            ops[e.key] += e.self_device_time_total / 1e3 / 5
    short = lambda k: k.replace("(anonymous namespace)::", "").split("(")[
        0][:48]
    print("trace %s: wall %.3f ms, device %.3f ms (idle %.1f%%), host "
          "enqueue %.3f ms; device time by kernel: %s; by aten operator "
          "(the rest is the ctypes kernels): %s" % (
              what, wall, busy, 100 * (1 - busy / wall), enqueue,
              ", ".join("%s %.4f ms" % (short(k), v)
                        for k, v in device.most_common(10)),
              ", ".join("%s %.4f ms" % (k, v) for k, v in ops.most_common(8)
                        if v > 0)), flush=True)


def time_grad(dev) -> None:
    """Phase 5 for the gradients: each round trip's primal (grad mode off),
    its backward alone (both directions' adjoints, the graph kept), the
    backward/primal ratio, the plain route's backward (explicit adjoints
    declined) and the byte bound of the backward's launches; a trace of
    the 2-D backward by kernel and by operator."""
    from dtcwt_tpu_torch.ops import adjoint
    for label, kind, tr, x, layout, _ in grad_paths(dev):
        nl = NLEVELS1 if kind == "1-D" else NLEVELS
        with torch.no_grad():
            pms = cuda_ms(lambda: tr.inverse(tr.forward(x, nl,
                                                        layout=layout)))
        routes = [("explicit", [])] if kind != "1-D" else []
        routes.append(("plain route", [(adjoint, "explicit_route",
                                        lambda *a: False)]))
        out = []
        for route, patch in routes:
            with patched(patch):
                xg = x.detach().requires_grad_()
                y = tr.inverse(tr.forward(xg, nl, layout=layout))
            v = cot_like(y, 50)
            bwd = lambda: torch.autograd.grad(y, xg, v, retain_graph=True)
            ms = cuda_ms(bwd)
            line = "%s backward %.3f ms (%.2fx the primal" % (route, ms,
                                                              ms / pms)
            if route == "explicit":
                nb, nlaunch = launch_bytes(bwd)
                line += "; its %d launches' byte bound %.3f ms" % (
                    nlaunch, 1e3 * nb / HBM_BYTES_PER_S)
            out.append(line + ")")
            if kind == "2-D" and route == "explicit":
                print_op_trace("grad backward %s" % label, bwd)
            del y, xg, v
        print("time grad %s round trip: primal %.3f ms; %s" % (
            label, pms, "; ".join(out)), flush=True)


def main() -> int:
    # --- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    import dtcwt_tpu_torch as dt
    from dtcwt_tpu_torch.ops import _build, dual, fb
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print("device: %s, torch %s, CUDA %s, %d card(s)" % (
        kind, torch.__version__, torch.version.cuda,
        torch.cuda.device_count()))
    print("nvidia-smi: " + smi, flush=True)

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print("build: %.1f s (one nvcc per dtcwt_tpu_torch/csrc/*.cu, in "
          "parallel, then a link; sm_90a)"
          % (time.perf_counter() - t0), flush=True)

    t = dt.Transform2d()
    b, q = t.biort, t.qshift

    # the 1-D main path's filters, in the transform's call order
    t1 = dt.Transform1d()
    h0o, g0o, h1o, g1o = t1.biort
    h0a, h0b, g0a, g0b, h1a, h1b, g1a, g1b = t1.qshift
    dual_filters = {"filter2": (h0o, h1o), "dfilt2": ((h0b, h0a), (h1b, h1a)),
                    "ifilt2_sum": ((g0b, g0a), (g1b, g1a)),
                    "filter2_sum": (g0o, g1o)}
    n_inputs = {"filter2": 1, "dfilt2": 1, "ifilt2_sum": 2, "filter2_sum": 2}

    def dual_call(name, ins, f=None, side=None, axis=0):
        """(kernel wrapper, plain version) of dual kernel *name* on *ins*
        with filters *f* (default: the main path's), in the axis mode or,
        with *side*, the from-extension mode."""
        f = dual_filters[name] if f is None else f
        if side is None:
            k = getattr(dual, name + "_axis")
            p = getattr(dual, name + "_axis_reference")
            return (lambda: k(*ins, *f, axis)), (lambda: p(*ins, *f, axis))
        k = getattr(dual, name + "_fromext_axis")
        p = getattr(dual, name + "_fromext_axis_reference")
        return ((lambda: k(*ins, side, *f, axis)),
                (lambda: p(*ins, side, *f, axis)))

    def macs_dual(name, outs, f=None):
        f = dual_filters[name] if f is None else f
        m = [np.asarray(h[0] if isinstance(h, tuple) else h).size for h in f]
        if name in ("filter2", "dfilt2"):
            return outs[0].numel() * m[0] + outs[1].numel() * m[1]
        per = (m[0] + m[1]) // (2 if name == "ifilt2_sum" else 1)
        return outs.numel() * per

    def dual_inputs(name, rows, dtype, seed=0, cols=C1):
        return [rand((rows, cols), seed + i, dev, dtype)
                for i in range(n_inputs[name])]

    # --- 3. kernels against their plain versions ---------------------------
    main_shapes = MAIN_SHAPES_2D
    report = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                  "bound_ms": 0.0, "bound_by": "bytes", "library_ms": None}
              for k in KERNELS}
    for name, shapes in main_shapes.items():
        for shape in shapes:
            for label, dtype, layout in LAYOUTS:
                pl = layout == "planes"
                kern, plain = level_call(
                    name, level_inputs(name, shape, dtype, pl, dev), pl, b,
                    q)
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                err = rel_err(got, want)
                if dtype == torch.float32 and not pl:
                    report[name]["max_abs_err"] = max(
                        report[name]["max_abs_err"], abs_err(got, want))
                check(err <= TOL[dtype], "kernel %s %s %s: rel err %.3g "
                      "(tol %g)" % (name, "x".join(map(str, shape)), label,
                                    err, TOL[dtype]))
                del got, want
    check_offsets("level2", dev, b, q)
    check_offsets("ilevel2", dev, b, q)
    check_offsets("ilevel1", dev, b, q)
    small = {"level1": [(2, 36, 52), (2, 4, 6)],
             "level2": LEVEL2_SHAPES,
             "ilevel2": ILEVEL2_SHAPES,
             "ilevel1": ILEVEL1_SHAPES}
    for name, shapes in small.items():
        # every family, the bandpass ones with their third stream
        biorts = name in ("level1", "ilevel1")
        fams = BIORTS + BP_FAMS[:1] if biorts else QSHIFTS + BP_FAMS[1:]
        worst = 0.0
        for fam in fams:
            bb = dt.biort(fam) if biorts else b
            qq = q if biorts else dt.qshift(fam)
            for shape in shapes:
                for pl in (False, True):
                    x = level_inputs(name, shape, torch.float64, pl, dev)
                    kern, plain = level_call(name, x, pl, bb, qq)
                    got = kern()
                    torch.cuda.synchronize()
                    worst = max(worst, rel_err(got, plain()))
        check(worst <= TOL[torch.float64],
              "kernel %s float64, families %s, shapes %s, both layouts: "
              "worst rel err %.3g (tol %g)" % (name, ",".join(fams), small[
                  name], worst, TOL[torch.float64]))

    # the dual-stream kernels: rows along axis 0 of [rows, 128] at every
    # call of the 1-D main path, float32 and bfloat16
    main_rows = {"filter2": [N1],
                 "dfilt2": [N1 >> k for k in range(NLEVELS1 - 1)],
                 "ifilt2_sum": [(N1 >> (NLEVELS1 - 1)) << k
                                for k in range(NLEVELS1 - 1)],
                 "filter2_sum": [N1]}
    vec_rows = {name: [r * (NVEC // N1) for r in rows]
                for name, rows in main_rows.items()}
    for name, rows_list in main_rows.items():
        for dtype in (torch.float32, torch.bfloat16):
            worst = 0.0
            for rows in rows_list:
                kern, plain = dual_call(name, dual_inputs(name, rows, dtype))
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                worst = max(worst, rel_err(got, want))
                if dtype == torch.float32:
                    report[name]["max_abs_err"] = max(
                        report[name]["max_abs_err"], abs_err(got, want))
                del got, want
            check(worst <= TOL[dtype], "kernel %s [rows, %d] rows %s %s: "
                  "worst rel err %.3g (tol %g)" % (
                      name, C1, rows_list, dtype, worst, TOL[dtype]))
    # float64 at small shapes: every non-bandpass family, axes -1/-2/-3,
    # signals shorter than the filter, one signal (inner = 1), both modes
    dual_small = [((8, 20, 36), (-1, -2, -3)), ((4, 8, 4), (-1, -2, -3)),
                  ((1028, 1), (0,)), ((12, 130), (0,))]
    side = 32       # covers qshift_32's 32-tap decimator
    for name in main_rows:
        fams = BIORTS if name in ("filter2", "filter2_sum") else QSHIFTS
        worst = 0.0
        for fam in fams:
            if fam in BIORTS:
                bb = dt.biort(fam)
                f = (bb[0], bb[2]) if name == "filter2" else (bb[1], bb[3])
            else:
                qq = dt.qshift(fam)
                f = (((qq[1], qq[0]), (qq[5], qq[4])) if name == "dfilt2"
                     else ((qq[3], qq[2]), (qq[7], qq[6])))
            for seed, (shape, axes) in enumerate(dual_small):
                xs = [rand(shape, seed + i, dev, torch.float64)
                      for i in range(n_inputs[name])]
                for axis in axes:
                    for s in (None, side):
                        ins = xs if s is None else [
                            fb.symmetric_extend(x, s, axis).contiguous()
                            for x in xs]
                        kern, plain = dual_call(name, ins, f, s, axis)
                        got = kern()
                        torch.cuda.synchronize()
                        worst = max(worst, rel_err(got, plain()))
        check(worst <= TOL[torch.float64],
              "kernel %s float64, families %s, shapes %s on every axis, "
              "axis and from-extension modes: worst rel err %.3g (tol %g)"
              % (name, ",".join(fams), [s for s, _ in dual_small], worst,
                 TOL[torch.float64]))

    # --- 4. main paths -------------------------------------------------------
    x32 = torch.from_numpy(np.random.RandomState(0).rand(N, N).astype(
        np.float32)).to(dev)

    no_plain, plain_path = level_no_plain(), level_plain_path()
    launches = {}
    for label, dtype, layout in LAYOUTS:
        x = x32.to(dtype)
        _build.reset_launches()
        with patched(no_plain):
            pyr = t.forward(x, nlevels=NLEVELS, layout=layout)
            rec = t.inverse(pyr)
            torch.cuda.synchronize()
        counts = dict(_build.launches)
        if not launches:
            launches = counts
        check(counts == LAUNCHES_2D,
              "main path 2-D %s: launches %s" % (label, counts))
        hp = pyr.highpasses if layout == "interleaved" else pyr.highpasses_re
        shapes_ok = (tuple(rec.shape) == (N, N) and rec.dtype == dtype
                     and tuple(pyr.lowpass.shape) == (N // 4, N // 4)
                     and len(hp) == NLEVELS)
        finite = bool(torch.isfinite(rec.float()).all()) and all(
            bool(torch.isfinite(torch.view_as_real(h) if h.is_complex()
                                else h.float()).all()) for h in hp)
        err = float((rec.float() - x.float()).abs().max())
        check(shapes_ok and finite and err <= REC_TOL[dtype],
              "main path 2-D %s: 4096x4096 %d-level round trip, "
              "reconstruction max abs err %.3g (tol %g), shapes %s, finite %s"
              % (label, NLEVELS, err, REC_TOL[dtype], shapes_ok, finite))
        with patched(plain_path):
            rec_plain = t.inverse(t.forward(x, nlevels=NLEVELS,
                                            layout=layout))
        e = rel_err(rec, rec_plain)
        check(e <= TOL[dtype] * 10, "main path 2-D %s: kernel vs plain path "
              "on the card, reconstruction rel err %.3g (tol %g)" % (
                  label, e, TOL[dtype] * 10))
        del pyr, rec, rec_plain

    xb = rand((4, 1000, 1500), 3, dev, torch.float32)
    pk = t.forward(xb, nlevels=NLEVELS)
    rk = t.inverse(pk)
    with patched(plain_path):
        pp = t.forward(xb, nlevels=NLEVELS)
        rp = t.inverse(pp)
    e = max([rel_err(pk.lowpass, pp.lowpass), rel_err(rk, rp)]
            + [rel_err(a, c) for a, c in zip(pk.highpasses, pp.highpasses)])
    rec_e = float((rk - xb).abs().max())
    check(e <= TOL[torch.float32] and rec_e <= REC_TOL[torch.float32],
          "batch 4x1000x1500 (pad + crop): kernel vs plain rel err %.3g, "
          "reconstruction max abs err %.3g" % (e, rec_e))
    del xb, pk, rk, pp, rp, x32
    check_bandpass(dev)

    dual_names = ("filter2", "dfilt2", "ifilt2_sum", "filter2_sum")
    no_plain_1d = [(dual, n + "_axis_reference", refuse) for n in dual_names]
    plain_path_1d = [(dual, n + "_axis", getattr(dual, n + "_axis_reference"))
                     for n in dual_names]
    x1 = torch.from_numpy(np.random.RandomState(1).rand(N1, C1).astype(
        np.float32)).to(dev)
    xv = torch.from_numpy(np.random.RandomState(2).rand(NVEC).astype(
        np.float32)).to(dev)
    launches_1d = {}
    runs_1d = [(label, x1.to(dtype), layout) for label, dtype, layout in
               LAYOUTS] + [("f32 interleaved, one %d-sample vector" % NVEC,
                            xv, "interleaved")]
    for label, x, layout in runs_1d:
        dtype = x.dtype
        _build.reset_launches()
        with patched(no_plain_1d):
            pyr = t1.forward(x, nlevels=NLEVELS1, layout=layout)
            rec = t1.inverse(pyr)
            torch.cuda.synchronize()
        counts = dict(_build.launches)
        if not launches_1d:
            launches_1d = counts
        check(counts == LAUNCHES_1D,
              "main path 1-D %s: launches %s" % (label, counts))
        hp = pyr.highpasses if layout == "interleaved" else pyr.highpasses_re
        rows = x.shape[0] >> (NLEVELS1 - 1)
        shapes_ok = (rec.shape == x.shape and rec.dtype == dtype
                     and pyr.lowpass.shape[0] == rows
                     and len(hp) == NLEVELS1)
        finite = bool(torch.isfinite(rec.float()).all()) and all(
            bool(torch.isfinite(torch.view_as_real(h) if h.is_complex()
                                else h.float()).all()) for h in hp)
        err = float((rec.float() - x.float()).abs().max())
        check(shapes_ok and finite and err <= REC_TOL[dtype],
              "main path 1-D %s: %s %d-level round trip, reconstruction max "
              "abs err %.3g (tol %g), shapes %s, finite %s" % (
                  label, "x".join(map(str, x.shape)), NLEVELS1, err,
                  REC_TOL[dtype], shapes_ok, finite))
        with patched(plain_path_1d):
            rec_plain = t1.inverse(t1.forward(x, nlevels=NLEVELS1,
                                              layout=layout))
        e = rel_err(rec, rec_plain)
        check(e <= TOL[dtype] * 10, "main path 1-D %s: kernel vs plain path "
              "on the card, reconstruction rel err %.3g (tol %g)" % (
                  label, e, TOL[dtype] * 10))
        del pyr, rec, rec_plain

    xs = np.random.RandomState(4).rand(202, 19)
    tc = dt.Transform1d("near_sym_b", "qshift_d", device="cpu")
    tg = dt.Transform1d("near_sym_b", "qshift_d")
    pg = tg.forward(xs, 4, include_scale=True)
    pc = tc.forward(xs, 4, include_scale=True)
    e = max([rel_err(pg.lowpass.cpu(), pc.lowpass),
             rel_err(tg.inverse(pg).cpu(), tc.inverse(pc))]
            + [rel_err(a.cpu(), c) for a, c in zip(pg.highpasses + pg.scales,
                                                   pc.highpasses + pc.scales)])
    check(e <= TOL[torch.float64], "1-D float64 202x19, near_sym_b/qshift_d, "
          "4 levels (pads and crops): card vs CPU, every leaf, rel err %.3g "
          "(tol %g)" % (e, TOL[torch.float64]))

    launches_3d = check_3d(dev, report)
    launches_discard, launches_low = check_single(dev, report)
    launches_sharded = check_sharded(dev, report)
    check_grad(dev)

    # --- 5. timing -----------------------------------------------------------
    print("timing on %s: CUDA events, median of 10 runs after 2 warm-up runs"
          % smi, flush=True)
    x = torch.from_numpy(np.random.RandomState(0).rand(N, N).astype(
        np.float32)).to(dev)
    for label, dtype, layout in LAYOUTS:
        xd = x.to(dtype)
        ms = cuda_ms(lambda: t.inverse(t.forward(xd, NLEVELS, layout=layout)))
        with patched(plain_path):
            pms = cuda_ms(lambda: t.inverse(t.forward(xd, NLEVELS,
                                                      layout=layout)))
        print("time round trip 2-D 4096x4096 %d levels %s: kernels %.3f ms, "
              "plain %.3f ms" % (NLEVELS, label, ms, pms), flush=True)
        if layout == "interleaved":
            print_trace("round trip 2-D %s" % label, lambda: t.inverse(
                t.forward(xd, NLEVELS)))
            print_host_split("round trip 2-D %s" % label, lambda: t.inverse(
                t.forward(xd, NLEVELS)))
    del x, xd
    for name, shapes in main_shapes.items():
        for shape in shapes:
            for label, dtype, layout in LAYOUTS:
                pl = layout == "planes"
                inp = level_inputs(name, shape, dtype, pl, dev)
                kern, plain = level_call(name, inp, pl, b, q)
                ms = cuda_ms(kern, hold=True)
                pms = cuda_ms(plain, hold=True)
                bms, by = bound(nbytes(inp) + nbytes(kern()),
                                level_macs(name, inp, b, q))
                if dtype == torch.float32 and not pl:
                    report[name]["ms"] += ms
                    report[name]["plain_ms"] += pms
                    report[name]["bound_ms"] += bms
                    if by != "bytes":
                        report[name]["bound_by"] = by
                print("time %s %s %s: kernel %.4f ms, plain %.4f ms, bound "
                      "%.4f ms (%s), %.1f%% of the bound" % (
                          name, "x".join(map(str, shape)), label, ms, pms,
                          bms, by, 100 * bms / ms), flush=True)
                del inp, kern, plain

    time_ilevel1_families(dev, q)

    for label, x, layout in runs_1d:
        ms = cuda_ms(lambda: t1.inverse(t1.forward(x, NLEVELS1,
                                                   layout=layout)))
        with patched(plain_path_1d):
            pms = cuda_ms(lambda: t1.inverse(t1.forward(x, NLEVELS1,
                                                        layout=layout)))
        print("time round trip 1-D %s %d levels %s: kernels %.3f ms, plain "
              "%.3f ms" % ("x".join(map(str, x.shape)), NLEVELS1, label, ms,
                           pms), flush=True)
        if layout == "interleaved":
            print_trace("round trip 1-D %s" % label, lambda: t1.inverse(
                t1.forward(x, NLEVELS1)))
    del x1, xv, runs_1d
    for shapes, cols, what in ((main_rows, C1, "main"),
                               (vec_rows, 1, "one signal, inner = 1")):
        for name, rows_list in shapes.items():
            tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bound_by": "bytes"}
            for rows in rows_list:
                ins = dual_inputs(name, rows, torch.float32, cols=cols)
                kern, plain = dual_call(name, ins)
                outs = kern()
                bms, by = bound(nbytes(ins) + nbytes(outs),
                                macs_dual(name, outs))
                ms = cuda_ms(kern, hold=True)
                pms = cuda_ms(plain, hold=True)
                for k, v in (("ms", ms), ("plain_ms", pms),
                             ("bound_ms", bms)):
                    tot[k] += v
                if by != "bytes":
                    tot["bound_by"] = by
                print("time %s [%d, %d] f32: kernel %.4f ms, plain %.4f ms, "
                      "bound %.4f ms (%s)" % (name, rows, cols, ms, pms, bms,
                                              by), flush=True)
                del ins, outs, kern, plain
            print("time %s, %s, its %d launch(es) of one round trip: kernel "
                  "%.4f ms, plain %.4f ms, bound %.4f ms" % (
                      name, what, len(rows_list), tot["ms"], tot["plain_ms"],
                      tot["bound_ms"]), flush=True)
            if what == "main":
                report[name].update(tot)

    # one PyTorch call computing filter2 / filter2_sum: a convolution over
    # the pre-extended input viewed as [1, channels, rows + 2p, 128]
    for name in ("filter2", "filter2_sum"):
        f = dual_filters[name]
        p = max(np.asarray(h).size for h in f) // 2
        w = torch.zeros((2, 2 * p + 1), dtype=torch.float64)
        for c, h in enumerate(f):
            h = np.asarray(h, np.float64)
            off = p - h.size // 2
            w[c, off:off + h.size] = torch.from_numpy(h[::-1].copy())
        ins = dual_inputs(name, N1, torch.float32)
        ext = torch.stack([fb.symmetric_extend(x, p, 0) for x in ins])[None]
        if name == "filter2":
            weight = w[:, None, :, None].to(dev, torch.float32)
            lib = lambda: F.conv2d(ext, weight)
            got = lib()[0]
            got = (got[0], got[1])
        else:
            weight = w[None, :, :, None].to(dev, torch.float32)
            lib = lambda: F.conv2d(ext, weight)
            got = lib()[0, 0]
        want = dual_call(name, ins)[0]()
        lms = cuda_ms(lib, hold=True)
        report[name]["library_ms"] = lms
        print("time %s library call F.conv2d [1, %d, %d, %d] (TF32 off): "
              "%.4f ms; rel err against the kernel %.3g" % (
                  name, ext.shape[1], ext.shape[2], ext.shape[3], lms,
                  rel_err(got, want)), flush=True)
        del ins, ext, got, want

    time_bandpass(dev)
    time_3d(dev, report)
    time_single(dev, report)
    time_sharded(dev, report)
    time_grad(dev)

    # the dual kernels report the 1-D path's launches, the level kernels
    # their own path's, filter the discard_level_1 round trip's, dfilt and
    # ifilt the low-level path's, the hw kernels the sharded round trip's
    counts = dict(launches_3d, **launches, **launches_1d,
                  filter=launches_discard["filter"],
                  dfilt=launches_low["dfilt"], ifilt=launches_low["ifilt"],
                  **{n: launches_sharded[n] for n in HW_NAMES})
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": counts.get(name, 0),
                **report[name]}
               for name, (src, rep) in KERNELS.items()]
    print("ms / plain_ms / bound_ms: the kernel's calls in one f32 round "
          "trip of its main path (2-D interleaved, 1-D [131072, 128], 3-D "
          "256^3 interleaved; a 3-D level kernel alone, after its depth "
          "stage; filter: the 6 passes of the 256^3 discard_level_1 round "
          "trip; dfilt, ifilt: the col and row calls of the 4096^2 "
          "low-level path; the hw kernels: one launch per shard at each "
          "shape of the 256^3 sharded round trip on the (1, 4) card mesh); "
          "max_abs_err: f32 at the main-path shapes; library_ms: one "
          "F.conv2d (hw kernels: one einsum over the dense operators) per "
          "call at the main-path shapes, where one call computes it")
    if failures:
        print("FAILED %d check(s):" % len(failures))
        for f in failures:
            print("  " + f)
        return 1
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
