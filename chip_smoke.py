"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

The main path is ``dtcwt_tpu_torch.Transform2d()`` with the default filters
(near_sym_a / qshift_a), ``forward(x, nlevels=3)`` then ``inverse``, on a
4096 x 4096 image, in three layouts: interleaved complex float32, float32
planes and bfloat16 planes.  Phases, each printing its own lines:

1. device: the card, and its name and power limit from nvidia-smi;
2. build: the four CUDA kernels from ``dtcwt_tpu_torch/csrc``, timed;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (float32 interleaved, float32 planes, bfloat16
   planes) and at small odd shapes in float64 for every non-bandpass
   family, including signals shorter than the filter;
4. main path: the round trip in all three layouts with the plain versions
   patched to raise, the launch counts (1/2/2/1 per round trip), the
   reconstruction error, agreement with the plain path on the card, and a
   4 x 1000 x 1500 batch (pad and crop) against the plain path;
5. timing: CUDA events, median of repeated runs after warm-up: each kernel
   and the round trip against their plain versions.

Tolerances, relative to the largest reference value: float32 1e-5 (sums in
another order), bfloat16 1e-2 (one bfloat16 step of the stored outputs),
float64 1e-12.  Reconstruction: float32 1e-4, bfloat16 0.04 (storage grade).

The second-to-last line is the JSON list of kernels; the last line is
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without a GPU, or outside the repository, the script fails before it.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N = 4096
NLEVELS = 3
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float64: 1e-12}
REC_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.04}
LAYOUTS = (("f32 interleaved", torch.float32, "interleaved"),
           ("f32 planes", torch.float32, "planes"),
           ("bf16 planes", torch.bfloat16, "planes"))
BIORTS = ("antonini", "legall", "near_sym_a", "near_sym_b")
QSHIFTS = ("qshift_06", "qshift_a", "qshift_b", "qshift_c", "qshift_d",
           "qshift_32")
KERNELS = {   # name -> (CUDA source, the TPU kernel it replaces)
    "level1": ("dtcwt_tpu_torch/csrc/level1.cu",
               "dtcwt_tpu/ops/pallas_level1.py:374"),
    "level2": ("dtcwt_tpu_torch/csrc/level2.cu",
               "dtcwt_tpu/ops/pallas_level2.py:438"),
    "ilevel2": ("dtcwt_tpu_torch/csrc/ilevel2.cu",
                "dtcwt_tpu/ops/pallas_ilevel2.py:455"),
    "ilevel1": ("dtcwt_tpu_torch/csrc/ilevel1.cu",
                "dtcwt_tpu/ops/pallas_ilevel1.py:434"),
}

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


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of *fn* over *reps* runs, each between two CUDA
    events, after *warmup* runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def main() -> int:
    # --- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false)")
    import dtcwt_tpu_torch as dt
    from dtcwt_tpu_torch.ops import _build, ilevel1, ilevel2, level1, level2
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
    print("build: %.1f s (nvcc over dtcwt_tpu_torch/csrc/*.cu, sm_90a)"
          % (time.perf_counter() - t0), flush=True)

    t = dt.Transform2d()
    b, q = t.biort, t.qshift
    mods = {"level1": level1, "level2": level2, "ilevel2": ilevel2,
            "ilevel1": ilevel1}
    calls = {   # the kernel's wrapper and plain version on one input set
        "level1": lambda x, pl, bb=b: (
            (lambda: level1.fwd_level1(x, bb[0], bb[2], planes=pl)),
            (lambda: level1.fwd_level1_reference(x, bb[0], bb[2],
                                                 planes=pl))),
        "level2": lambda x, pl, qq=q: (
            (lambda: level2.fwd_level2(x, qq[0], qq[1], qq[4], qq[5],
                                       planes=pl)),
            (lambda: level2.fwd_level2_reference(x, qq[0], qq[1], qq[4],
                                                 qq[5], planes=pl))),
        "ilevel2": lambda zb, pl, qq=q: (
            (lambda: ilevel2.inv_level2(zb[0], g0a=qq[2], g0b=qq[3],
                                        g1a=qq[6], g1b=qq[7], **zb[1])),
            (lambda: ilevel2.inv_level2_reference(
                zb[0], g0a=qq[2], g0b=qq[3], g1a=qq[6], g1b=qq[7],
                **zb[1]))),
        "ilevel1": lambda zb, pl, bb=b: (
            (lambda: ilevel1.inv_level1(zb[0], g0o=bb[1], g1o=bb[3],
                                        **zb[1])),
            (lambda: ilevel1.inv_level1_reference(zb[0], g0o=bb[1],
                                                  g1o=bb[3], **zb[1]))),
    }

    def inputs(name, shape, dtype, planes, seed=0):
        if name in ("level1", "level2"):
            return rand(shape, seed, dev, dtype)
        z = rand(shape, seed, dev, dtype)
        return (z, rand_bands(tuple(shape[:-2]) + (shape[-2] // 2,
                                                   shape[-1] // 2),
                              seed + 1, dev, dtype, planes))

    # --- 3. kernels against their plain versions ---------------------------
    main_shapes = {"level1": [(N, N)], "level2": [(N, N), (N // 2, N // 2)],
                   "ilevel2": [(N // 4, N // 4), (N // 2, N // 2)],
                   "ilevel1": [(N, N)]}
    report = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
              for k in KERNELS}
    for name, shapes in main_shapes.items():
        for shape in shapes:
            for label, dtype, layout in LAYOUTS:
                pl = layout == "planes"
                kern, plain = calls[name](inputs(name, shape, dtype, pl), pl)
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
    small = {"level1": [(2, 36, 52), (2, 4, 6)],
             "level2": [(2, 40, 56), (2, 8, 12)],
             "ilevel2": [(2, 20, 28), (2, 4, 6)],
             "ilevel1": [(2, 36, 52), (2, 4, 6)]}
    for name, shapes in small.items():
        fams = BIORTS if name in ("level1", "ilevel1") else QSHIFTS
        worst = 0.0
        for fam in fams:
            taps = dt.biort(fam) if fam in BIORTS else dt.qshift(fam)
            for shape in shapes:
                for pl in (False, True):
                    x = inputs(name, shape, torch.float64, pl)
                    key = "bb" if fam in BIORTS else "qq"
                    kern, plain = calls[name](x, pl, **{key: taps})
                    got = kern()
                    torch.cuda.synchronize()
                    worst = max(worst, rel_err(got, plain()))
        check(worst <= TOL[torch.float64],
              "kernel %s float64, families %s, shapes %s, both layouts: "
              "worst rel err %.3g (tol %g)" % (name, ",".join(fams), small[
                  name], worst, TOL[torch.float64]))

    # --- 4. main path ------------------------------------------------------
    x32 = torch.from_numpy(np.random.RandomState(0).rand(N, N).astype(
        np.float32)).to(dev)

    def refuse(*_a, **_k):
        raise RuntimeError("a plain version ran on the CUDA path")

    no_plain = [(mods[k], f, refuse) for k, f in (
        ("level1", "fwd_level1_reference"), ("level2", "fwd_level2_reference"),
        ("ilevel2", "inv_level2_reference"),
        ("ilevel1", "inv_level1_reference"))]
    plain_path = [(level1, "fwd_level1", level1.fwd_level1_reference),
                  (level2, "fwd_level2", level2.fwd_level2_reference),
                  (ilevel2, "inv_level2", ilevel2.inv_level2_reference),
                  (ilevel1, "inv_level1", ilevel1.inv_level1_reference)]
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
        check(counts == {"level1": 1, "level2": 2, "ilevel2": 2,
                         "ilevel1": 1},
              "main path %s: launches %s" % (label, counts))
        hp = pyr.highpasses if layout == "interleaved" else pyr.highpasses_re
        shapes_ok = (tuple(rec.shape) == (N, N) and rec.dtype == dtype
                     and tuple(pyr.lowpass.shape) == (N // 4, N // 4)
                     and len(hp) == NLEVELS)
        finite = bool(torch.isfinite(rec.float()).all()) and all(
            bool(torch.isfinite(torch.view_as_real(h) if h.is_complex()
                                else h.float()).all()) for h in hp)
        err = float((rec.float() - x.float()).abs().max())
        check(shapes_ok and finite and err <= REC_TOL[dtype],
              "main path %s: 4096x4096 %d-level round trip, reconstruction "
              "max abs err %.3g (tol %g), shapes %s, finite %s" % (
                  label, NLEVELS, err, REC_TOL[dtype], shapes_ok, finite))
        with patched(plain_path):
            rec_plain = t.inverse(t.forward(x, nlevels=NLEVELS,
                                            layout=layout))
        e = rel_err(rec, rec_plain)
        check(e <= TOL[dtype] * 10, "main path %s: kernel vs plain path on "
              "the card, reconstruction rel err %.3g (tol %g)" % (
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
    del xb, pk, rk, pp, rp

    # --- 5. timing -----------------------------------------------------------
    print("timing on %s: CUDA events, median of 10 runs after 2 warm-up runs"
          % smi, flush=True)
    for label, dtype, layout in LAYOUTS:
        x = x32.to(dtype)
        ms = cuda_ms(lambda: t.inverse(t.forward(x, NLEVELS, layout=layout)))
        with patched(plain_path):
            pms = cuda_ms(lambda: t.inverse(t.forward(x, NLEVELS,
                                                      layout=layout)))
        print("time round trip 4096x4096 %d levels %s: kernels %.3f ms, "
              "plain %.3f ms" % (NLEVELS, label, ms, pms), flush=True)
    for name, shapes in main_shapes.items():
        for shape in shapes:
            for label, dtype, layout in LAYOUTS:
                pl = layout == "planes"
                kern, plain = calls[name](inputs(name, shape, dtype, pl), pl)
                ms, pms = cuda_ms(kern), cuda_ms(plain)
                if dtype == torch.float32 and not pl:
                    report[name]["ms"] += ms
                    report[name]["plain_ms"] += pms
                print("time %s %s %s: kernel %.4f ms, plain %.4f ms" % (
                    name, "x".join(map(str, shape)), label, ms, pms),
                    flush=True)

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches.get(name, 0),
                "max_abs_err": report[name]["max_abs_err"],
                "ms": report[name]["ms"], "plain_ms": report[name]["plain_ms"]}
               for name, (src, rep) in KERNELS.items()]
    print("ms / plain_ms: the kernel's main-path calls in one f32 interleaved"
          " round trip; max_abs_err: f32 interleaved at main-path shapes")
    if failures:
        print("FAILED %d check(s):" % len(failures))
        for f in failures:
            print("  " + f)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
