"""Build, load and count the CUDA kernels; shared wrapper helpers.

The kernels are CUDA C++ for Hopper (``sm_90a``) in ``../csrc``, behind a
plain ``extern "C"`` interface that returns ``cudaGetLastError()``.  At
first use one ``nvcc`` per source, all started together, compiles them to
objects, and one more links the shared library under ``build/kernels/``
beside the package; the file name carries a hash of the sources and flags,
so edited sources rebuild.  The library is loaded with
``ctypes``, every pointer and the stream passed as ``c_void_p``.

Nothing here runs on import.  Without ``nvcc`` the build raises: a CUDA
tensor never silently takes the plain path.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Tuple

import numpy as np
import torch

from dtcwt_tpu_torch.ops import fb

__all__ = ["library", "build", "launches", "reset_launches", "count",
           "flatten_batch", "dtype_code", "stream_ptr", "check", "taps_arg",
           "ints_arg", "ptr", "check_smem_bytes",
           "odd_filters", "pair_filters", "fir_args", "check_no_grad",
           "INT_MAX", "on_cpu", "ext_len", "axis_view", "check_reach",
           "check_sizes", "TAP_BOUNDS", "within_bound"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: Longest filter the kernels take (csrc/common.cuh MAX_TAPS).
MAX_TAPS = 32
#: Dynamic shared memory one block may use on an H100 (232,448 bytes).
SMEM_LIMIT = 232448
#: The largest size or index the kernels' 32-bit ints hold.
INT_MAX = 2 ** 31 - 1

#: The longest filter, in taps, that each kernel wrapper's own kernel takes
#: (the bounds the wrappers hold: ``odd_filters`` / ``pair_filters`` of the
#: 2-D levels, MAX_TAPS of ``filter``, a stream of at most MAX_TAPS taps in
#: ``dual._table`` with ``dual._TAP_BOUNDS``, ``hw._SUM_BOUNDS`` /
#: ``_HW_BOUNDS``, ``pack3d._INV_BOUNDS``).  A dfilt stream holds a whole
#: qshift filter, an ifilt stream half of one (64); the 3-D level-2
#: synthesis centres 17 taps a stream on its halo of 8 (34).  Past its
#: bound a wrapper runs the kernels of ``csrc/longfir.cu``
#: (:mod:`longfir`).
TAP_BOUNDS = {
    "filter": 32, "filter2": 32, "filter2_sum": 32,
    "dfilt": 32, "dfilt2": 32, "ifilt": 64, "ifilt2_sum": 64,
    "fwd_level1": 31, "inv_level1": 31, "fwd_level2": 32, "inv_level2": 32,
    "filter_hw22": 31, "filter_sum_hw22": 31, "dfilt_hw22": 32,
    "ifilt_sum_hw22": 64,
    "fwd_level1_pack": 31, "inv_level1_pack": 31, "fwd_level2_pack": 32,
    "inv_level2_pack": 34,
}

_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types of each exported function (see csrc/*.cu); a null third
# tap table (t2, taps2) means no bandpass third stream
_SIGNATURES = {
    # x, lolo, out_a, out_b, B, R, C, t0, m0, t1, m1, t2, m2, dtype, planes,
    # th, mt, vlo, vpl, stream
    "dtcwt_level1": (_P,) * 4 + (_I,) * 3 + (_P, _I) * 3 + (_I,) * 6 + (
        _P,),
    # x, lolo, out_a, out_b, B, R, C, taps, offs, taps2, offs2, m, dtype,
    # planes, qh, mt, vlo, vpl, stream
    "dtcwt_level2": (_P,) * 4 + (_I,) * 3 + (_P,) * 4 + (_I,) * 7 + (_P,),
    # z, band_a, band_b, out, B, H, W, taps, offs, taps2, offs2, m2, dtype,
    # planes, qh, mt, vq, stream
    "dtcwt_ilevel2": (_P,) * 4 + (_I,) * 3 + (_P,) * 4 + (_I,) * 6 + (_P,),
    # z, band_a, band_b, out, B, H, W, t0, m0, t1, m1, t2, m2, dtype, planes,
    # th, mt, vq, vo, stream
    "dtcwt_ilevel1": (_P,) * 4 + (_I,) * 3 + (_P, _I) * 3 + (_I,) * 6 + (
        _P,),
}
# the one-branch entries of csrc/single.cu (dfilt of csrc/streamana.cuh,
# ifilt of csrc/streamsum.cuh): x, y, outer, n_in, inner, g, side, refl,
# taps, lens, offs, dtype, then the tiling (mt, path, v, vc, rows, seg, tx,
# smem), and stream
for _name in ("dfilt", "ifilt"):
    _SIGNATURES["dtcwt_" + _name] = (_P,) * 2 + (_I,) * 6 + (_P,) * 3 + (
        _I,) * 9 + (_P,)
# the analysis entries of csrc/dual.cu (csrc/streamana.cuh): x, y0, y1,
# outer, n_in, inner, g0, g1, side, refl, taps, lens, offs, dtype, then the
# tiling (mt, path, v, vc, rows, seg, tx, smem), and stream
for _name in ("filter2", "dfilt2"):
    _SIGNATURES["dtcwt_" + _name] = (_P,) * 3 + (_I,) * 7 + (_P,) * 3 + (
        _I,) * 9 + (_P,)
# the synthesis sums of csrc/dual.cu (csrc/streamsum.cuh): a, b, y, outer,
# n_in, inner, g, side, refl, taps, lens, offs, dtype, then the tiling, and
# stream
for _name in ("filter2_sum", "ifilt2_sum"):
    _SIGNATURES["dtcwt_" + _name] = (_P,) * 3 + (_I,) * 6 + (_P,) * 3 + (
        _I,) * 9 + (_P,)
# the filter kernel of csrc/filter.cu: x, y, outer, n_in, inner, g, c, refl,
# m, taps, mt, path, v, vc, rows, seg, tx, dtype, stream
_SIGNATURES["dtcwt_filter"] = (_P, _P) + (_I,) * 7 + (_P,) + (_I,) * 8 + (
    _P,)
# the 3-D level kernels of csrc/fpack.cu (analysis) and csrc/pack3d.cu
# (synthesis): in_a, in_b, bands_a, bands_b, out_a, out_b, out_c, B, Dn, H,
# W, Ho, Wo, taps, lens, offs, dtype, planes, then the tile (analysis: oh,
# ow, mt, xr, xc, smem; synthesis: oh, ow, mt, xr, xc, smem, vq), and stream
for _name in ("fwd_level1_pack", "inv_level1_pack", "fwd_level2_pack",
              "inv_level2_pack"):
    _SIGNATURES["dtcwt_" + _name] = (_P,) * 7 + (_I,) * 6 + (_P,) * 3 + (
        _I, _I) + (_I,) * (6 if _name.startswith("fwd") else 7) + (_P,)
# the two-sided (H, W) kernels of csrc/hw.cu: analysis in0..in3, out0..out3,
# synthesis v00..v11, y; then N, H, W, Ho, Wo, taps, lens, offs, dtype, the
# tile (oh, ow, mt, xr, xc, smem), and stream
for _name, _n_ptr in (("filter_hw22", 8), ("dfilt_hw22", 8),
                      ("filter_sum_hw22", 5), ("ifilt_sum_hw22", 5)):
    _SIGNATURES["dtcwt_" + _name] = (_P,) * _n_ptr + (_I,) * 5 + (
        _P,) * 3 + (_I,) * 7 + (_P,)

# the long-filter kernel of csrc/longfir.cu: x0, x1, y0, y1, outer, n_in,
# inner, sum, side, refl, taps (device), meta and tile (host), dtype, stream
_L = ctypes.c_longlong
_SIGNATURES["dtcwt_longfir"] = (_P,) * 4 + (_L, _I, _L) + (_I,) * 3 + (
    _P,) * 3 + (_I, _P)

#: Kernel launches per wrapper, counted where each wrapper launches.
launches = collections.Counter()

_lib = None
_lock = threading.Lock()


def count(name: str) -> None:
    launches[name] += 1


def reset_launches() -> None:
    launches.clear()


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA kernels "
        "of dtcwt_tpu_torch are built at first use on a machine with the "
        "CUDA toolkit")


def build() -> str:
    """Compile ``csrc/*.cu`` into ``build/kernels/`` unless a library built
    from the same sources exists; return its path."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    path = os.path.join(BUILD_DIR, "dtcwt_kernels_%s.so" % h.hexdigest()[:16])
    if os.path.exists(path):
        return path
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        jobs = []
        for src in (s for s in srcs if s.endswith(".cu")):
            obj = os.path.join(work, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for cmd, _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                for *_, other in jobs:
                    other.kill()
                    other.wait()
                raise RuntimeError("nvcc failed (exit %d):\n%s\n%s" % (
                    proc.returncode, " ".join(cmd), err))
        tmp = os.path.join(work, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
               *[obj for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (exit %d):\n%s\n%s" % (
                proc.returncode, " ".join(cmd), proc.stderr))
        os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            lib.dtcwt_error_string.argtypes = [ctypes.c_int]
            lib.dtcwt_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check_no_grad(name: str, *inputs) -> None:
    """Raise RuntimeError where a launch of kernel wrapper *name* would drop
    a gradient: grad mode is on and a tensor among *inputs* (tensors,
    None, or tuples and lists of them) requires grad.  The kernels fill
    fresh tensors through ctypes, so their outputs carry no ``grad_fn``.
    ``Transform1d``, ``Transform2d`` and ``Transform3d`` and the sharded
    ``ShardedTransform1d``, ``ShardedTransform2d`` and
    ``ShardedTransform3d`` have gradients on the card: they run their
    kernels inside ``linearize.linear_vjp`` (the sharded ones one Function
    per filter pass), where grad mode is off, and a second-order backward
    through their explicit adjoints ends here.  The low-level wrappers
    (``ops.colfilter`` ..., the level, dual and hw entries called
    directly) have none and refuse such inputs."""
    if not torch.is_grad_enabled():
        return
    stack = list(inputs)
    while stack:
        t = stack.pop()
        if isinstance(t, (tuple, list)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            raise RuntimeError(
                "%s: an input requires grad, and this CUDA kernel wrapper "
                "has no gradient (Transform1d, Transform2d, Transform3d "
                "and the sharded transforms have gradients on the card, to "
                "first order; the low-level wrappers do not); run it under "
                "torch.no_grad(), or on device=\"cpu\", the plain PyTorch "
                "path, which has them" % name)


def within_bound(name: str, lengths) -> bool:
    """The route rule of every kernel wrapper: whether filters of *lengths*
    taps (None for an absent filter) lie within the tap bound of wrapper
    *name*'s own kernel (:data:`TAP_BOUNDS`).  A wrapper evaluates it
    before any launch and, where it is false, launches the long-filter
    kernels instead; no route catches a kernel's error."""
    return max(n for n in lengths if n is not None) <= TAP_BOUNDS[name]


def on_cpu(x: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (plain route), False for a CUDA tensor (kernel
    route); any other device raises."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError("%s runs on CPU or CUDA tensors, not %s"
                         % (name, x.device))
    return False


def ext_len(ext: torch.Tensor, side: int, axis: int) -> int:
    """The signal's length in a buffer extended by *side* a side."""
    n = ext.shape[axis] - 2 * side
    if side < 0 or n < 1:
        raise ValueError("an extension of %d per side leaves no signal in "
                         "an axis of %d" % (side, ext.shape[axis]))
    return n


def axis_view(name: str, ins, axis: int):
    """(axis, outer, n_in, inner, dtype code): the kernels' [outer, n_in,
    inner] view of the inputs *ins* along *axis*, which must be contiguous
    and share one dtype and device."""
    x = ins[0]
    ax = fb._norm_axis(axis, x.ndim)
    code = dtype_code(x.dtype)
    for t in ins:
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError("%s: inputs must share one dtype and device"
                             % name)
        if not t.is_contiguous():
            raise ValueError("%s needs contiguous inputs" % name)
    shape = tuple(x.shape)
    return (ax, int(np.prod(shape[:ax], dtype=np.int64)), shape[ax],
            int(np.prod(shape[ax + 1:], dtype=np.int64)), code)


def check_reach(name: str, plans, groups, D: int, S: int, n_in: int,
                side) -> None:
    """From-extension mode (*side* not None): raise ValueError unless every
    read of branch b's streams ``plans[b] = (taps [P, m_b], offsets)``
    over its ``groups[b]`` groups stays inside the buffer of *n_in*."""
    if side is None:
        return
    for (taps, offs), g in zip(plans, groups):
        for off in offs:
            first = off + side
            last = first + D * (g - 1) + S * (taps.shape[1] - 1)
            if g > 0 and (first < 0 or last >= n_in):
                raise ValueError(
                    "%s: an extension of %d per side does not cover the "
                    "filters' reach" % (name, side))


def check_sizes(name: str, outer: int, n_in: int, inner: int,
                rows: int) -> None:
    """Raise ValueError where an axis view exceeds the kernels' 32-bit
    sizes."""
    if max(outer, n_in, inner, rows) > INT_MAX:
        raise ValueError("%s: the axis view [%d, %d, %d] exceeds the "
                         "kernel's 32-bit sizes" % (name, outer, n_in, inner))


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = library().dtcwt_error_string(err).decode()
        raise RuntimeError("%s: CUDA error %d (%s)" % (name, err, msg))


def flatten_batch(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """[..., R, C] -> [B, R, C] plus the original leading shape."""
    lead = tuple(x.shape[:-2])
    B = int(np.prod(lead, dtype=np.int64)) if lead else 1
    return x.reshape((B,) + tuple(x.shape[-2:])), lead


_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in _DTYPES:
        raise TypeError("the CUDA kernels take float32, bfloat16 or float64,"
                        " not %s" % dtype)
    return _DTYPES[dtype]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def taps_arg(*vectors) -> np.ndarray:
    """Concatenate float64 tap vectors into one contiguous host array (the
    caller keeps it alive across the launch)."""
    return np.ascontiguousarray(np.concatenate(
        [np.asarray(v, np.float64).reshape(-1) for v in vectors]))


def ints_arg(values) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(values, np.int32).reshape(-1))


def ptr(arr) -> int:
    """Host address of a tap or offset table, None (a null pointer) for
    none."""
    return None if arr is None else arr.ctypes.data


def check_smem_bytes(name: str, nbytes: int) -> None:
    """Raise ValueError where a launch would ask for *nbytes* of dynamic
    shared memory a block, more than a block may have."""
    if nbytes > SMEM_LIMIT:
        raise ValueError("%s: the filters need %d bytes of shared memory a "
                         "block, over the card's %d" % (name, nbytes,
                                                       SMEM_LIMIT))


def odd_filters(name: str, *filters):
    """Flat float64 taps of a level-1 kernel's filters (a None stays None),
    held to the level's rule: odd lengths (their tap bound is the route's,
    :func:`within_bound`)."""
    h = [None if f is None else np.asarray(f, np.float64).reshape(-1)
         for f in filters]
    lens = [f.size for f in h if f is not None]
    if any(n % 2 == 0 for n in lens):
        raise ValueError("%s takes odd-length filters, got lengths %s"
                         % (name, lens))
    return h


def pair_filters(name: str, *filters):
    """Flat float64 taps of a qshift level kernel's filters (a None stays
    None), held to the level's rule: one even length for all of them, the
    third pair's included (their tap bound is the route's,
    :func:`within_bound`)."""
    h = [None if f is None else np.asarray(f, np.float64).reshape(-1)
         for f in filters]
    lens = [f.size for f in h if f is not None]
    if len(set(lens)) != 1 or lens[0] % 2:
        raise ValueError("%s takes filters of one even length for all of "
                         "them, got lengths %s" % (name, lens))
    return h


def fir_args(h):
    """(taps, length) argument pairs of the level-1 kernels for the filters
    *h* (None: a null table, no third stream); the tables are returned too,
    for the caller to keep alive across the launch."""
    tables = [None if f is None else taps_arg(f[::-1]) for f in h]
    args = []
    for f, t in zip(h, tables):
        args += [ptr(t), 0 if f is None else f.size]
    return args, tables
