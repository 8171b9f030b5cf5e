"""Build, load and count the CUDA kernels; shared wrapper helpers.

The kernels are CUDA C++ for Hopper (``sm_90a``) in ``../csrc``, behind a
plain ``extern "C"`` interface that returns ``cudaGetLastError()``.  At
first use one ``nvcc`` call compiles all of them into a shared library under
``build/kernels/`` beside the package; the file name carries a hash of the
sources and flags, so edited sources rebuild.  The library is loaded with
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

__all__ = ["library", "build", "launches", "reset_launches", "count",
           "flatten_batch", "dtype_code", "stream_ptr", "check", "taps_arg",
           "ints_arg"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types of each exported function (see csrc/*.cu)
_SIGNATURES = {
    # x, lolo, out_a, out_b, B, R, C, t0, m0, t1, m1, dtype, planes, stream
    "dtcwt_level1": (_P, _P, _P, _P, _I, _I, _I, _P, _I, _P, _I, _I, _I, _P),
    # x, lolo, out_a, out_b, B, R, C, taps, offs, m, dtype, planes, stream
    "dtcwt_level2": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P),
    # z, band_a, band_b, out, B, H, W, taps, offs, m2, dtype, planes, stream
    "dtcwt_ilevel2": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P),
    # z, band_a, band_b, out, B, H, W, t0, m0, t1, m1, dtype, planes, stream
    "dtcwt_ilevel1": (_P, _P, _P, _P, _I, _I, _I, _P, _I, _P, _I, _I, _I,
                      _P),
}

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
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
           *[s for s in srcs if s.endswith(".cu")]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
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
