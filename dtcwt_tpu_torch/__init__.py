"""dtcwt_tpu_torch — the dual-tree complex wavelet transform of
``dtcwt_tpu`` in PyTorch, with hand-written CUDA kernels for the NVIDIA H100.

It holds the 1-D, 2-D and 3-D transforms' forward and inverse, the
low-level filters (:mod:`dtcwt_tpu_torch.ops`), the MATLAB-style
functions (:mod:`dtcwt_tpu_torch.compat`) and the algorithms on the 2-D
pyramid (:mod:`~dtcwt_tpu_torch.sampling`,
:mod:`~dtcwt_tpu_torch.registration`, :mod:`~dtcwt_tpu_torch.keypoint`).  A transform runs on its
``device``: the card by default, where its CUDA kernels run (built with
``nvcc`` at their first launch; importing this package compiles nothing),
or the CPU with ``device="cpu"``, where the plain PyTorch versions run.
"""

from dtcwt_tpu_torch._version import __version__
from dtcwt_tpu_torch.coeffs import BIORT_NAMES, QSHIFT_NAMES, biort, qshift
from dtcwt_tpu_torch.transforms.pyramid import (
    PLANE_BAND_ORDER, PlanePyramid, Pyramid)
from dtcwt_tpu_torch.transforms.transform1d import Transform1d
from dtcwt_tpu_torch.transforms.transform2d import Transform2d
from dtcwt_tpu_torch.transforms.transform3d import Transform3d

__all__ = [
    "__version__",
    "Pyramid", "PlanePyramid", "PLANE_BAND_ORDER",
    "Transform1d", "Transform2d", "Transform3d",
    "biort", "qshift", "BIORT_NAMES", "QSHIFT_NAMES",
    "backend_name", "push_backend", "pop_backend", "preserve_backend_stack",
]

# The reference library's backend stack (numpy/opencl/tf), kept so that
# code written against it runs; the one backend here is PyTorch, and the
# device is the Transform's ``device`` argument.
backend_name = "torch"


def push_backend(name: str):
    """Push a backend name on the compatibility stack (see
    :mod:`compat_backend`)."""
    from dtcwt_tpu_torch.compat_backend import push_backend as _pb
    _pb(name)


def pop_backend():
    from dtcwt_tpu_torch.compat_backend import pop_backend as _pb
    _pb()


def preserve_backend_stack():
    from dtcwt_tpu_torch.compat_backend import preserve_backend_stack as _p
    return _p()
