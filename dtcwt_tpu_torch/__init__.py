"""dtcwt_tpu_torch — the dual-tree complex wavelet transform of
``dtcwt_tpu`` in PyTorch, with hand-written CUDA kernels for the NVIDIA H100.

It holds the 1-D, 2-D and 3-D transforms' forward and inverse.  A transform runs
on its ``device``: the card by default, where its CUDA kernels run (built
with ``nvcc`` at their first launch; importing this package compiles
nothing), or the CPU with ``device="cpu"``, where the plain PyTorch versions
run.
"""

from dtcwt_tpu_torch.coeffs import biort, qshift
from dtcwt_tpu_torch.transforms.pyramid import (
    PLANE_BAND_ORDER, PlanePyramid, Pyramid)
from dtcwt_tpu_torch.transforms.transform1d import Transform1d
from dtcwt_tpu_torch.transforms.transform2d import Transform2d
from dtcwt_tpu_torch.transforms.transform3d import Transform3d

__all__ = ["Transform1d", "Transform2d", "Transform3d", "Pyramid", "PlanePyramid",
           "PLANE_BAND_ORDER", "biort", "qshift"]
