"""dtcwt_tpu_torch — the dual-tree complex wavelet transform of
``dtcwt_tpu`` in PyTorch, with hand-written CUDA kernels for the NVIDIA H100.

The first slice ports the 2-D transform's forward and inverse.  A CPU tensor
runs the plain PyTorch path; a CUDA tensor runs the level kernels, which are
built with ``nvcc`` at their first launch (importing this package compiles
nothing).
"""

from dtcwt_tpu_torch.coeffs import biort, qshift
from dtcwt_tpu_torch.transforms.pyramid import (
    PLANE_BAND_ORDER, PlanePyramid, Pyramid)
from dtcwt_tpu_torch.transforms.transform2d import Transform2d

__all__ = ["Transform2d", "Pyramid", "PlanePyramid", "PLANE_BAND_ORDER",
           "biort", "qshift"]
