"""Low-level compute primitives: the filters, the subband packing and the
kernels (``dtcwt_tpu.ops``).

The nine filter names run on their tensor's device: a CUDA tensor launches
the single-stream kernels of :mod:`single`, a CPU tensor their plain
versions.  Importing this package builds nothing.
"""

from dtcwt_tpu_torch.ops.fb import symmetric_extend
from dtcwt_tpu_torch.ops.packing import c2q, c2q1d, q2c, q2c1d
from dtcwt_tpu_torch.ops.single import (
    coldfilt, colfilter, colifilt, dfilt_axis, filter_axis, ifilt_axis,
    rowdfilt, rowfilter, rowifilt)

__all__ = [
    "colfilter", "rowfilter", "coldfilt", "rowdfilt", "colifilt", "rowifilt",
    "filter_axis", "dfilt_axis", "ifilt_axis", "symmetric_extend",
    "q2c", "c2q", "q2c1d", "c2q1d",
]
