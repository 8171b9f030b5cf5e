"""The port's own copy of the coefficient tables equals the JAX package's,
bit for bit."""

import numpy as np
import pytest

from dtcwt_tpu import coeffs as jcoeffs
from dtcwt_tpu_torch import coeffs as tcoeffs


@pytest.mark.parametrize("name", jcoeffs.BIORT_NAMES + jcoeffs.QSHIFT_NAMES)
def test_taps_equal_jax_package(name):
    load = "biort" if name in jcoeffs.BIORT_NAMES else "qshift"
    want = getattr(jcoeffs, load)(name)
    got = getattr(tcoeffs, load)(name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w)


def test_wrong_kind_and_unknown_name_raise():
    with pytest.raises(ValueError):
        tcoeffs.biort("qshift_a")
    with pytest.raises(ValueError):
        tcoeffs.qshift("near_sym_a")
    with pytest.raises(IOError):
        tcoeffs.biort("no_such_wavelet")
