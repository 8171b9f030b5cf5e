"""Library-wide default wavelet families (as in ``dtcwt_tpu.defaults``)."""

DEFAULT_BIORT = "near_sym_a"
DEFAULT_QSHIFT = "qshift_a"
