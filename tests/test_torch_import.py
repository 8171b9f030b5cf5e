"""Importing the port pulls in neither JAX nor Triton and builds nothing,
and the kernel build refuses loudly where there is no ``nvcc``."""

import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax_or_triton_and_builds_nothing():
    code = (
        "import sys, dtcwt_tpu_torch, dtcwt_tpu_torch.convert\n"
        "from dtcwt_tpu_torch.ops import _build, level1, level2, ilevel1, "
        "ilevel2\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'triton', 'dtcwt_tpu'))\n"
        "assert not bad, bad\n"
        "assert _build._lib is None\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_build_without_nvcc_raises_naming_nvcc(monkeypatch, tmp_path):
    """With no nvcc on PATH or under CUDA_HOME the build raises: there is
    no silent fallback to the plain path for CUDA tensors."""
    from dtcwt_tpu_torch.ops import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
