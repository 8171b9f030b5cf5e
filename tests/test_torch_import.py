"""Importing the port (its package, ``ops``, ``compat``, ``parallel``, the
algorithms, ``utils``, ``plotting`` and every kernel module) pulls in
neither JAX nor Triton (nor matplotlib) and builds nothing, in whichever
order the modules come; the port's examples import neither JAX nor the
JAX package; and the kernel build refuses loudly where there is no
``nvcc``."""

import ast
import glob
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_loads_no_jax_or_triton_and_builds_nothing():
    code = (
        "import sys, dtcwt_tpu_torch, dtcwt_tpu_torch.convert\n"
        "import dtcwt_tpu_torch.ops, dtcwt_tpu_torch.compat\n"
        "import dtcwt_tpu_torch.compat_backend\n"
        "from dtcwt_tpu_torch import sampling, registration, keypoint\n"
        "from dtcwt_tpu_torch.ops import _build, dual, hw, level1, level2, "
        "ilevel1, ilevel2, pack3d, single\n"
        "from dtcwt_tpu_torch.transforms import transform3d\n"
        "import dtcwt_tpu_torch.parallel\n"
        "from dtcwt_tpu_torch.parallel import halo, mesh, transform3d_dist\n"
        "from dtcwt_tpu_torch.parallel import (\n"
        "    batch, registration_dist, transform1d_dist, transform2d_dist)\n"
        "from dtcwt_tpu_torch import plotting, utils\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'dtcwt_tpu', 'matplotlib'))\n"
        "assert not bad, bad\n"
        "assert _build._lib is None\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("first", ["dtcwt_tpu_torch.ops",
                                   "dtcwt_tpu_torch.compat",
                                   "dtcwt_tpu_torch.transforms.transform3d",
                                   "dtcwt_tpu_torch.ops.single",
                                   "dtcwt_tpu_torch.parallel",
                                   "dtcwt_tpu_torch.ops.hw",
                                   "dtcwt_tpu_torch.sampling",
                                   "dtcwt_tpu_torch.registration",
                                   "dtcwt_tpu_torch.keypoint",
                                   "dtcwt_tpu_torch.parallel.batch",
                                   "dtcwt_tpu_torch.parallel.transform1d_dist",
                                   "dtcwt_tpu_torch.parallel.transform2d_dist",
                                   "dtcwt_tpu_torch.parallel."
                                   "registration_dist",
                                   "dtcwt_tpu_torch.utils",
                                   "dtcwt_tpu_torch.plotting"])
def test_each_module_imports_first_without_a_cycle(first):
    """Any of the public modules can be the first one imported: ``ops``
    (which binds the filter names to ``ops.single``) and the transforms
    import each other's modules without a cycle."""
    code = ("import importlib, sys\n"
            "importlib.import_module(%r)\n"
            "import dtcwt_tpu_torch.ops as ops, dtcwt_tpu_torch.compat\n"
            "assert ops.coldfilt.__module__ == 'dtcwt_tpu_torch.ops.single'\n"
            "assert not [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'triton', 'dtcwt_tpu')]\n" % first)
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


_EXAMPLES = sorted(glob.glob(os.path.join(_REPO, "examples", "*_torch.py")))


def test_every_example_has_a_port():
    """Each JAX example has its counterpart on the port."""
    names = {os.path.basename(p)[:-len("_torch.py")] for p in _EXAMPLES}
    jax = {os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(_REPO, "examples", "*.py")) if not p.endswith(
            "_torch.py")}
    assert names == jax


@pytest.mark.parametrize("path", _EXAMPLES, ids=os.path.basename)
def test_example_imports_no_jax(path):
    """The port's examples import neither JAX nor the JAX package, at any
    depth of the file (the imports inside functions included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    assert "dtcwt_tpu_torch" in {m.split(".")[0] for m in mods}
    bad = [m for m in mods
           if m.split(".")[0] in ("jax", "jaxlib", "triton", "dtcwt_tpu")]
    assert not bad, bad


def test_build_without_nvcc_raises_naming_nvcc(monkeypatch, tmp_path):
    """With no nvcc on PATH or under CUDA_HOME the build raises: there is
    no silent fallback to the plain path for CUDA tensors."""
    from dtcwt_tpu_torch.ops import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
