"""The kernel wrappers' refusal of inputs that need gradients, checked on
the CPU.

The CUDA kernel wrappers fill fresh tensors through ctypes, so a launch on
an input that requires grad would return results with no ``grad_fn`` and
silently drop that input's part of a gradient.  Every launch site calls
``_build.check_no_grad`` first, which raises while grad mode is on; the
transforms launch inside ``ops/linearize``'s Function, where grad mode is
off (``tests/test_torch_grad.py``), and the plain path (``device="cpu"``)
keeps PyTorch's autograd.  The launch itself is checked on the card in
``tests/test_torch_cuda.py``.
"""

import ast
import glob
import os

import numpy as np
import pytest
import torch

import dtcwt_tpu_torch as dt
from dtcwt_tpu_torch.ops import _build

_OPS = os.path.join(os.path.dirname(_build.__file__), "*.py")


def _leaf(requires_grad):
    return torch.zeros(4, 4, dtype=torch.float64,
                       requires_grad=requires_grad)


@pytest.mark.parametrize("inputs", [
    (), (None,), (_leaf(False),), (_leaf(False), None, (_leaf(False),)),
    ([_leaf(False), _leaf(False)], (None, _leaf(False)))])
def test_check_no_grad_passes_inputs_without_grad(inputs):
    """Tensors that need no gradient, None and nests of them pass."""
    _build.check_no_grad("kernel", *inputs)


@pytest.mark.parametrize("inputs", [
    (_leaf(True),), (_leaf(False), None, (_leaf(True),)),
    ([_leaf(False), _leaf(True)],), (_leaf(True) * 2,)])
def test_check_no_grad_refuses_inputs_that_need_grad(inputs):
    """An input that requires grad, anywhere in the nest (a leaf or a
    result of one), raises while grad mode is on, naming the wrapper and
    device="cpu"; under torch.no_grad() the same inputs pass."""
    with pytest.raises(RuntimeError, match=r'kernel: .*device="cpu"'):
        _build.check_no_grad("kernel", *inputs)
    with torch.no_grad():
        _build.check_no_grad("kernel", *inputs)
    with torch.set_grad_enabled(False):
        _build.check_no_grad("kernel", *inputs)


def _functions_launching(path):
    """(function name, line of its first check_no_grad call or None, line
    of its first _build.library() call) for each function of module *path*
    that loads the kernel library."""
    tree = ast.parse(open(path).read())
    found = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        lib, guard = [], []
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "_build"):
                if node.func.attr == "library":
                    lib.append(node.lineno)
                elif node.func.attr == "check_no_grad":
                    guard.append(node.lineno)
        if lib:
            found.append((fn.name, min(guard) if guard else None, min(lib)))
    return found


def test_every_launch_site_calls_the_guard():
    """Every function of ``dtcwt_tpu_torch/ops`` that loads the kernel
    library calls ``_build.check_no_grad`` before it: the eight launch
    sites of the 2-D level kernels, the stream kernels (the dual entries
    and the single-stream ``dfilt`` and ``ifilt``), ``filter``, the 3-D
    level kernels, the hw kernels and the long-filter kernel."""
    sites = {}
    for path in sorted(glob.glob(_OPS)):
        if os.path.basename(path) == "_build.py":
            continue
        for name, guard, lib in _functions_launching(path):
            sites["%s:%s" % (os.path.basename(path), name)] = (guard, lib)
    assert sorted(sites) == [
        "dual.py:_launch_stream", "hw.py:_launch",
        "ilevel1.py:inv_level1", "ilevel2.py:inv_level2",
        "level1.py:fwd_level1", "level2.py:fwd_level2",
        "longfir.py:stream", "pack3d.py:_launch", "single.py:_filter"]
    for site, (guard, lib) in sites.items():
        assert guard is not None and guard < lib, site


def test_plain_path_autograd_untouched():
    """The plain path keeps PyTorch's autograd: f64 gradcheck of
    ``Transform2d(device="cpu")``'s forward (lowpass and every subband) and
    of its round trip at 8 x 8, 2 levels, with an input that requires
    grad."""
    t = dt.Transform2d(device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).rand(8, 8)).requires_grad_()

    def forward(v):
        p = t.forward(v, nlevels=2)
        return (p.lowpass,) + tuple(torch.view_as_real(h)
                                    for h in p.highpasses)

    assert torch.autograd.gradcheck(forward, (x,))
    assert torch.autograd.gradcheck(
        lambda v: t.inverse(t.forward(v, nlevels=2)), (x,))
    rec = t.inverse(t.forward(x, nlevels=2))
    assert rec.grad_fn is not None
    rec.sum().backward()
    assert torch.allclose(x.grad, torch.ones_like(x), atol=1e-10)
