"""Backend-stack compatibility layer (``dtcwt_tpu.compat_backend``).

The reference library dispatches between numpy/opencl/tf backends with a
mutable stack.  This package has one backend, PyTorch (``"torch"``), so the
stack is kept only for API compatibility: pushing a known backend name
succeeds and is recorded, an unknown name raises ``KeyError``, popping the
base entry raises ``IndexError``, and :func:`preserve_backend_stack`
restores the stack on exit even when its body raises.
"""

from __future__ import annotations

import contextlib

__all__ = ["backend_name", "push_backend", "pop_backend",
           "preserve_backend_stack", "KNOWN_BACKENDS"]

KNOWN_BACKENDS = ("torch", "numpy", "opencl", "tf")

_STACK = ["torch"]


def backend_name() -> str:
    return _STACK[-1]


def push_backend(name: str):
    if name not in KNOWN_BACKENDS:
        raise KeyError("No such backend: {!r}".format(name))
    _STACK.append(name)
    _sync()


def pop_backend():
    if len(_STACK) == 1:
        raise IndexError("Cannot pop base backend")
    _STACK.pop()
    _sync()


@contextlib.contextmanager
def preserve_backend_stack():
    saved = list(_STACK)
    try:
        yield
    finally:
        _STACK[:] = saved
        _sync()


def _sync():
    import dtcwt_tpu_torch
    dtcwt_tpu_torch.backend_name = _STACK[-1]
