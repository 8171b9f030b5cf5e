"""Time the long-filter kernel (``csrc/longfir.cu``) on one NVIDIA GPU.

    python tools/time_long.py            # from the repository's root
    python tools/time_long.py ptxas      # first print -Xptxas -v of each
                                         # kernel instance

Prints the card's name and power limit, then (``ptxas``) one line per
instance of ``csrc/longfir.cu``: registers, stack frame and spills, as
``nvcc -Xptxas -v`` reports them; then each of the kernel's launches in
the long-family 4096^2 2-D round trip, timed alone with the stream held,
against its plain version and its bound, their sums by operation and one
``F.conv2d`` for the first column and row passes
(``chip_smoke.time_long_launches``).  The helpers come from this
checkout's ``chip_smoke.py``, the package from the working directory: run
by its absolute path from the root of another checkout (a ``git
archive`` of the parent under ``build/parent``), it times that checkout's
kernel, so that two versions can be compared in one call (parent,
change, change, parent).
"""

import importlib.util
import os
import re
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
from dtcwt_tpu_torch.ops import _build  # noqa: E402


def ptxas() -> None:
    """One line per kernel instance of the working directory's
    ``csrc/longfir.cu``, from ``nvcc -Xptxas -v``."""
    src = os.path.join(_build.CSRC, "longfir.cu")
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
         _build.CSRC, "-c", "-o", os.devnull, src],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit("nvcc failed:\n" + proc.stderr)
    out = proc.stderr
    name = None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            if shutil.which("c++filt"):
                name = subprocess.run(["c++filt", name], capture_output=True,
                                      text=True).stdout.strip() or name
            name = re.sub(r"\(anonymous namespace\)::|dtcwt::", "", name)
            name = re.sub(r"\(.*\)$", "", name)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            stack = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print("ptxas %s: %s registers, %s bytes stack, %s / %s bytes "
                  "spill stores / loads" % (name, m.group(1), *stack),
                  flush=True)
            name = None


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("time_long: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print("nvidia-smi: %s; package %s" % (smi, os.getcwd()), flush=True)
    if "ptxas" in sys.argv[1:]:
        ptxas()
    _build.library()
    report = {k: {"max_abs_err": 0.0} for k in cs.LONG_NAMES}
    cs.time_long_launches(dev, report, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
