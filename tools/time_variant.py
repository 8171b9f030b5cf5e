"""Time a variant of one level kernel's source beside the package's other
kernels, on one NVIDIA GPU.

    python tools/time_variant.py VARIANT.cu dtcwt_level2 level2
    python tools/time_variant.py VARIANT.cu dtcwt_ilevel2 ilevel2 kernels
    python tools/time_variant.py VARIANT.cu \
        dtcwt_fwd_level1_pack,dtcwt_fwd_level2_pack pack3d kernels
    python tools/time_variant.py VARIANT.cu \
        dtcwt_inv_level1_pack,dtcwt_inv_level2_pack pack3d kernels
    python tools/time_variant.py VARIANT.cu \
        dtcwt_filter_hw22,dtcwt_dfilt_hw22 hw kernels
    python tools/time_variant.py VARIANT.cu \
        dtcwt_filter2,dtcwt_dfilt2 dual kernels
    python tools/time_variant.py VARIANT.cu dtcwt_filter2,dtcwt_dfilt2 \
        dual kernels --set 'dual._COL_TX={2: 64, 4: 32, 8: 256}'
    python tools/time_variant.py VARIANT.cu dtcwt_dfilt,dtcwt_ifilt dual \
        kernels
    python tools/time_variant.py VARIANT.cu dtcwt_longfir long

Compiles ``VARIANT.cu`` (an edited copy of a ``csrc/*.cu`` file; its
includes are searched in its own directory first, then in ``csrc/``, so a
varied header goes there with the headers that include it) into a shared
library of its own with the package's nvcc flags and ``-Xptxas -v``
(its report goes to the standard error), routes the named C entries (one
or several, comma-separated: ``dtcwt_level2``, ``dtcwt_level1``,
``dtcwt_ilevel1``, ``dtcwt_ilevel2``, ``dtcwt_fwd_level1_pack``,
``dtcwt_fwd_level2_pack``, ``dtcwt_inv_level1_pack``,
``dtcwt_inv_level2_pack``, ``dtcwt_filter_hw22``, ``dtcwt_dfilt_hw22``,
``dtcwt_filter_sum_hw22``, ``dtcwt_ifilt_sum_hw22``, ``dtcwt_filter2``,
``dtcwt_dfilt2``, ``dtcwt_filter2_sum``, ``dtcwt_ifilt2_sum``,
``dtcwt_dfilt``, ``dtcwt_ifilt``, ``dtcwt_longfir``) to it and
every other entry to the package's
library, then runs ``tools/time_level1.py`` in the given mode,
``tools/time_pack3d.py`` for the mode ``pack3d``, ``tools/time_hw.py`` for
the mode ``hw``, ``tools/time_dual.py`` for the mode ``dual`` or
``tools/time_long.py`` for the mode ``long`` (a last
argument ``kernels``
stops any of them after the kernel lines).  A kernel's design is tuned
this way without rebuilding every source for each variant.  ``--set
MODULE.NAME=VALUE`` (repeatable) gives a constant of
``dtcwt_tpu_torch.ops.MODULE`` a Python literal first, for a variant whose
host tiling differs (the module's cached tilings are cleared).  Run from
the repository's root.
"""

import ast
import ctypes
import importlib
import importlib.util
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.getcwd())
from dtcwt_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    modes = ("level1", "ilevel1", "level2", "ilevel2", "pack3d", "hw",
             "dual", "long")
    tools = {"pack3d": "time_pack3d", "hw": "time_hw", "dual": "time_dual",
             "long": "time_long"}
    sets = []
    while "--set" in sys.argv[:-1]:
        i = sys.argv.index("--set")
        sets.append(sys.argv[i + 1])
        del sys.argv[i:i + 2]
    if len(sys.argv) not in (4, 5) or sys.argv[3] not in modes:
        raise SystemExit("usage: python tools/time_variant.py VARIANT.cu "
                         "ENTRY[,ENTRY...] %s [kernels] [--set "
                         "MODULE.NAME=VALUE ...]" % "|".join(modes))
    for item in sets:
        target, value = item.split("=", 1)
        module, name = target.split(".")
        mod = importlib.import_module("dtcwt_tpu_torch.ops." + module)
        if not hasattr(mod, name):
            raise SystemExit("time_variant: %s has no %s" % (module, name))
        setattr(mod, name, ast.literal_eval(value))
        for fn in vars(mod).values():
            if hasattr(fn, "cache_clear"):
                fn.cache_clear()
        print("set %s.%s = %r" % (module, name, getattr(mod, name)),
              flush=True)
    src, entries, mode = sys.argv[1:4]
    lib = _build.library()
    out = os.path.join(tempfile.mkdtemp(dir=_build.BUILD_DIR), "variant.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                    "-I", os.path.dirname(os.path.abspath(src)), "-I",
                    _build.CSRC, "-shared", "-o", out, src], check=True)
    variant = ctypes.CDLL(out)
    routes = {}
    for entry in entries.split(","):
        fn = getattr(variant, entry)
        fn.argtypes = list(_build._SIGNATURES[entry])
        fn.restype = ctypes.c_int
        routes[entry] = fn

    class Routed:
        def __getattr__(self, name):
            return routes[name] if name in routes else getattr(lib, name)
    routed = Routed()
    _build.library = lambda: routed
    name = tools.get(mode, "time_level1")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           name + ".py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    sys.argv = [sys.argv[0]] + ([] if mode in tools else [mode]) + \
        sys.argv[4:]
    print("variant %s for %s" % (src, entries), flush=True)
    return tool.main()


if __name__ == "__main__":
    sys.exit(main())
