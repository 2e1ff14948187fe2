"""Build the port's CUDA kernels at first use.

All sources under ``kernels/csrc/`` (the six ``.cu`` kernel files with a
plain C interface, and ``binding.cpp``, the one small file that includes
PyTorch's headers) go through one ``torch.utils.cpp_extension.load`` call.
It needs nvcc and ninja, compiles the sources in parallel for ``sm_90a``
(Hopper) into ``build/torch_ext/`` at the root of the checkout, and caches
by content, so a second process in the same checkout loads without
compiling.

Nothing here runs at import: the CPU tests import every module, and a
machine that only runs them need not have ``nvcc``.
"""

from __future__ import annotations

import glob
import os
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
# <checkout>/src/repro_torch/kernels -> <checkout>/build/torch_ext
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    _HERE))), "build", "torch_ext")
CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]

_LOCK = threading.Lock()
_EXTENSION = None


def sources():
    """The kernel sources in a fixed order: the ``.cu`` files, then the
    binding."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))) + [
        os.path.join(CSRC, "binding.cpp")]


def extension():
    """The loaded extension module, built on the first call."""
    global _EXTENSION
    with _LOCK:
        if _EXTENSION is None:
            from torch.utils.cpp_extension import load
            os.makedirs(BUILD_DIR, exist_ok=True)   # load() does not
            _EXTENSION = load(
                name="repro_torch_kernels", sources=sources(),
                build_directory=BUILD_DIR, extra_cflags=["-O3"],
                extra_cuda_cflags=CUDA_FLAGS, verbose=False)
        return _EXTENSION
