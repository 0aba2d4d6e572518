"""Load the program under test, ``cuda.radixsort_tpu_torch``, from this
checkout, and its CUDA kernels from the checkout's build cache."""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys
import time

NAME = "cuda.radixsort_tpu_torch"


def load(root: str):
    """Import the port from ``root``, the checkout.

    Where cuda-python is installed, a startup hook of its (a .pth file)
    binds the top-level name ``cuda`` to its own namespace package, which
    hides the checkout's ``cuda/``. The port is then loaded from its path
    and registered under its usual name."""
    pkg_dir = os.path.join(root, "cuda", "radixsort_tpu_torch")
    if not os.path.isfile(os.path.join(pkg_dir, "__init__.py")):
        raise ImportError(f"{NAME} not found under {root}: run the benchmark "
                          "from the root of a checkout of the repository")
    if root not in sys.path:
        sys.path.insert(0, root)
    parent = sys.modules.get("cuda")
    parent_file = getattr(parent, "__file__", None) or ""
    if parent is None or os.path.dirname(parent_file) == os.path.join(root,
                                                                     "cuda"):
        return importlib.import_module(NAME)
    spec = importlib.util.spec_from_file_location(
        NAME, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[NAME] = mod
    spec.loader.exec_module(mod)
    setattr(parent, "radixsort_tpu_torch", mod)
    return mod


def build_kernels() -> dict:
    """Load the kernel library, building it with nvcc when the checkout's
    cache (``build/radixsort_tpu_torch/``, keyed by a hash of the sources)
    does not hold it. Returns whether this run compiled, and the seconds."""
    build = importlib.import_module(NAME + ".utils.build")
    before = _libraries(build.BUILD_DIR)
    t0 = time.monotonic()
    build.library()
    seconds = time.monotonic() - t0
    return {"compiled": bool(_libraries(build.BUILD_DIR) - before),
            "seconds": seconds}


def _libraries(path: str) -> set:
    if not os.path.isdir(path):
        return set()
    return {f for f in os.listdir(path) if f.endswith(".so")}
