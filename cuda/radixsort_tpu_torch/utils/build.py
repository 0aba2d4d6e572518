"""Build and load the port's CUDA kernels (``cuda/radixsort_tpu_torch/csrc``).

Counterpart of the loader in ``cuda/radixsort_tpu/utils/native.py``, with
one difference on purpose: a missing ``nvcc`` or a failed build raises
``RuntimeError`` (with nvcc's stderr) instead of returning None. There is no
fallback for a CUDA tensor.

Each ``csrc/*.cu`` file compiles in its own nvcc process, all started
together, and one more nvcc call links the objects into one shared library
with a plain C interface under ``build/radixsort_tpu_torch/`` at the root of
the checkout. The file name carries a hash of the sources' content and the
flags, so an edited source rebuilds and an unchanged one loads at once.
Every pointer and the stream are passed as ``ctypes.c_void_p``. ptxas
reports each kernel's registers and spills (``-Xptxas -v``); a build keeps
that report in ``PTXAS_REPORT``.

The limits the kernels are built for are set once, in ``config.py``: the
build writes them into the header ``rs_limits.h`` (:func:`limits_header`)
that the sources include.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from cuda.radixsort_tpu_torch import config as config_lib

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(os.path.dirname(_PKG))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_REPO, "build", "radixsort_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# C entry points: name -> argtypes. Each returns a cudaError_t as int.
_SIGNATURES = {
    # keys (void**), masks (u32*), n_stages (int*), half flags (int*), n_limbs,
    # n, width, out, scratch, table_bins, grid, threads, stream
    "rs_limb_histograms": [_P, _P, _P, _P, _I, _I64, _I, _P, _P, _I, _I, _I,
                           _P],
    # in_planes (void**), out_planes (void**), wide (int*), n_planes,
    # key_half, gbase, n, shift, width, status, threads, items, smem, stream
    "rs_partition_stage": [_P, _P, _P, _I, _I, _P, _I64, _I, _I, _P, _I, _I,
                           _I64, _P],
    # values, flags (or NULL), out, n, dtype, op, reverse, scratch, scratch
    # words, stream
    "rs_segmented_scan": [_P, _P, _P, _I64, _I, _I, _I, _P, _I64, _P],
    # planes (void**), n_planes, n, log_t, log_e, threads, phases (int*),
    # n_phases, net_tile, n_cmp, smem, stream
    "rs_bitonic_tile": [_P, _I, _I64, _I, _I, _I, _P, _I, _I, _I, _I64, _P],
    # planes (void**), n_planes, n, k, lo, c, net_tile, n_cmp, stream
    "rs_bitonic_cross": [_P, _I, _I64, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
_SCRATCH: dict = {}  # (owner, device index, stream) -> stream_scratch's buffer
PTXAS_REPORT: dict[str, str] = {}  # source file name -> ptxas -v output


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of cuda.radixsort_tpu_torch cannot be built on this machine")
    return nvcc


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def limits_header() -> str:
    """``rs_limits.h``: config.py's kernel limits as macros."""
    limits = {
        "RS_MAX_PLANES": config_lib.MAX_PLANES,
        "RS_MAX_CROSS_WORDS": config_lib.MAX_CROSS_WORDS,
        "RS_MAX_TILE_WORDS": config_lib.MAX_TILE_WORDS,
        "RS_MAX_TILE_THREADS": config_lib.MAX_TILE_THREADS,
        "RS_TILE_BLOCKS_PER_SM": config_lib.TILE_BLOCKS_PER_SM,
        "RS_MAX_STAGE_THREADS": config_lib.MAX_STAGE_THREADS,
        "RS_STAGE_ITEMS": ", ".join(map(str, config_lib.STAGE_ITEMS)),
        "RS_HIST_MAX_LIMBS": config_lib.HIST_MAX_LIMBS,
        "RS_SMEM_BYTES": config_lib.SMEM_BYTES,
    }
    return "".join(f"#define {k} {v}\n" for k, v in limits.items())


def _digest(srcs: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(limits_header().encode())
    for path in srcs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build() -> str:
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    so = os.path.join(BUILD_DIR, f"libradixsort_{_digest(srcs)}.so")
    if os.path.exists(so):
        return so
    nvcc = _find_nvcc()
    tmp = f"{so}.{os.getpid()}.tmp"
    include = f"{tmp}.include"
    os.makedirs(include, exist_ok=True)
    with open(os.path.join(include, "rs_limits.h"), "w") as f:
        f.write(limits_header())
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-I", include, "-c", "-o", obj, src]
            for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    try:
        for src, cmd, proc in zip(srcs, cmds, procs):
            PTXAS_REPORT[os.path.basename(src)] = _run_checked(cmd, proc)
        link = [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                "-o", tmp, *objs]
        _run_checked(link, subprocess.Popen(link, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))
    finally:
        for proc in procs:
            proc.kill()  # a no-op for one that has ended; none outlives a failure
            proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        shutil.rmtree(include, ignore_errors=True)
    os.replace(tmp, so)
    return so


def _run_checked(cmd: list[str], proc: subprocess.Popen) -> str:
    """Wait for nvcc; returns its stderr, raises if it failed."""
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{err}")
    return err


def library() -> ctypes.CDLL:
    """The loaded kernel library; builds it at first use. Raises
    RuntimeError if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.rs_error_string.argtypes = [_I]
            lib.rs_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def stream_scratch(owner: str, device, stream: int, words: int,
                   dtype) -> torch.Tensor:
    """A kernel's scratch for launches on one stream, zero when first made
    and kept (grown to ``words`` when short): launches on one stream run in
    order, so they can share it. ``owner`` names the kernel."""
    key = (owner, device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        buf = _SCRATCH[key] = torch.zeros(words, dtype=dtype, device=device)
    return buf


def ptr_array(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers, for a C entry point
    that takes ``void**``. Keep it alive until the call returns."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = library().rs_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")
