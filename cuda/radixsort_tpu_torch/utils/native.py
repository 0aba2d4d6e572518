"""ctypes bindings of the host runtime (``csrc/hostutils.cpp`` at the root of
the checkout): data generation, CPU oracle sorts, verification and the
threaded k-way merge that is the host half of the external sort.

Counterpart of ``cuda/radixsort_tpu/utils/native.py``, with two differences
on purpose:

* the library builds with g++ into ``build/radixsort_tpu_torch/`` (its
  file name carries a hash of the source and the flags), written to a
  temporary name and moved into place under a file lock, so processes that
  build at once never load a half-written library;
* there is no fallback: a missing g++ or a failed build raises
  ``RuntimeError`` with the compiler's stderr. The numpy stable merge lives
  on as :func:`kway_merge_u32_plain`, the plain version the tests hold the
  native merge against.

Numpy in, numpy out. Every array is made contiguous before its pointer is
passed, and every length is checked here, before the C code sees it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
SOURCE = os.path.join(_REPO, "csrc", "hostutils.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "radixsort_tpu_torch")
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None

_U32P = ctypes.POINTER(ctypes.c_uint32)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I64 = ctypes.c_int64
# C entry points: name -> (argtypes, restype)
_SIGNATURES = {
    "rt_fill_random_u32": ([_U32P, _I64, ctypes.c_uint64], None),
    "rt_fill_skewed_u32": ([_U32P, _I64, ctypes.c_uint64, ctypes.c_uint32,
                            ctypes.c_uint32, ctypes.c_uint32], None),
    "rt_lsd_sort_u32": ([_U32P, _U32P, _I64], None),
    "rt_lsd_sort_pairs_u32": ([_U32P, _U32P, _U32P, _U32P, _I64], None),
    "rt_verify_sorted_u32": ([_U32P, _I64], _I64),
    "rt_compare_u32": ([_U32P, _U32P, _I64], _I64),
    "rt_histogram16": ([_U32P, _I64, ctypes.c_int, _I64P], None),
    "rt_lsd_sort_u64": ([_U64P, _U64P, _I64], None),
    "rt_lsd_sort_pairs_u64": ([_U64P, _U32P, _U64P, _U32P, _I64], None),
    "rt_verify_sorted_u64": ([_U64P, _I64], _I64),
    "rt_compare_u64": ([_U64P, _U64P, _I64], _I64),
    "rt_kway_merge_u32": ([ctypes.POINTER(_U32P), _I64P, ctypes.c_int, _I64,
                           _U32P, ctypes.POINTER(_U32P), _U32P], None),
}


def library_path() -> str:
    """Where the library of this source and these flags is built."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhostutils_{h.hexdigest()[:16]}.so")


def _build() -> str:
    so = library_path()
    if os.path.exists(so):
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host runtime "
                           f"({SOURCE}) cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "hostutils.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(so):  # another process built it while we waited
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [gxx, *GXX_FLAGS, "-o", tmp, SOURCE]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return so


def lib() -> ctypes.CDLL:
    """The loaded host library; builds it at first use. Raises RuntimeError
    if it cannot be built."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(_build())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(L, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = L
        return _lib


def _p32(a: np.ndarray):
    return a.ctypes.data_as(_U32P)


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_U64P)


def _same_length(a: np.ndarray, b: np.ndarray) -> None:
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"lengths differ: {a.shape[0]} != {b.shape[0]}")


def random_u32(n: int, seed: int = 0) -> np.ndarray:
    """n uniform random u32 (threaded; deterministic in seed and the host's
    thread count)."""
    out = np.empty(n, np.uint32)
    lib().rt_fill_random_u32(_p32(out), n, seed)
    return out


def skewed_u32(n: int, seed: int = 0, hot_key: int = 42,
               hot_fraction: float = 0.5) -> np.ndarray:
    """n u32 keys: ``hot_key`` with probability ``hot_fraction``, else
    uniform."""
    out = np.empty(n, np.uint32)
    den = 1 << 30
    lib().rt_fill_skewed_u32(_p32(out), n, seed, hot_key,
                             int(hot_fraction * den), den)
    return out


def lsd_sort_u32(keys: np.ndarray) -> np.ndarray:
    """CPU LSD radix sort of u32 keys (oracle). Returns a new array."""
    out = np.ascontiguousarray(keys, np.uint32).copy()
    tmp = np.empty_like(out)
    lib().rt_lsd_sort_u32(_p32(out), _p32(tmp), out.shape[0])
    return out


def lsd_sort_pairs_u32(keys: np.ndarray, vals: np.ndarray):
    """Stable CPU (u32 key, 4-byte payload) sort. Returns new arrays, the
    payload in its own dtype."""
    k = np.ascontiguousarray(keys, np.uint32).copy()
    v = np.ascontiguousarray(vals).view(np.uint32).copy()
    _same_length(k, v)
    tk, tv = np.empty_like(k), np.empty_like(v)
    lib().rt_lsd_sort_pairs_u32(_p32(k), _p32(v), _p32(tk), _p32(tv),
                                k.shape[0])
    return k, v.view(vals.dtype)  # 4 passes, an even count: back in k / v


def verify_sorted_u32(keys: np.ndarray) -> int:
    """-1 if ascending, else the first index i with keys[i] > keys[i+1]."""
    a = np.ascontiguousarray(keys, np.uint32)
    return int(lib().rt_verify_sorted_u32(_p32(a), a.shape[0]))


def compare_u32(a: np.ndarray, b: np.ndarray) -> int:
    """-1 if bit-identical, else the first differing index."""
    aa = np.ascontiguousarray(a, np.uint32)
    bb = np.ascontiguousarray(b, np.uint32)
    _same_length(aa, bb)
    return int(lib().rt_compare_u32(_p32(aa), _p32(bb), aa.shape[0]))


def histogram16(keys: np.ndarray, shift: int) -> np.ndarray:
    """int64 counts of the 4-bit digit (keys >> shift) & 15."""
    a = np.ascontiguousarray(keys, np.uint32)
    out = np.zeros(16, np.int64)
    lib().rt_histogram16(_p32(a), a.shape[0], shift,
                         out.ctypes.data_as(_I64P))
    return out


def lsd_sort_u64(keys: np.ndarray) -> np.ndarray:
    """CPU LSD radix sort of u64 keys (8 passes). Returns a new array."""
    out = np.ascontiguousarray(keys, np.uint64).copy()
    tmp = np.empty_like(out)
    lib().rt_lsd_sort_u64(_p64(out), _p64(tmp), out.shape[0])
    return out


def lsd_sort_pairs_u64(keys: np.ndarray, vals: np.ndarray):
    """Stable CPU (u64 key, u32 payload) sort. Returns new arrays."""
    ok = np.ascontiguousarray(keys, np.uint64).copy()
    ov = np.ascontiguousarray(vals, np.uint32).copy()
    _same_length(ok, ov)
    tk, tv = np.empty_like(ok), np.empty_like(ov)
    lib().rt_lsd_sort_pairs_u64(_p64(ok), _p32(ov), _p64(tk), _p32(tv),
                                ok.shape[0])
    return ok, ov


def verify_sorted_u64(keys: np.ndarray) -> int:
    """-1 if ascending, else the first violating index (threaded)."""
    a = np.ascontiguousarray(keys, np.uint64)
    return int(lib().rt_verify_sorted_u64(_p64(a), a.shape[0]))


def compare_u64(a: np.ndarray, b: np.ndarray) -> int:
    """-1 if bit-identical, else the first differing index (threaded)."""
    aa = np.ascontiguousarray(a, np.uint64)
    bb = np.ascontiguousarray(b, np.uint64)
    _same_length(aa, bb)
    return int(lib().rt_compare_u64(_p64(aa), _p64(bb), aa.shape[0]))


def _merge_inputs(runs, vruns, out, vout):
    """The runs as contiguous u32 arrays, checked against each other and
    against the destinations; returns (runs, vruns, n)."""
    runs = [np.ascontiguousarray(r, np.uint32) for r in runs]
    n = int(sum(r.shape[0] for r in runs))
    if vruns is not None:
        if len(vruns) != len(runs):
            raise ValueError("one payload run per key run")
        vruns = [np.ascontiguousarray(v).view(np.uint32) for v in vruns]
        for r, v in zip(runs, vruns):
            if v.shape[0] != r.shape[0]:
                raise ValueError("payload run length mismatch")
    if out is not None and (out.dtype != np.uint32 or out.shape[0] != n):
        raise ValueError(f"out must be uint32[{n}]")
    if vout is not None and (vout.dtype != np.uint32 or vout.shape[0] != n):
        raise ValueError(f"vout must be uint32[{n}]")
    return runs, vruns, n


def kway_merge_u32(runs, vruns=None, out=None, vout=None):
    """Stable threaded k-way merge of ascending u32 runs (the host half of
    the external sort). Equal keys keep run order (run-major), so merging
    chunks sorted in input order gives a stable sort of the whole input.

    runs: list of ascending u32 arrays. vruns: optional matching list of
    4-byte payload arrays, merged as u32 bits. out / vout: optional
    preallocated u32 destinations (an ``np.memmap`` for the disk-spill
    sort), written through. Returns the merged keys, and the merged
    payloads (u32) when vruns is given."""
    runs, vruns, n = _merge_inputs(runs, vruns, out, vout)
    k = len(runs)
    L = lib()
    if out is None:
        out = np.empty(n, np.uint32)
    run_ptrs = (_U32P * k)(*[_p32(r) for r in runs])
    lens = (ctypes.c_int64 * k)(*[r.shape[0] for r in runs])
    if vruns is None:
        L.rt_kway_merge_u32(run_ptrs, lens, k, n, _p32(out),
                            ctypes.cast(None, ctypes.POINTER(_U32P)),
                            ctypes.cast(None, _U32P))
        return out
    if vout is None:
        vout = np.empty(n, np.uint32)
    vptrs = (_U32P * k)(*[_p32(v) for v in vruns])
    L.rt_kway_merge_u32(run_ptrs, lens, k, n, _p32(out), vptrs, _p32(vout))
    return out, vout


def kway_merge_u32_plain(runs, vruns=None, out=None, vout=None):
    """The plain version of :func:`kway_merge_u32`, same contract: a numpy
    stable argsort of the concatenated runs."""
    runs, vruns, n = _merge_inputs(runs, vruns, out, vout)
    ck = np.concatenate(runs) if runs else np.empty(0, np.uint32)
    perm = np.argsort(ck, kind="stable")
    mk = ck[perm]
    if out is not None:
        out[:] = mk
        mk = out
    if vruns is None:
        return mk
    mv = np.concatenate(vruns)[perm] if vruns else np.empty(0, np.uint32)
    if vout is not None:
        vout[:] = mv
        mv = vout
    return mk, mv
