"""External (out-of-core) sorts and join: inputs larger than the card.

Counterpart of ``cuda/radixsort_tpu/ops/external.py``. The card sorts
chunks of ``chunk`` rows through the port's ``sort`` / ``sort_pairs`` (the
radix kernels), and the host's threaded k-way merge
(``utils/native.py::kway_merge_u32``, ``csrc/hostutils.cpp``) combines the
sorted runs. Chunks are taken in input order and the merge breaks key ties
by run, so the whole is a stable sort. Host RAM is the limit, not the
card's memory; the ``*_file`` forms memory-map their inputs, spill each
sorted run to a file and merge into a memory-mapped output, so the page
cache is the working set.

Numpy in, numpy out. The device side runs on the card unless the caller
passes ``device="cpu"``. Chunks move between host and card through pinned
host buffers; every round trip ends in a blocking copy back to the host
(or, for the join's count, a read of it), which orders the next write
into a buffer after the previous copy out of it.

``timings``: an optional dict; each call adds its seconds to the keys
'h2d' (host to card copies), 'device' (sorts or joins on the card), 'd2h'
(card to host copies) and 'merge' (the host merge), synchronising the card
between the parts. Without it nothing extra synchronises.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch.ops.join import join as _join
from cuda.radixsort_tpu_torch.ops.sort import sort as _sort
from cuda.radixsort_tpu_torch.ops.sort import sort_pairs as _sort_pairs
from cuda.radixsort_tpu_torch.utils import native
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy
from cuda.radixsort_tpu_torch.utils.profiling import traced

_PARTS = ("h2d", "device", "d2h", "merge")


class _Mover:
    """Moves 4-byte host arrays to the device and back as u32 bits, and
    adds each part's seconds to ``timings`` when one is given."""

    def __init__(self, device, timings: dict | None):
        self.device = torch.device(device)
        self.timings = timings
        if timings is not None:
            for part in _PARTS:
                timings.setdefault(part, 0.0)
        self._pinned: dict = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def part(self, name: str):
        if self.timings is None:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.timings[name] += time.perf_counter() - t0

    def _staging(self, slot: str, rows: int) -> torch.Tensor:
        """The pinned int32 host buffer of ``slot``, at least ``rows`` long."""
        buf = self._pinned.get(slot)
        if buf is None or buf.numel() < rows:
            buf = self._pinned[slot] = torch.empty(rows, dtype=torch.int32,
                                                   pin_memory=True)
        return buf[:rows]

    def to_device(self, a: np.ndarray, slot: str = "k") -> torch.Tensor:
        """A u32 tensor on the device with the bits of 4-byte array ``a``."""
        a32 = np.ascontiguousarray(a).view(np.int32)
        with self.part("h2d"):
            if self.device.type != "cuda":
                t = torch.from_numpy(a32.copy())
            else:
                buf = self._staging(slot, a32.shape[0])
                buf.numpy()[:] = a32
                t = buf.to(self.device, non_blocking=True)
        return t.view(torch.uint32)

    def to_host(self, t: torch.Tensor, out: np.ndarray | None = None
                ) -> np.ndarray:
        """The bits of 4-byte tensor ``t`` as a u32 array (into ``out``)."""
        t32 = t.view(torch.int32)
        with self.part("d2h"):
            if t32.device.type != "cuda":
                a = t32.numpy().view(np.uint32)
            else:  # through the pinned buffer: a blocking DMA, then a copy
                buf = self._staging("out", t32.shape[0])
                buf.copy_(t32)
                a = buf.numpy().view(np.uint32)
                if out is None:
                    out = np.empty(a.shape[0], np.uint32)
            if out is not None:
                out[:] = a
                a = out
        return a

    def merge(self, *args, **kw):
        with self.part("merge"):
            return native.kway_merge_u32(*args, **kw)


def _check_u32(name: str, keys: np.ndarray) -> None:
    if keys.dtype != np.uint32:
        raise TypeError(f"{name}: u32 keys (twiddle wider dtypes into limbs "
                        f"or use sort_external_pairs); got {keys.dtype}")


def _check_payload(name: str, keys: np.ndarray, values: np.ndarray) -> None:
    if values.dtype.itemsize != 4:
        raise TypeError(f"{name}: 4-byte payload dtype; got {values.dtype}")
    if values.shape[0] != keys.shape[0]:
        raise ValueError(f"{name}: {values.shape[0]} values for "
                         f"{keys.shape[0]} keys")


def _check_chunk(chunk: int) -> None:
    if chunk < 1:
        raise ValueError(f"chunk must be positive; got {chunk}")


@traced
def sort_external(
    keys: np.ndarray,
    *,
    chunk: int = 1 << 27,
    config: config_lib.SortConfig | None = None,
    device="cuda",
    timings: dict | None = None,
) -> np.ndarray:
    """Ascending sort of a host u32 array of any size that fits host RAM.

    chunk: rows sorted on the card per round trip (default 2^27: 512 MiB of
    keys, a few times that with the sort's buffers)."""
    _check_u32("sort_external", keys)
    _check_chunk(chunk)
    mv = _Mover(device, timings)
    n = keys.shape[0]
    runs = []
    for lo in range(0, max(n, 1), chunk):
        piece = mv.to_device(keys[lo: lo + chunk])
        with mv.part("device"):
            s = _sort(piece, config=config)
        runs.append(mv.to_host(s))
    if len(runs) == 1:
        return runs[0]
    return mv.merge(runs)


@traced
def sort_external_pairs(
    keys: np.ndarray,
    values: np.ndarray,
    *,
    chunk: int = 1 << 26,
    config: config_lib.SortConfig | None = None,
    device="cuda",
    timings: dict | None = None,
):
    """Stable key-value external sort (u32 keys, 4-byte payload). Returns
    (keys, values), the values in their own dtype."""
    _check_u32("sort_external_pairs", keys)
    _check_payload("sort_external_pairs", keys, values)
    _check_chunk(chunk)
    mv = _Mover(device, timings)
    n = keys.shape[0]
    kruns, vruns = [], []
    for lo in range(0, max(n, 1), chunk):
        k = mv.to_device(keys[lo: lo + chunk], "k")
        v = mv.to_device(values[lo: lo + chunk], "v")
        with mv.part("device"):
            ok, ov = _sort_pairs(k, v, config=config)
        kruns.append(mv.to_host(ok))
        vruns.append(mv.to_host(ov))
    if len(kruns) == 1:
        mk, mvals = kruns[0], vruns[0]
    else:
        mk, mvals = mv.merge(kruns, vruns)
    return mk, mvals.view(values.dtype)


def _remove_quietly(paths, tdir: str) -> None:
    for p in paths:
        with contextlib.suppress(OSError):
            os.remove(p)
    with contextlib.suppress(OSError):
        os.rmdir(tdir)


def _u32_file_rows(path: str) -> int:
    size = os.path.getsize(path)
    if size % 4:
        raise ValueError(f"{path}: size {size} is not a u32 multiple")
    return size // 4


def _memmap_out(path: str, n: int) -> np.ndarray:
    if n == 0:  # numpy cannot map an empty file
        open(path, "wb").close()
        return np.zeros(0, np.uint32)
    return np.memmap(path, dtype=np.uint32, mode="w+", shape=(n,))


def _memmap_in(path: str, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, np.uint32)
    return np.memmap(path, dtype=np.uint32, mode="r")


def _flush(a: np.ndarray) -> None:
    if isinstance(a, np.memmap):
        a.flush()


@traced
def sort_external_file(
    in_path: str,
    out_path: str,
    *,
    chunk: int = 1 << 27,
    tmpdir: str | None = None,
    config: config_lib.SortConfig | None = None,
    device="cuda",
    timings: dict | None = None,
) -> int:
    """Disk-spill external sort: u32 keys stored as raw little-endian binary
    at ``in_path``, ascending result written to ``out_path``. The input may
    exceed host RAM: it is memory-mapped, each sorted chunk spills to a run
    file (under ``tmpdir``), and the native merge streams the runs into a
    memory-mapped output. Run files are removed however the call ends.
    Returns the row count."""
    _check_chunk(chunk)
    n = _u32_file_rows(in_path)
    src = _memmap_in(in_path, n)
    mv = _Mover(device, timings)
    if n <= chunk:
        out = _memmap_out(out_path, n)
        piece = mv.to_device(src)
        with mv.part("device"):
            s = _sort(piece, config=config)
        mv.to_host(s, out=out)
        _flush(out)
        return n
    tdir = tempfile.mkdtemp(dir=tmpdir, prefix="radixsort_runs_")
    run_paths = []
    try:
        for i, lo in enumerate(range(0, n, chunk)):
            piece = mv.to_device(src[lo: lo + chunk])
            with mv.part("device"):
                s = _sort(piece, config=config)
            rp = os.path.join(tdir, f"run{i:05d}.u32")
            run_paths.append(rp)
            run = _memmap_out(rp, s.shape[0])
            mv.to_host(s, out=run)
            _flush(run)
            del run
        runs = [_memmap_in(rp, min(chunk, n - i * chunk))
                for i, rp in enumerate(run_paths)]
        out = _memmap_out(out_path, n)
        mv.merge(runs, out=out)
        _flush(out)
        del runs, out
    finally:
        _remove_quietly(run_paths, tdir)
    return n


@traced
def sort_external_pairs_file(
    keys_path: str,
    values_path: str,
    out_keys_path: str,
    out_values_path: str,
    *,
    chunk: int = 1 << 26,
    tmpdir: str | None = None,
    config: config_lib.SortConfig | None = None,
    device="cuda",
    timings: dict | None = None,
) -> int:
    """Disk-spill stable key-value external sort (u32 keys and a 4-byte
    payload as raw binary files): the pairs form of
    :func:`sort_external_file`. Returns the row count."""
    _check_chunk(chunk)
    ksize, vsize = os.path.getsize(keys_path), os.path.getsize(values_path)
    if ksize % 4 or vsize != ksize:
        raise ValueError("keys/values files must be equal-length u32-"
                         f"multiples (got {ksize} / {vsize} bytes)")
    n = ksize // 4
    ksrc, vsrc = _memmap_in(keys_path, n), _memmap_in(values_path, n)
    mv = _Mover(device, timings)
    if n <= chunk:
        k, v = mv.to_device(ksrc, "k"), mv.to_device(vsrc, "v")
        with mv.part("device"):
            ok, ov = _sort_pairs(k, v, config=config)
        for t, path in ((ok, out_keys_path), (ov, out_values_path)):
            out = _memmap_out(path, n)
            mv.to_host(t, out=out)
            _flush(out)
        return n
    tdir = tempfile.mkdtemp(dir=tmpdir, prefix="radixsort_pruns_")
    paths = []
    try:
        for i, lo in enumerate(range(0, n, chunk)):
            m = min(chunk, n - lo)
            k = mv.to_device(ksrc[lo: lo + m], "k")
            v = mv.to_device(vsrc[lo: lo + m], "v")
            with mv.part("device"):
                ok, ov = _sort_pairs(k, v, config=config)
            pair = (os.path.join(tdir, f"k{i:05d}.u32"),
                    os.path.join(tdir, f"v{i:05d}.u32"))
            paths += pair
            for t, path in zip((ok, ov), pair):
                run = _memmap_out(path, m)
                mv.to_host(t, out=run)
                _flush(run)
                del run
        sizes = [min(chunk, n - lo) for lo in range(0, n, chunk)]
        kruns = [_memmap_in(p, m) for p, m in zip(paths[0::2], sizes)]
        vruns = [_memmap_in(p, m) for p, m in zip(paths[1::2], sizes)]
        kout = _memmap_out(out_keys_path, n)
        vout = _memmap_out(out_values_path, n)
        mv.merge(kruns, vruns, out=kout, vout=vout)
        _flush(kout)
        _flush(vout)
        del kruns, vruns, kout, vout
    finally:
        _remove_quietly(paths, tdir)
    return n


def _fold_u32(t: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Sum of t's live rows, wrapped to 32 bits, as an int64 0-d tensor:
    u32 keys by their bits, other dtypes converted to int32 first (as the
    reference's sum with dtype int32 converts them)."""
    if t.dtype == torch.uint32:
        w = t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    else:
        w = t.to(torch.int32).to(torch.int64)
    return torch.where(live, w, 0).sum() & 0xFFFFFFFF


@traced
def join_external(
    build_keys: np.ndarray,
    build_vals: np.ndarray,
    probe_keys: np.ndarray,
    *,
    chunk: int = 1 << 27,
    materialize: bool = True,
    config: config_lib.SortConfig | None = None,
    device="cuda",
    timings: dict | None = None,
):
    """Out-of-core FK inner join: the build side stays on the card, the
    probe side streams through in ``chunk``-row slices, each an inner
    :func:`join` of (build rows + slice rows).

    materialize=True returns (keys, vals, probe_idx, count) as host arrays,
    the slices' matches in slice order (probe_idx global, int32).
    materialize=False copies no result rows back and returns (count,
    checksum_u32): per slice, the 32-bit sum of the matched keys XOR the
    32-bit sum of their build values (as int32), XORed over the slices."""
    if probe_keys.dtype != np.uint32 or build_keys.dtype != np.uint32:
        raise TypeError("join_external: u32 keys")
    if build_vals.shape[0] != build_keys.shape[0]:
        raise ValueError("join_external: one build value per build key")
    _check_chunk(chunk)
    nprobe = probe_keys.shape[0]
    if nprobe > (1 << 31):
        raise ValueError(f"join_external: probe_idx is int32, so at most 2^31 "
                         f"probe rows; got {nprobe}")
    dev = torch.device(device)
    mv = _Mover(dev, timings)
    bk = mv.to_device(build_keys, "b")
    with mv.part("h2d"):
        bv = from_numpy(build_vals, dev)
    total = 0
    checksum = np.uint32(0)
    out_k, out_v, out_i = [], [], []
    for lo in range(0, nprobe, chunk):
        pk = mv.to_device(probe_keys[lo: lo + chunk], "p")
        with mv.part("device"):
            ok, ov, oi, cnt = _join(bk, bv, pk, how="inner", config=config)
            if not materialize:
                live = torch.arange(ok.shape[0], device=dev) < cnt
                fold = _fold_u32(ok, live) ^ _fold_u32(ov, live)
        if materialize:
            c = int(cnt)
            out_k.append(mv.to_host(ok[:c]))
            with mv.part("d2h"):
                out_v.append(to_numpy(ov[:c]))
                out_i.append(to_numpy(oi[:c] + lo))
            total += c
        else:
            c, f = torch.stack([cnt.to(torch.int64), fold]).tolist()
            total += c
            checksum ^= np.uint32(f)
    if materialize:
        return (np.concatenate(out_k) if out_k else np.zeros((0,), np.uint32),
                np.concatenate(out_v) if out_v
                else np.zeros((0,), build_vals.dtype),
                np.concatenate(out_i) if out_i else np.zeros((0,), np.int32),
                total)
    return total, checksum
