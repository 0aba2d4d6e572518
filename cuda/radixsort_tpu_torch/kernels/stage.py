"""One stable LSD counting pass over u32 and 8-byte columns.

Counterpart of ``cuda/radixsort_tpu/kernels/stage.py::partition_stage`` (and
of the in-tile rank in ``kernels/tiles.py``). Column 0 holds the keys; the
pass orders every column stably by the digit (key >> shift) & (2^width -
1), placing bucket d at the global base ``gbase[d]``. On a CUDA tensor the
wrapper launches the hand-written onesweep kernel in ``csrc/stage.cu`` (one
launch per group of up to 8 columns); on a CPU tensor it runs
:func:`partition_stage_plain`. There is no other route.

A column is contiguous, torch.uint32 or 8 bytes wide; the kernel moves an
8-byte column's rows as 8-byte words, and an 8-byte key's digit may lie in
either of its words.
"""

from __future__ import annotations

import ctypes

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch.kernels.histogram import (WIDTHS, check_column,
                                                        digits, signed_words)
from cuda.radixsort_tpu_torch.utils import build

LAUNCHES = 0  # calls of partition_stage that launched the stage kernel
BYTES = 0  # stage_bytes of those calls


def stage_bytes(n: int, planes: int) -> int:
    """The least memory traffic of one pass: each of ``planes`` u32 planes
    of ``n`` rows read once and written once (an 8-byte column counts as
    two planes)."""
    return 8 * n * planes


def stage_smem_bytes(cfg: config_lib.SortConfig, width: int,
                     paired: bool = False) -> int:
    """Shared memory of one block of the kernel, which the launch gives it
    (``csrc/stage.cu`` lays it out in this order and traps if it is short):
    the digits' int64 global offsets, the block scan's 32 int64 words, the
    tile's values (4 B a key; 8 B in a pass with an 8-byte column,
    ``paired``), each warp's per-digit counts (then its slots), the digits'
    counts and starts, the tile index (4 ints) and the tile's digits
    (1 B a key)."""
    tile, nb, warps = cfg.tile_elems, 1 << width, cfg.block_threads // 32
    return (8 * nb + 8 * 32 + (8 if paired else 4) * tile + 4 * warps * nb
            + 4 * nb + 4 * nb + 4 * 4 + tile)


def stage_scratch(n: int, cfg: config_lib.SortConfig,
                  width: int) -> tuple[int, int]:
    """(n_tiles, status words) of one pass: a tile claim counter and one
    64-bit lookback status word per (tile, digit)."""
    n_tiles = -(-n // cfg.tile_elems)
    return n_tiles, 1 + n_tiles * (1 << width)


def _check(columns, gbase, shift, width, out) -> None:
    if not columns:
        raise ValueError("need at least the key column")
    dev, shape = columns[0].device, columns[0].shape
    for c in columns:
        check_column(c)
        if c.device != dev or c.shape != shape:
            raise ValueError("columns must share one device and one shape")
    if width not in WIDTHS:
        raise ValueError(f"width must be one of {WIDTHS}; got {width}")
    bits = 8 * columns[0].element_size()
    if not 0 <= shift <= bits - width:
        raise ValueError(f"shift must be in [0, {bits - width}]; got {shift}")
    if (gbase.dtype != torch.int32 or gbase.shape != (1 << width,)
            or gbase.device != dev or not gbase.is_contiguous()):
        raise ValueError(f"gbase must be contiguous int32 of shape "
                         f"({1 << width},) on {dev}")
    if out is None:
        return
    if len(out) != len(columns):
        raise ValueError("need one output per column")
    ins = {c.data_ptr() for c in columns}
    for c, o in zip(columns, out):
        if (o.dtype != c.dtype or o.shape != shape or o.device != dev
                or not o.is_contiguous()):
            raise ValueError("outputs must match the columns")
        if o.data_ptr() in ins and o.numel():
            raise ValueError("outputs must not alias the inputs")


def partition_stage_plain(columns, gbase, *, shift: int, width: int = 4,
                          out=None):
    """Plain PyTorch version: a stable torch.sort of the digits, then each
    row goes to gbase[d] + its rank among the keys of digit d."""
    _check(columns, gbase, shift, width, out)
    d = digits(columns[0], shift, width)
    n = d.numel()
    order = torch.sort(d, stable=True).indices
    ds = d[order]
    counts = torch.bincount(d, minlength=1 << width)
    starts = torch.cumsum(counts, 0) - counts
    dest = ((gbase.to(torch.int64) & 0xFFFFFFFF)[ds] - starts[ds]
            + torch.arange(n, device=d.device))
    if out is None:
        out = [torch.empty_like(c) for c in columns]
    for c, o in zip(columns, out):
        signed_words(o).reshape(-1)[dest] = signed_words(c).reshape(-1)[order]
    return list(out)


def partition_stage(columns, gbase, *, shift: int, width: int = 4, out=None,
                    config: config_lib.SortConfig | None = None):
    """One stable ``width``-bit counting pass.

    columns: list of equal-shape contiguous columns, keys first, each
    torch.uint32 or 8 bytes wide (moved as 8-byte words). shift: the
    digit's first bit, in [0, 32 - width] for a u32 key and [0, 64 - width]
    for an 8-byte one. gbase: (2^width,) int32 exclusive bucket bases of
    the key digits (the exclusive cumsum of the digit histogram). width: 2,
    4 or 8. out: optional list of output tensors (the columns' dtypes and
    shapes, contiguous, not aliasing the inputs); allocated when None.
    config: tile geometry (default: preset). Returns the permuted columns.
    """
    global LAUNCHES, BYTES
    columns = list(columns)
    if columns and columns[0].device.type == "cpu":
        return partition_stage_plain(columns, gbase, shift=shift, width=width,
                                     out=out)
    _check(columns, gbase, shift, width, out)
    dev = columns[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    cfg = config or config_lib.preset()
    lib = build.library()
    out = (list(out) if out is not None
           else [torch.empty_like(c) for c in columns])
    n = columns[0].numel()
    if n == 0:
        return out
    wide = [int(c.element_size() == 8) for c in columns]
    key_half = shift // 32 if wide[0] else -1  # the key's word
    _, words = stage_scratch(n, cfg, width)
    status = torch.empty(words, dtype=torch.int64, device=dev)  # zeroed by C
    in_ptrs, out_ptrs = build.ptr_array(columns), build.ptr_array(out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rs_partition_stage(
            ctypes.cast(in_ptrs, ctypes.c_void_p),
            ctypes.cast(out_ptrs, ctypes.c_void_p),
            ctypes.cast((ctypes.c_int * len(wide))(*wide), ctypes.c_void_p),
            len(columns), key_half, gbase.data_ptr(), n, shift % 32, width,
            status.data_ptr(), cfg.block_threads, cfg.items_per_thread,
            stage_smem_bytes(cfg, width, paired=any(wide)), stream)
    build.check(err, "partition_stage")
    LAUNCHES += 1
    BYTES += stage_bytes(n, len(columns) + sum(wide))
    return out
