"""One stable LSD counting pass over u32 planes.

Counterpart of ``cuda/radixsort_tpu/kernels/stage.py::partition_stage`` (and
of the in-tile rank in ``kernels/tiles.py``). Plane 0 holds the keys; the
pass orders every plane stably by the digit (key >> shift) & (2^width - 1),
placing bucket d at the global base ``gbase[d]``. On a CUDA tensor the
wrapper launches the hand-written onesweep kernel in ``csrc/stage.cu`` (one
launch per group of up to 8 planes); on a CPU tensor it runs
:func:`partition_stage_plain`. There is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch.kernels.histogram import WIDTHS, digits
from cuda.radixsort_tpu_torch.utils import build

LAUNCHES = 0  # calls of partition_stage that launched the stage kernel


def stage_smem_bytes(cfg: config_lib.SortConfig, width: int) -> int:
    """Shared memory of one block of the kernel, which the launch gives it
    (``csrc/stage.cu`` lays it out and traps if it is short): int64 offsets
    and a scan buffer, the tile's values (4 B a key) and digits (1 B), the
    per-warp digit counts and the digits' counts and starts."""
    tile, nb = cfg.tile_elems, 1 << width
    return (nb * 8 + 32 * 8 + tile * 4 + (cfg.block_threads // 32) * nb * 4
            + nb * 8 + 16 + tile)


def stage_scratch(n: int, cfg: config_lib.SortConfig,
                  width: int) -> tuple[int, int]:
    """(n_tiles, status words) of one pass: a tile claim counter and one
    64-bit lookback status word per (tile, digit)."""
    n_tiles = -(-n // cfg.tile_elems)
    return n_tiles, 1 + n_tiles * (1 << width)


def _check(planes, gbase, shift, width, out):
    if not planes:
        raise ValueError("need at least the key plane")
    dev, shape = planes[0].device, planes[0].shape
    for p in planes:
        if p.dtype != torch.uint32:
            raise TypeError(f"planes must be torch.uint32; got {p.dtype}")
        if p.device != dev or p.shape != shape:
            raise ValueError("planes must share one device and one shape")
        if not p.is_contiguous():
            raise ValueError("planes must be contiguous")
    if width not in WIDTHS:
        raise ValueError(f"width must be one of {WIDTHS}; got {width}")
    if not 0 <= shift <= 32 - width:
        raise ValueError(f"shift must be in [0, {32 - width}]; got {shift}")
    if (gbase.dtype != torch.int32 or gbase.shape != (1 << width,)
            or gbase.device != dev or not gbase.is_contiguous()):
        raise ValueError(f"gbase must be contiguous int32 of shape "
                         f"({1 << width},) on {dev}")
    if out is not None:
        if len(out) != len(planes):
            raise ValueError("need one output per plane")
        ins = {p.data_ptr() for p in planes}
        for o in out:
            if (o.dtype != torch.uint32 or o.shape != shape
                    or o.device != dev or not o.is_contiguous()):
                raise ValueError("outputs must match the planes")
            if o.data_ptr() in ins and o.numel():
                raise ValueError("outputs must not alias the inputs")


def partition_stage_plain(planes, gbase, *, shift: int, width: int = 4,
                          out=None):
    """Plain PyTorch version: a stable torch.sort of the digits, then each
    element goes to gbase[d] + its rank among the keys of digit d."""
    _check(planes, gbase, shift, width, out)
    d = digits(planes[0], shift, width)
    n = d.numel()
    order = torch.sort(d, stable=True).indices
    ds = d[order]
    counts = torch.bincount(d, minlength=1 << width)
    starts = torch.cumsum(counts, 0) - counts
    dest = ((gbase.to(torch.int64) & 0xFFFFFFFF)[ds] - starts[ds]
            + torch.arange(n, device=d.device))
    if out is None:
        out = [torch.empty_like(p) for p in planes]
    for p, o in zip(planes, out):
        o.view(torch.int32).reshape(-1)[dest] = (
            p.view(torch.int32).reshape(-1)[order])
    return list(out)


def partition_stage(planes, gbase, *, shift: int, width: int = 4, out=None,
                    config: config_lib.SortConfig | None = None):
    """One stable ``width``-bit counting pass.

    planes: list of equal-shape contiguous torch.uint32 tensors, keys first.
    gbase: (2^width,) int32 exclusive bucket bases of the key digits (the
    exclusive cumsum of the digit histogram). width: 2, 4 or 8.
    out: optional list of output tensors (same shapes, not aliasing the
    inputs); allocated when None. config: tile geometry (default: preset).
    Returns the permuted planes.
    """
    global LAUNCHES
    planes = list(planes)
    if planes and planes[0].device.type == "cpu":
        return partition_stage_plain(planes, gbase, shift=shift, width=width,
                                     out=out)
    _check(planes, gbase, shift, width, out)
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    cfg = config or config_lib.preset()
    lib = build.library()
    if out is None:
        out = [torch.empty_like(p) for p in planes]
    out = list(out)
    n = planes[0].numel()
    if n == 0:
        return out
    _, words = stage_scratch(n, cfg, width)
    status = torch.empty(words, dtype=torch.int64, device=dev)  # zeroed by C
    ins, outs = build.ptr_array(planes), build.ptr_array(out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rs_partition_stage(
            ctypes.cast(ins, ctypes.c_void_p),
            ctypes.cast(outs, ctypes.c_void_p), len(planes),
            gbase.data_ptr(), n, shift, width, status.data_ptr(),
            cfg.block_threads, cfg.items_per_thread,
            stage_smem_bytes(cfg, width), stream)
    build.check(err, "partition_stage")
    LAUNCHES += 1
    return out
