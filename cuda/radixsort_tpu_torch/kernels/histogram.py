"""All-digit histograms: one read of the keys gives the histogram of every
``width``-bit digit position (stage s = bits [width*s, width*(s+1))).

Counterpart of ``cuda/radixsort_tpu/kernels/histogram.py``. Two entry
points run on the same kernel (``csrc/histogram.cu``):
:func:`digit_histograms`, the JAX package's function on one key column, and
:func:`limb_histograms`, every limb column of one sort in one launch, each
masked to its bit range as the JAX pipeline masks it
(``cuda/radixsort_tpu/kernels/pipeline.py``). On a CUDA tensor they launch
the hand-written kernel; on a CPU tensor they run their plain versions.
There is no other route.
"""

from __future__ import annotations

import ctypes

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch.utils import build

WIDTHS = (2, 4, 8)
THREADS = 1024  # a block of the kernel: 32 warps over one table

LAUNCHES = 0  # kernel launches made by digit_histograms and limb_histograms

_SMS: dict[int, int] = {}  # device index -> streaming multiprocessors


def _check_keys(keys: torch.Tensor) -> None:
    if keys.dtype != torch.uint32:
        raise TypeError(f"keys must be torch.uint32; got {keys.dtype}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")


def _check(keys: torch.Tensor, n_stages: int, width: int) -> None:
    _check_keys(keys)
    if width not in WIDTHS:
        raise ValueError(f"width must be one of {WIDTHS}; got {width}")
    if not (1 <= n_stages and n_stages * width <= 32):
        raise ValueError(f"need 1 <= n_stages and n_stages * width <= 32; "
                         f"got n_stages={n_stages}, width={width}")


def digits(keys: torch.Tensor, shift: int, width: int) -> torch.Tensor:
    """(key >> shift) & (2^width - 1) of u32 keys, as int64 (plain torch:
    the u32 bits are widened to int64, since CPU torch does not shift u32)."""
    k = keys.reshape(-1).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return (k >> shift) & ((1 << width) - 1)


def _stage_counts(keys: torch.Tensor, n_stages: int, width: int,
                  mask: int = 0xFFFFFFFF) -> torch.Tensor:
    """torch.bincount of each stage's digit of keys & mask."""
    nb = 1 << width
    k = keys.reshape(-1).view(torch.int32).to(torch.int64) & mask
    rows = [torch.bincount((k >> (width * s)) & (nb - 1), minlength=nb)
            for s in range(n_stages)]
    return torch.stack(rows).to(torch.int32)


def digit_histograms_plain(keys: torch.Tensor, *, n_stages: int = 8,
                           width: int = 4) -> torch.Tensor:
    """Plain PyTorch version: torch.bincount per stage."""
    _check(keys, n_stages, width)
    return _stage_counts(keys, n_stages, width)


def limb_stages(limb_bits, width: int) -> list[tuple[int, int]]:
    """(mask, n_stages) of each limb's histogram, as the JAX pipeline takes
    it: a width-aligned range [begin, end) counts the limb as it is, any
    other range the limb & bits [begin, end); ceil(end / width) stages, none
    for an empty range."""
    out = []
    for begin, end in limb_bits:
        if begin >= end:
            out.append((0, 0))
        elif begin % width == 0 and end % width == 0:
            out.append((0xFFFFFFFF, -(-end // width)))
        else:
            out.append((((1 << end) - 1) & ~((1 << begin) - 1),
                        -(-end // width)))
    return out


def _check_limbs(limbs, limb_bits, width: int) -> None:
    if not limbs or len(limbs) != len(limb_bits):
        raise ValueError("need one (begin, end) bit range per limb column")
    if width not in WIDTHS:
        raise ValueError(f"width must be one of {WIDTHS}; got {width}")
    for t in limbs:
        _check_keys(t)
        if t.shape != limbs[0].shape or t.device != limbs[0].device:
            raise ValueError("limb columns must share one shape and device")
    for begin, end in limb_bits:
        if not 0 <= begin <= 32 or not 0 <= end <= 32:
            raise ValueError(f"bit range ({begin}, {end}) outside [0, 32]")


def limb_histograms_plain(limbs, limb_bits, width: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`limb_histograms`: the plain
    histogram of each masked limb, stacked."""
    _check_limbs(limbs, limb_bits, width)
    rows = [_stage_counts(t, stages, width, mask)
            for t, (mask, stages) in zip(limbs, limb_stages(limb_bits, width))
            if stages]
    if not rows:
        return torch.zeros((0, 1 << width), dtype=torch.int32,
                           device=limbs[0].device)
    return torch.cat(rows)


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _launch(cols, masks, stages, width: int) -> torch.Tensor:
    """The kernel over key columns of one length, each with its mask and
    stage count (>= 1): (sum(stages), 2^width) int32, one launch per
    HIST_MAX_LIMBS columns. A column counts 256 bins for each byte its
    stages cover."""
    global LAUNCHES
    lib = build.library()
    dev, n, nb = cols[0].device, cols[0].numel(), 1 << width
    out = torch.empty((sum(stages), nb), dtype=torch.int32, device=dev)
    if n == 0:
        return out.zero_()
    sms = _sm_count(dev)
    row = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, len(cols), config_lib.HIST_MAX_LIMBS):
            part = slice(c0, c0 + config_lib.HIST_MAX_LIMBS)
            n_rows = sum(stages[part])
            byte_bins = sum(-(-st * width // 8) * 256 for st in stages[part])
            table_bins = min(byte_bins, config_lib.HIST_TABLE_BINS)
            per_sm = max(1, (config_lib.SMEM_BYTES + 1024)
                         // (table_bins * 32 * 4 + 1024))
            grid = max(1, min(-(-n // (16 * THREADS)), min(per_sm, 2) * sms))
            # the ticket counter and the byte bins: every launch leaves them
            # zero
            scratch = build.stream_scratch("histogram", dev, stream,
                                           1 + byte_bins, torch.int32)
            ptrs = build.ptr_array(cols[part])
            k = len(ptrs)
            err = lib.rs_limb_histograms(
                ctypes.cast(ptrs, ctypes.c_void_p),
                ctypes.cast((ctypes.c_uint32 * k)(*masks[part]),
                            ctypes.c_void_p),
                ctypes.cast((ctypes.c_int * k)(*stages[part]), ctypes.c_void_p),
                k, n, width, out[row:row + n_rows].data_ptr(),
                scratch.data_ptr(), table_bins, grid, THREADS, stream)
            build.check(err, "limb_histograms")
            LAUNCHES += 1
            row += n_rows
    return out


def limb_histograms(limbs, limb_bits, width: int) -> torch.Tensor:
    """Every stage histogram of the u32 limb columns of one sort, from one
    read of the keys (one launch for up to HIST_MAX_LIMBS columns).

    limbs: (N,) contiguous torch.uint32 columns, any offsets; limb_bits[k] =
    (begin, end), the bits of limb k that take part in the order. Returns
    (sum of n_stages, 2^width) int32: limb by limb, ceil(end / width) rows
    each (none for begin >= end), row s the digit counts of stage s of the
    limb masked as :func:`limb_stages` says. The counts are u32 bits (a
    digit of 2^31 keys reads negative as int32; :func:`counts64`)."""
    if limbs and limbs[0].device.type == "cpu":
        return limb_histograms_plain(limbs, limb_bits, width)
    _check_limbs(limbs, limb_bits, width)
    if limbs[0].device.type != "cuda":
        raise ValueError(f"unsupported device {limbs[0].device}")
    picked = [(t, m, s) for t, (m, s) in
              zip(limbs, limb_stages(limb_bits, width)) if s]
    if not picked:
        return torch.zeros((0, 1 << width), dtype=torch.int32,
                           device=limbs[0].device)
    cols, masks, stages = map(list, zip(*picked))
    return _launch(cols, masks, stages, width)


def digit_histograms(keys: torch.Tensor, *, n_stages: int = 8,
                     width: int = 4) -> torch.Tensor:
    """u32 keys (any shape, contiguous) -> (n_stages, 2^width) int32 counts.

    Stage s counts the digit (key >> width*s) & (2^width - 1)."""
    if keys.device.type == "cpu":
        return digit_histograms_plain(keys, n_stages=n_stages, width=width)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    _check(keys, n_stages, width)
    return _launch([keys.reshape(-1)], [0xFFFFFFFF], [n_stages], width)


def counts64(hist: torch.Tensor) -> torch.Tensor:
    """The counts of an int32 histogram as int64. The kernel counts in u32
    (a sort takes up to 2^31 rows, so one digit can count 2^31, which reads
    negative as int32)."""
    return hist.to(torch.int64) & 0xFFFFFFFF


def stage_bases(hist: torch.Tensor) -> torch.Tensor:
    """(n_stages, 2^width) histograms -> exclusive bucket bases per stage,
    as int32 holding u32 bits (a base can be 2^31)."""
    h = counts64(hist)
    return (torch.cumsum(h, dim=1) - h).to(torch.int32)
