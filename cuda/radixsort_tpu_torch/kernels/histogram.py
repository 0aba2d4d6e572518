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


def _check(keys: torch.Tensor, n_stages: int, width: int) -> None:
    if keys.dtype != torch.uint32:
        raise TypeError(f"keys must be torch.uint32; got {keys.dtype}")
    check_column(keys)
    if width not in WIDTHS:
        raise ValueError(f"width must be one of {WIDTHS}; got {width}")
    if not (1 <= n_stages and n_stages * width <= 32):
        raise ValueError(f"need 1 <= n_stages and n_stages * width <= 32; "
                         f"got n_stages={n_stages}, width={width}")


def check_column(t: torch.Tensor) -> None:
    """A key or payload column of the LSD loop: contiguous, torch.uint32 or
    8 bytes wide (any 8-byte dtype; its words order as u64)."""
    if t.dtype != torch.uint32 and t.element_size() != 8:
        raise TypeError(f"a column must be torch.uint32 or 8 bytes wide; "
                        f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError("a column must be contiguous")


def signed_words(column: torch.Tensor) -> torch.Tensor:
    """The bits of a u32 or 8-byte column as an int32 or int64 view, which
    torch's operators all take."""
    return column.view(torch.int64 if column.element_size() == 8
                       else torch.int32)


def _values(column: torch.Tensor) -> torch.Tensor:
    """The bits of a u32 or 8-byte column as int64 (plain torch: CPU torch
    does not shift unsigned tensors)."""
    w = signed_words(column).reshape(-1)
    return w if w.dtype == torch.int64 else w.to(torch.int64) & 0xFFFFFFFF


def digits(keys: torch.Tensor, shift: int, width: int) -> torch.Tensor:
    """(key >> shift) & (2^width - 1) of a u32 or 8-byte key column, as
    int64."""
    return (_values(keys) >> shift) & ((1 << width) - 1)


def _stage_counts(keys: torch.Tensor, n_stages: int, width: int,
                  mask: int = 0xFFFFFFFF, base: int = 0) -> torch.Tensor:
    """torch.bincount of each stage's digit of the u32 word at bit ``base``
    of the keys, & mask."""
    nb = 1 << width
    k = (_values(keys) >> base) & mask
    rows = [torch.bincount((k >> (width * s)) & (nb - 1), minlength=nb)
            for s in range(n_stages)]
    return torch.stack(rows).to(torch.int32)


def digit_histograms_plain(keys: torch.Tensor, *, n_stages: int = 8,
                           width: int = 4) -> torch.Tensor:
    """Plain PyTorch version: torch.bincount per stage."""
    _check(keys, n_stages, width)
    return _stage_counts(keys, n_stages, width)


def limb_stages(limb_bits, width: int) -> list[tuple[int, int]]:
    """(mask, n_stages) of each u32 word's histogram, as the JAX pipeline
    takes it: a width-aligned range [begin, end) counts the word as it is,
    any other range the word & bits [begin, end); ceil(end / width)
    stages, none for an empty range."""
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


def word_ranges(column: torch.Tensor, begin: int,
                end: int) -> list[tuple[int, int]]:
    """Bits [begin, end) of a column as the ranges of its u32 words, high
    word first: one for a u32 column, two for an 8-byte one."""
    if column.element_size() == 4:
        return [(begin, end)]
    return [(max(begin, 32) - 32, max(end, 32) - 32),
            (min(begin, 32), min(end, 32))]


def _entries(limbs, limb_bits, width: int) -> list[tuple[int, int, int, int]]:
    """The kernel's words, limb by limb: (limb, half, mask, n_stages), half
    -1 for a u32 column with stages, 1 and 0 for the high and low words of
    an 8-byte column, which go in together where either has stages (the
    kernel reads the column once)."""
    out = []
    for k, (t, bits) in enumerate(zip(limbs, limb_bits)):
        words = limb_stages(word_ranges(t, *bits), width)
        if len(words) == 2 and (words[0][1] or words[1][1]):
            out += [(k, 1, *words[0]), (k, 0, *words[1])]
        elif len(words) == 1 and words[0][1]:
            out.append((k, -1, *words[0]))
    return out


def stage_rows(limbs, limb_bits, width: int) -> dict[tuple[int, int], int]:
    """{(limb k, shift): its row in :func:`limb_histograms`' result}: the
    histogram of bits [shift, shift + width) of limb k."""
    rows, row = {}, 0
    for k, half, _, st in _entries(limbs, limb_bits, width):
        for s in range(st):
            rows[k, 32 * max(half, 0) + width * s] = row + s
        row += st
    return rows


def _check_limbs(limbs, limb_bits, width: int) -> None:
    if not limbs or len(limbs) != len(limb_bits):
        raise ValueError("need one (begin, end) bit range per limb column")
    if width not in WIDTHS:
        raise ValueError(f"width must be one of {WIDTHS}; got {width}")
    for t, (begin, end) in zip(limbs, limb_bits):
        check_column(t)
        if t.shape != limbs[0].shape or t.device != limbs[0].device:
            raise ValueError("limb columns must share one shape and device")
        bits = 8 * t.element_size()
        if not 0 <= begin <= bits or not 0 <= end <= bits:
            raise ValueError(f"bit range ({begin}, {end}) outside [0, {bits}]")


def limb_histograms_plain(limbs, limb_bits, width: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`limb_histograms`: the plain
    histogram of each masked word, stacked."""
    _check_limbs(limbs, limb_bits, width)
    rows = [_stage_counts(limbs[k], st, width, mask, 32 * max(half, 0))
            for k, half, mask, st in _entries(limbs, limb_bits, width) if st]
    if not rows:
        return torch.zeros((0, 1 << width), dtype=torch.int32,
                           device=limbs[0].device)
    return torch.cat(rows)


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _launch(cols, masks, stages, width: int, half=None) -> torch.Tensor:
    """The kernel over words of columns of one length, each with its mask,
    stage count (>= 1, or >= 0 for a word of an 8-byte column) and half
    (-1 for a u32 column, or 1 then 0 for the high and low words of an
    8-byte column; default all -1): (sum(stages), 2^width) int32, one
    launch per HIST_MAX_LIMBS words (the two words of a column in one
    launch). A word counts 256 bins for each byte its stages cover."""
    global LAUNCHES
    lib = build.library()
    dev, n, nb = cols[0].device, cols[0].numel(), 1 << width
    half = half or [-1] * len(cols)
    out = torch.empty((sum(stages), nb), dtype=torch.int32, device=dev)
    if n == 0:
        return out.zero_()
    sms = _sm_count(dev)
    row, c0 = 0, 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        while c0 < len(cols):
            c1 = min(c0 + config_lib.HIST_MAX_LIMBS, len(cols))
            if c1 < len(cols) and half[c1 - 1] == 1:
                c1 -= 1  # keep the words of a column in one launch
            part = slice(c0, c1)
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
            k = c1 - c0
            ptrs = (ctypes.c_void_p * k)(*[  # the high word 4 bytes in
                c.data_ptr() + 4 * (h == 1)
                for c, h in zip(cols[part], half[part])])
            err = lib.rs_limb_histograms(
                ctypes.cast(ptrs, ctypes.c_void_p),
                ctypes.cast((ctypes.c_uint32 * k)(*masks[part]),
                            ctypes.c_void_p),
                ctypes.cast((ctypes.c_int * k)(*stages[part]), ctypes.c_void_p),
                ctypes.cast((ctypes.c_int * k)(*half[part]), ctypes.c_void_p),
                k, n, width, out[row:row + n_rows].data_ptr(),
                scratch.data_ptr(), table_bins, grid, THREADS, stream)
            build.check(err, "limb_histograms")
            LAUNCHES += 1
            row += n_rows
            c0 = c1
    return out


def limb_histograms(limbs, limb_bits, width: int) -> torch.Tensor:
    """Every stage histogram of the key columns of one sort, from one read
    of the keys (one launch for up to HIST_MAX_LIMBS words).

    limbs: (N,) contiguous columns, torch.uint32 or 8 bytes wide (read once
    as 8-byte words), any offsets; limb_bits[k] = (begin, end), the bits of
    limb k (of its 32 or 64) that take part in the order. Returns (rows,
    2^width) int32: limb by limb, an 8-byte column as its high word then
    its low word with its part of the range; ceil(end / width) rows for a
    word's range [begin, end) (none for an empty one), row s the digit
    counts of stage s of the word masked as :func:`limb_stages` says
    (:func:`stage_rows` finds a stage's row). The counts are u32 bits (a
    digit of 2^31 keys reads negative as int32; :func:`counts64`)."""
    if limbs and limbs[0].device.type == "cpu":
        return limb_histograms_plain(limbs, limb_bits, width)
    _check_limbs(limbs, limb_bits, width)
    if limbs[0].device.type != "cuda":
        raise ValueError(f"unsupported device {limbs[0].device}")
    entries = _entries(limbs, limb_bits, width)
    if not entries:
        return torch.zeros((0, 1 << width), dtype=torch.int32,
                           device=limbs[0].device)
    ks, half, masks, stages = map(list, zip(*entries))
    return _launch([limbs[k] for k in ks], masks, stages, width, half)


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
    return bases_and_maxima(hist)[0]


def bases_and_maxima(hist: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(:func:`stage_bases`, each stage's largest count as int64) from one
    widening of the counts."""
    h = counts64(hist)
    return (torch.cumsum(h, dim=1) - h).to(torch.int32), h.max(dim=1).values
