"""All-digit histogram: one read of the keys gives the histogram of every
``width``-bit digit position (stage s = bits [width*s, width*(s+1))).

Counterpart of ``cuda/radixsort_tpu/kernels/histogram.py``. On a CUDA tensor
the wrapper launches the hand-written kernel in ``csrc/histogram.cu``; on a
CPU tensor it runs :func:`digit_histograms_plain`. There is no other route.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch.utils import build

THREADS = 256  # 8 warps: the per-warp tables stay within 32 KB of shared memory
BLOCKS_PER_SM = 4
WIDTHS = (2, 4, 8)

LAUNCHES = 0  # kernel launches made by digit_histograms


def _check(keys: torch.Tensor, n_stages: int, width: int) -> None:
    if keys.dtype != torch.uint32:
        raise TypeError(f"keys must be torch.uint32; got {keys.dtype}")
    if not keys.is_contiguous():
        raise ValueError("keys must be contiguous")
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


def digit_histograms_plain(keys: torch.Tensor, *, n_stages: int = 8,
                           width: int = 4) -> torch.Tensor:
    """Plain PyTorch version: torch.bincount per stage."""
    _check(keys, n_stages, width)
    nb = 1 << width
    rows = [torch.bincount(digits(keys, width * s, width), minlength=nb)
            for s in range(n_stages)]
    return torch.stack(rows).to(torch.int32)


def digit_histograms(keys: torch.Tensor, *, n_stages: int = 8,
                     width: int = 4) -> torch.Tensor:
    """u32 keys (any shape, contiguous) -> (n_stages, 2^width) int32 counts.

    Stage s counts the digit (key >> width*s) & (2^width - 1)."""
    global LAUNCHES
    if keys.device.type == "cpu":
        return digit_histograms_plain(keys, n_stages=n_stages, width=width)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    _check(keys, n_stages, width)
    lib = build.library()
    n = keys.numel()
    out = torch.zeros((n_stages, 1 << width), dtype=torch.int32,
                      device=keys.device)
    if n == 0:
        return out
    sms = torch.cuda.get_device_properties(keys.device).multi_processor_count
    grid = max(1, min(-(-n // THREADS), BLOCKS_PER_SM * sms))
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rs_digit_histograms(keys.data_ptr(), n, n_stages, width,
                                      out.data_ptr(), grid, THREADS, stream)
    build.check(err, "digit_histograms")
    LAUNCHES += 1
    return out


def stage_bases(hist: torch.Tensor) -> torch.Tensor:
    """(n_stages, 2^width) histograms -> exclusive bucket bases per stage."""
    return (torch.cumsum(hist, dim=1) - hist).to(torch.int32)
