"""Device-wide histograms.

Counterpart of ``cuda/radixsort_tpu/ops/histogram.py``. Parity:
cub::DeviceHistogram::{HistogramEven, HistogramRange}, plus the radix
pipeline's digit histogram as a public operator. Out-of-range samples
drop, as in CUB.

Every count goes through :func:`count_bins`: up to 255 bins it is the
histogram kernel (``kernels/histogram.py::digit_histograms``, one 8-bit
digit, a spare bin taking the dropped rows); wider it is one
``index_add_``, which, unlike ``torch.bincount`` on the card, reads
nothing back to the host to size its output.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.kernels import histogram as khist
from cuda.radixsort_tpu_torch.utils.profiling import traced

_KERNEL_MAX_BINS = 255  # bins of one 8-bit digit, less the spare bin


def count_bins(idx: torch.Tensor, nbins: int) -> torch.Tensor:
    """(nbins,) int32 counts of the integer values of idx in [0, nbins);
    the value nbins marks a row that is not counted. Other values must not
    occur."""
    if nbins <= _KERNEL_MAX_BINS:
        digits = idx.to(torch.int32).view(torch.uint32).contiguous()
        return khist.digit_histograms(digits, n_stages=1, width=8)[0, :nbins]
    out = torch.zeros(nbins + 1, dtype=torch.int32, device=idx.device)
    out.index_add_(0, idx.reshape(-1).to(torch.int64),
                   torch.ones(idx.numel(), dtype=torch.int32,
                              device=idx.device))
    return out[:nbins]


@traced
def digit_histogram(keys: torch.Tensor, *, begin_bit: int = 0, bits: int = 8,
                    config: config_lib.SortConfig | None = None
                    ) -> torch.Tensor:
    """Counts of each ``bits``-wide digit at ``begin_bit`` of the twiddled
    key (the unsigned bit space the sort runs in). Returns (2^bits,)
    int32.

    Route: digits of a width the kernel takes (``khist.WIDTHS``: 2, 4, 8)
    are counted by the histogram kernel at that width; other widths go
    through :func:`count_bins` (the kernel at width 8 up to 7 bits).
    ``config`` is accepted for the reference's signature; no choice here
    depends on it."""
    width = twiddle.bit_width(keys.dtype)
    if not (0 <= begin_bit < width and 1 <= bits
            and begin_bit + bits <= width):
        raise ValueError(f"bad digit range [{begin_bit}, {begin_bit + bits}) "
                         f"for {keys.dtype}")
    b = twiddle.signed_view(twiddle.twiddle_in(keys))
    if width < 64:
        b = b.to(torch.int64) & ((1 << width) - 1)
    digits = (b >> begin_bit) & ((1 << bits) - 1)
    if bits in khist.WIDTHS:
        d32 = digits.to(torch.int32).view(torch.uint32)
        return khist.digit_histograms(d32, n_stages=1, width=bits)[0]
    return count_bins(digits, 1 << bits)


@traced
def histogram_even(samples: torch.Tensor, num_bins: int, lower,
                   upper) -> torch.Tensor:
    """Histogram over ``num_bins`` even bins covering [lower, upper), in
    float32 as the reference computes it: bin floor((s - lo) * (num_bins /
    (hi - lo))), clipped to the last bin. Parity:
    cub::DeviceHistogram::HistogramEven (num_levels = num_bins + 1)."""
    dev = samples.device
    s = samples.to(torch.float32)
    lo = torch.as_tensor(lower, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(upper, dtype=torch.float32, device=dev)
    scale = num_bins / (hi - lo)
    idx = torch.floor((s - lo) * scale).to(torch.int32)
    valid = (s >= lo) & (s < hi)
    idx = torch.clamp(idx, 0, num_bins - 1)
    return count_bins(torch.where(valid, idx, num_bins), num_bins)


def _as_dtype(samples: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """samples converted to dtype as the reference's ``astype`` converts:
    floats to integers truncate toward zero and saturate, NaN to 0."""
    if not samples.dtype.is_floating_point or dtype.is_floating_point:
        return samples.to(dtype)
    info = torch.iinfo(dtype)
    s = torch.nan_to_num(samples.to(torch.float64), nan=0.0)
    out = s.clamp(info.min, info.max).to(dtype)
    # float64 rounds int64's maximum up to 2^63: saturate those explicitly
    return torch.where(s >= float(info.max), info.max, out)


@traced
def histogram_range(samples: torch.Tensor,
                    levels: torch.Tensor) -> torch.Tensor:
    """Histogram over bins [levels[i], levels[i+1]); samples outside
    [levels[0], levels[-1]) drop. Parity:
    cub::DeviceHistogram::HistogramRange."""
    nbins = levels.shape[0] - 1
    s = _as_dtype(samples, levels.dtype)
    idx = torch.searchsorted(levels, s, right=True).to(torch.int32) - 1
    valid = (s >= levels[0]) & (s < levels[-1])
    idx = torch.clamp(idx, 0, nbins - 1)
    return count_bins(torch.where(valid, idx, nbins), nbins)
