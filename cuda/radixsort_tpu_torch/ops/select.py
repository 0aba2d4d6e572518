"""Radix select: the k-th smallest key and the top k without a full sort.

Counterpart of ``cuda/radixsort_tpu/ops/select.py``. ``kth_value`` walks
the twiddled key 4 bits at a time, most significant first (8 levels for
32-bit keys, 16 for 64-bit ones): at each level a 16-bin count of the
candidate keys' nibbles, the histogram kernel on the card
(``ops/histogram.py::count_bins``), picks the bucket holding the k-th key.
Every level stays on the device: no count is read to the host. ``top_k``
keeps the keys strictly beyond the threshold and the first threshold ties
in row order, compacts them with the filter operator (the stage kernel)
and sorts only those k.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.filter import filter_columns
from cuda.radixsort_tpu_torch.ops.histogram import count_bins
from cuda.radixsort_tpu_torch.ops.scan import plain_scan_fast
from cuda.radixsort_tpu_torch.ops.sort import sort_pairs
from cuda.radixsort_tpu_torch.utils.profiling import traced


def _as_i64(value: int) -> int:
    """An unsigned 64-bit pattern as the int64 with the same bits."""
    return value - (1 << 64) if value >= 1 << 63 else value


def _twiddled_i64(keys: torch.Tensor, largest: bool) -> torch.Tensor:
    """The twiddled key bits in int64: the unsigned value for keys of up
    to 32 bits, the same 64 bits for wider keys."""
    width = twiddle.bit_width(keys.dtype)
    b = twiddle.signed_view(twiddle.twiddle_in(keys, descending=largest))
    return b if width == 64 else b.to(torch.int64) & ((1 << width) - 1)


def _select_bits(bw: torch.Tensor, width: int, k) -> torch.Tensor:
    """0-d int64 holding the twiddled bits of the k-th smallest of bw."""
    dev = bw.device
    kk = torch.as_tensor(k, dtype=torch.int64 if width > 32 else torch.int32,
                         device=dev)
    prefix = torch.zeros((), dtype=torch.int64, device=dev)
    for level in range(width - 4, -1, -4):
        top = level + 4
        himask = (_as_i64((~0 << top) & ((1 << width) - 1))
                  if top < width else 0)
        cand = (bw & himask) == prefix
        digit = (bw >> level) & 15
        hist = count_bins(torch.where(cand, digit, 16), 16)
        cum = torch.cumsum(hist, 0, dtype=kk.dtype) - hist
        b = (cum <= kk).sum() - 1
        kk = kk - cum[b]
        prefix = prefix | (b << level)
    return prefix


def _key_of_bits(prefix: torch.Tensor, dtype: torch.dtype,
                 largest: bool) -> torch.Tensor:
    """Inverse of :func:`_twiddled_i64` for a 0-d tensor."""
    width = twiddle.bit_width(dtype)
    bits = prefix if width == 64 else prefix.to(twiddle.signed_dtype(dtype))
    return twiddle.twiddle_out(bits.view(twiddle.unsigned_dtype(dtype)),
                               dtype, descending=largest)


@traced
def kth_value(keys: torch.Tensor, k, *, largest: bool = False):
    """The k-th smallest key (0-based; largest=True for the k-th largest)
    as a 0-d tensor, for every key dtype the sort takes. ``k`` may be an
    int or a 0-d integer tensor on the keys' device."""
    width = twiddle.bit_width(keys.dtype)
    prefix = _select_bits(_twiddled_i64(keys, largest), width, k)
    return _key_of_bits(prefix, keys.dtype, largest)


@traced
def top_k(keys: torch.Tensor, k: int, *, largest: bool = True,
          sorted_result: bool = True,
          config: config_lib.SortConfig | None = None):
    """The k largest (largest=False: smallest) keys and their int32 row
    indices. Threshold ties are taken in row order; with sorted_result the
    k are sorted (ties stay in row order), else they come in row order.

    Returns (values (k,), indices (k,))."""
    n = keys.shape[0]
    width = twiddle.bit_width(keys.dtype)
    bw = _twiddled_i64(keys, largest)
    thresh = _select_bits(bw, width, k - 1)
    if width == 64:  # compare unsigned bits as signed: flip the sign bit
        sign = -(1 << 63)
        bw, thresh = bw ^ sign, thresh ^ sign
    strictly = bw < thresh
    ties = bw == thresh
    n_strict = strictly.sum(dtype=torch.int32)
    tie_rank = plain_scan_fast(ties.to(torch.int32), "sum") - 1
    keep = strictly | (ties & (tie_rank < (k - n_strict)))
    idx = torch.arange(n, dtype=torch.int32, device=keys.device)
    (fk, fi), _ = filter_columns(keep, (keys, idx), config=config)
    vals, inds = fk[:k], fi[:k]
    if sorted_result:
        vals, inds = sort_pairs(vals, inds, descending=largest,
                                config=config_lib.resolve(config))
    return vals, inds
