"""Sorted-set algebra over sorted ranges — thrust's set operations.

Counterpart of ``cuda/radixsort_tpu/ops/setops.py``. Parity:
thrust::set_intersection / set_union / set_difference /
set_symmetric_difference with multiset semantics: a value m times in a and
n times in b is kept min(m, n) times by the intersection, max(m, n) by the
union, max(m - n, 0) by the difference, and the copies kept are a's first
occurrences (the union takes a's copies, then b's surplus).

Every row's fate comes from two searchsorted ranks (its occurrence within
its own run against the other side's run length); kept rows are compacted
by the stable filter, and the union and symmetric difference merge the two
sides with a keep flag riding as a payload (``ops/merge.py``). Each result
is (padded output, count): rows [0, count) are the set.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.filter import filter_columns
from cuda.radixsort_tpu_torch.ops.merge import merge_sorted_pairs, ordered_i64
from cuda.radixsort_tpu_torch.utils.profiling import traced


def _occ_and_other(x_bits: torch.Tensor, y_bits: torch.Tensor):
    """For each row of sorted x: (its occurrence index within its run of
    equal values, the number of equal rows in sorted y)."""
    x64, y64 = ordered_i64(x_bits), ordered_i64(y_bits)
    pos = torch.arange(x64.numel(), device=x64.device)
    occ = pos - torch.searchsorted(x64, x64)
    in_y = (torch.searchsorted(y64, x64, right=True)
            - torch.searchsorted(y64, x64))
    return occ, in_y


def _twiddled(a: torch.Tensor, b: torch.Tensor, descending: bool):
    if a.dtype != b.dtype:
        raise TypeError(f"dtypes differ: {a.dtype} vs {b.dtype}")
    return (twiddle.twiddle_in(a, descending=descending),
            twiddle.twiddle_in(b, descending=descending))


def _u32(mask: torch.Tensor) -> torch.Tensor:
    return mask.to(torch.int32).view(torch.uint32)


def _merge_keep_compact(ab, keep_a, bb, keep_b, config):
    """Merge the two sorted sides with their keep masks riding as a u32
    payload, then compact the kept rows to a prefix. No sentinel keys: a
    dropped row may hold the largest key, so the mask travels as data."""
    mk, mv = merge_sorted_pairs(ab, _u32(keep_a), bb, _u32(keep_b),
                                config=config)
    (out,), cnt = filter_columns(mv.view(torch.int32) != 0, (mk,),
                                 config=config)
    return out, cnt


@traced
def set_intersection(a, b, *, descending: bool = False,
                     config: config_lib.SortConfig | None = None):
    """min(m, n) copies of each common value, taken from a.
    Returns (padded (len(a),), count). Parity: thrust::set_intersection."""
    ab, bb = _twiddled(a, b, descending)
    occ, in_b = _occ_and_other(ab, bb)
    (out,), cnt = filter_columns(occ < in_b, (ab,), config=config)
    return twiddle.twiddle_out(out, a.dtype, descending=descending), cnt


@traced
def set_difference(a, b, *, descending: bool = False,
                   config: config_lib.SortConfig | None = None):
    """max(m - n, 0) copies: a's rows beyond b's count of their value.
    Returns (padded (len(a),), count). Parity: thrust::set_difference."""
    ab, bb = _twiddled(a, b, descending)
    occ, in_b = _occ_and_other(ab, bb)
    (out,), cnt = filter_columns(occ >= in_b, (ab,), config=config)
    return twiddle.twiddle_out(out, a.dtype, descending=descending), cnt


@traced
def set_union(a, b, *, descending: bool = False,
              config: config_lib.SortConfig | None = None):
    """max(m, n) copies: all of a, then b's surplus beyond a's count.
    Returns (padded (len(a) + len(b),), count). Parity: thrust::set_union."""
    ab, bb = _twiddled(a, b, descending)
    occ_b, in_a = _occ_and_other(bb, ab)
    out, cnt = _merge_keep_compact(ab, torch.ones(ab.shape, dtype=torch.bool,
                                                  device=ab.device),
                                   bb, occ_b >= in_a, config)
    return twiddle.twiddle_out(out, a.dtype, descending=descending), cnt


@traced
def set_symmetric_difference(a, b, *, descending: bool = False,
                             config: config_lib.SortConfig | None = None):
    """|m - n| copies of each value (a's surplus and b's surplus).
    Returns (padded (len(a) + len(b),), count).
    Parity: thrust::set_symmetric_difference."""
    ab, bb = _twiddled(a, b, descending)
    occ_a, in_b = _occ_and_other(ab, bb)
    occ_b, in_a = _occ_and_other(bb, ab)
    out, cnt = _merge_keep_compact(ab, occ_a >= in_b, bb, occ_b >= in_a,
                                   config)
    return twiddle.twiddle_out(out, a.dtype, descending=descending), cnt
