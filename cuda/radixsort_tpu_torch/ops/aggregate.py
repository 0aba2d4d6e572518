"""Group-by aggregation: sort + segmented scans + compaction.

Counterpart of ``cuda/radixsort_tpu/ops/aggregate.py``. Rows are radix-sorted
by group key; a reversed segmented scan puts each group's total at its first
row; the first rows are compacted with the filter operator:

  sorted keys -> group starts (neighbour compare) -> reversed segmented
  inclusive scan (each group's total lands on its start row) -> compact.

Outputs keep their full length: rows [0, count) hold one row per group,
key-ascending; count is a 0-d int32 tensor on the device.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.filter import filter_columns
from cuda.radixsort_tpu_torch.ops.scan import plain_scan_fast, segmented_scan
from cuda.radixsort_tpu_torch.ops.sort import sort_pairs, sort_struct
from cuda.radixsort_tpu_torch.utils.profiling import traced

_AGGS = ("sum", "count", "min", "max", "mean", "var", "std")


def _mean_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype if dtype.is_floating_point else torch.float32


def _moments_to_var(sums, sumsqs, cnts, agg, dtype):
    """Population variance/std (ddof=0) from the moments, E[x^2] - E[x]^2
    in the mean dtype (f32 for integers)."""
    md = _mean_dtype(dtype)
    m = sums.to(md) / cnts.to(md)
    v = torch.clamp_min(sumsqs.to(md) / cnts.to(md) - m * m, 0)
    return torch.sqrt(v) if agg == "std" else v


def _neighbour_differs(col: torch.Tensor) -> torch.Tensor:
    """False, then col[i] != col[i-1] for i >= 1 (floats compare as values,
    so each NaN is a group of its own)."""
    col = twiddle.full_view(col)
    first = torch.zeros(1, dtype=torch.bool, device=col.device)
    return torch.cat([first, col[1:] != col[:-1]])


def _group_starts(key_cols, valid_sorted):
    """True at each group-start row of the sorted key columns: where any key
    column changes, and at the valid/invalid boundary, so invalid rows never
    chain onto a real group."""
    n = key_cols[0].shape[0]
    is_start = torch.zeros(n, dtype=torch.bool, device=key_cols[0].device)
    is_start[0] = True
    for col in key_cols:
        is_start |= _neighbour_differs(col)
    if valid_sorted is not None:
        is_start |= _neighbour_differs(valid_sorted)
    return is_start


def _ends_of(is_start: torch.Tensor) -> torch.Tensor:
    return torch.cat([is_start[1:],
                      torch.ones(1, dtype=torch.bool, device=is_start.device)])


def _segment_end_pos(is_start: torch.Tensor) -> torch.Tensor:
    """end_pos[i] = last row of i's segment: a running max of the end
    positions on the reversed axis."""
    n = is_start.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=is_start.device)
    rev_ends = twiddle.flip(_ends_of(is_start))
    # pos is the reversed index here
    filled_rev = plain_scan_fast(torch.where(rev_ends, pos, -1), "max")
    return (n - 1) - twiddle.flip(filled_rev)


def _segmented_total_at_start(values, is_start, agg):
    """out[i] = reduce of i's segment, valid at segment-start rows. count is
    position arithmetic; sum/min/max are a segmented scan of the reversed
    rows restarting at the reversed segment ends."""
    if agg == "count":
        n = is_start.shape[0]
        pos = torch.arange(n, dtype=torch.int32, device=is_start.device)
        return _segment_end_pos(is_start) - pos + 1
    rev_ends = twiddle.flip(_ends_of(is_start))
    return twiddle.flip(segmented_scan(twiddle.flip(values), rev_ends, agg))


def _ones_i32(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=torch.int32, device=device)


def _invalid_flag(valid: torch.Tensor) -> torch.Tensor:
    """u8 sort limb that sinks invalid rows after the valid ones."""
    return (~valid.to(torch.bool)).to(torch.uint8)


@traced
def groupby(keys: torch.Tensor, values: torch.Tensor | None = None, *,
            agg: str = "sum", valid: torch.Tensor | None = None,
            config: config_lib.SortConfig | None = None):
    """Group rows by key and reduce values per group.

    Returns (group_keys, aggregates, count): rows [0, count) hold one row
    per distinct key, key-ascending. agg: sum, count, min, max, mean, var,
    std or median; 'count' ignores ``values``. ``valid`` optionally masks
    rows out (the selection-vector protocol): invalid rows sort into their
    own trailing segments through a validity limb and are dropped by the
    final compaction. 'median' routes to :func:`groupby_quantile` (q=0.5).
    """
    if agg == "median":
        if values is None:
            raise ValueError("median needs a value column")
        gk, (gv,), count = groupby_quantile(keys, values, (0.5,),
                                            valid=valid, config=config)
        return gk, gv, count
    if agg not in _AGGS:
        raise ValueError(agg)
    cfg = config_lib.resolve(config)
    n = keys.shape[0]
    if agg == "count" or values is None:
        values = _ones_i32(n, keys.device)
    if n == 0:
        return keys, values, torch.zeros((), dtype=torch.int32,
                                          device=keys.device)
    if valid is None:
        skeys, svals = sort_pairs(keys, values, config=cfg)
        valid_sorted = None
    else:
        (sflag, skeys), svals = sort_struct((_invalid_flag(valid), keys),
                                            values, config=cfg)
        valid_sorted = sflag == 0
    is_start = _group_starts((skeys,), valid_sorted)
    if agg in ("mean", "var", "std"):
        md = _mean_dtype(svals.dtype)
        sums = _segmented_total_at_start(svals, is_start, "sum")
        cnts = _segmented_total_at_start(None, is_start, "count")
        if agg == "mean":
            totals = sums.to(md) / cnts.to(md)
        else:
            sq = svals.to(md) * svals.to(md)
            sumsqs = _segmented_total_at_start(sq, is_start, "sum")
            totals = _moments_to_var(sums, sumsqs, cnts, agg, svals.dtype)
    else:
        totals = _segmented_total_at_start(svals, is_start, agg)
    keep = is_start if valid_sorted is None else (is_start & valid_sorted)
    (gk, gv), count = filter_columns(keep, (skeys, totals), config=cfg)
    return gk, gv, count


@traced
def groupby_multi(key_columns, value_columns, agg_ops, *,
                  valid: torch.Tensor | None = None,
                  config: config_lib.SortConfig | None = None):
    """Multi-key, multi-aggregate group-by: one struct sort, one segmented
    reduction per aggregate, one compaction.

    key_columns: equal-length key tensors (a lexicographic group key).
    value_columns: one value tensor per aggregate. agg_ops: one of sum,
    count, min, max, mean, var, std per value column ('count' ignores its
    column). valid: optional bool mask. Returns (key_columns_out,
    value_columns_out, count): rows [0, count) hold one row per distinct key
    tuple, key-ascending; aggregates align.
    """
    key_columns = tuple(key_columns)
    value_columns = tuple(value_columns)
    agg_ops = tuple(agg_ops)
    if len(agg_ops) != len(value_columns):
        raise ValueError("one agg per value column")
    for a in agg_ops:
        if a not in _AGGS:
            raise ValueError(a)
    cfg = config_lib.resolve(config)
    n = key_columns[0].shape[0]
    dev = key_columns[0].device
    vals = tuple(_ones_i32(n, dev) if a == "count" else v
                 for v, a in zip(value_columns, agg_ops))
    if n == 0:
        return key_columns, vals, torch.zeros((), dtype=torch.int32, device=dev)
    if valid is None:
        skeys, svals = sort_struct(key_columns, vals, config=cfg)
        valid_sorted = None
    else:
        (sflag, *sk), svals = sort_struct(
            (_invalid_flag(valid),) + key_columns, vals, config=cfg)
        skeys = tuple(sk)
        valid_sorted = sflag == 0
    is_start = _group_starts(skeys, valid_sorted)
    seg_counts = (_segmented_total_at_start(None, is_start, "count")
                  if any(a in ("mean", "var", "std") for a in agg_ops)
                  else None)

    def total(sv, a):
        if a in ("mean", "var", "std"):
            md = _mean_dtype(sv.dtype)
            s = _segmented_total_at_start(sv, is_start, "sum")
            if a == "mean":
                return s.to(md) / seg_counts.to(md)
            sq = sv.to(md) * sv.to(md)
            ssq = _segmented_total_at_start(sq, is_start, "sum")
            return _moments_to_var(s, ssq, seg_counts, a, sv.dtype)
        return _segmented_total_at_start(sv, is_start, a)

    totals = tuple(total(sv, a) for sv, a in zip(svals, agg_ops))
    keep = is_start if valid_sorted is None else (is_start & valid_sorted)
    cols, count = filter_columns(keep, skeys + totals, config=cfg)
    nk = len(skeys)
    return cols[:nk], cols[nk:], count


@traced
def groupby_quantile(keys, values: torch.Tensor, qs=(0.5,), *,
                     valid: torch.Tensor | None = None,
                     config: config_lib.SortConfig | None = None):
    """Per-group quantiles with linear interpolation (numpy's default).

    The value column joins the sort key ((validity, key..., value) struct
    sort), and each quantile is picked at its floor and ceil rank by a
    reversed segmented max, then interpolated. ``keys`` may be one tensor
    or a tuple of key columns; ``qs`` a float or a sequence. Returns
    (group_keys, quantile_columns aligned with qs, count); quantile columns
    are in the mean dtype (f32 for integer values).
    """
    if isinstance(qs, (int, float)):
        qs = (float(qs),)
    qs = tuple(qs)
    multi = isinstance(keys, (tuple, list))
    key_columns = tuple(keys) if multi else (keys,)
    for q in qs:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
    cfg = config_lib.resolve(config)
    n = key_columns[0].shape[0]
    dev = key_columns[0].device
    md = _mean_dtype(values.dtype)
    if n == 0:
        return ((key_columns if multi else key_columns[0]),
                tuple(torch.zeros(0, dtype=md, device=dev) for _ in qs),
                torch.zeros((), dtype=torch.int32, device=dev))
    if valid is None:
        sorted_cols = sort_struct(key_columns + (values,), config=cfg)
        skeys, svals = tuple(sorted_cols[:-1]), sorted_cols[-1]
        valid_sorted = None
    else:
        sorted_cols = sort_struct((_invalid_flag(valid),) + key_columns
                                  + (values,), config=cfg)
        skeys, svals = tuple(sorted_cols[1:-1]), sorted_cols[-1]
        valid_sorted = sorted_cols[0] == 0
    is_start = _group_starts(skeys, valid_sorted)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    start = plain_scan_fast(torch.where(is_start, pos, -1), "max")
    # rank in segment and segment size are position arithmetic; the rows at
    # the floor/ceil rank are marked and their values carried back to the
    # segment's start row by a reversed segmented max (one mark per segment)
    r = pos - start
    cnt_row = _segment_end_pos(is_start) - start + 1
    sv = svals.to(md)
    miss = torch.full((), float("-inf"), dtype=md, device=dev)
    qcols = []
    for q in qs:
        # index math in f32 always: a bf16/f16 mean dtype would round
        # (cnt - 1) * q to the wrong row in large groups
        idx_f = ((cnt_row - 1).to(torch.float32)
                 * torch.tensor(q, dtype=torch.float32, device=dev))
        lo = torch.floor(idx_f).to(torch.int32)
        hi = torch.ceil(idx_f).to(torch.int32)
        frac = (idx_f - lo.to(torch.float32)).to(md)
        vlo = _segmented_total_at_start(torch.where(r == lo, sv, miss),
                                        is_start, "max")
        vhi = _segmented_total_at_start(torch.where(r == hi, sv, miss),
                                        is_start, "max")
        qcols.append(vlo * (1 - frac) + vhi * frac)
    keep = is_start if valid_sorted is None else (is_start & valid_sorted)
    cols, count = filter_columns(keep, skeys + tuple(qcols), config=cfg)
    nk = len(skeys)
    kc = tuple(cols[:nk])
    return (kc if multi else kc[0]), tuple(cols[nk:]), count
