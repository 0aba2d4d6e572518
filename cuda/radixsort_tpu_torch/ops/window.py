"""Window functions: per-partition ranks, running aggregates and shifts.

Counterpart of ``cuda/radixsort_tpu/ops/window.py``, the SQL
``OVER (PARTITION BY p ORDER BY o)`` family: one ``sort_struct`` of
(validity limb, partition, order) carries every payload column, then each
window column is position arithmetic over ``plain_scan_fast`` fills, one
segmented scan over the partition runs (the scan kernel for int32, uint32
and float32 columns), or one masked shift. Output rows come in
(partition, order) order.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.aggregate import _neighbour_differs
from cuda.radixsort_tpu_torch.ops.scan import (ENGINES, plain_scan_fast,
                                               segmented_scan)
from cuda.radixsort_tpu_torch.ops.sort import sort_struct
from cuda.radixsort_tpu_torch.utils.profiling import traced

WINDOW_FNS = ("row_number", "rank", "dense_rank", "cumsum", "cummin",
              "cummax", "lag", "lead")
# the running aggregates' scan engine: ops/scan.py::segmented_scan's engine=
SCAN_ENGINES = ENGINES

_SCAN_OP = {"cumsum": "sum", "cummin": "min", "cummax": "max"}


@traced
def window(part: torch.Tensor, order: torch.Tensor, values, outputs, *,
           valid: torch.Tensor | None = None, descending: bool = False,
           scan_engine: str = "auto",
           config: config_lib.SortConfig | None = None):
    """Compute window columns over partitions of ``part`` ordered by
    ``order``.

    values: a dict of named payload columns (carried through the sort).
    outputs: tuple of (out_name, source column or None, fn) with fn in
    WINDOW_FNS; source is None for row_number/rank/dense_rank and a key of
    ``values`` otherwise. ``valid``: optional bool mask; invalid rows sink
    to the tail and break partition runs (the validity limb). descending
    orders each partition by ``order`` descending. lag/lead give 0 at a
    partition's first/last row.

    Returns (part_sorted, order_sorted, values_sorted: dict,
    window_cols: dict, count): rows [0, count) valid, grouped by
    partition, ordered within each partition."""
    if scan_engine not in SCAN_ENGINES:
        raise ValueError(f"scan_engine must be one of {SCAN_ENGINES}; got "
                         f"{scan_engine!r}")
    n = part.shape[0]
    dev = part.device
    if order.shape[0] != n:
        raise ValueError("part/order length mismatch")
    for name, src, fn in outputs:
        if fn not in WINDOW_FNS:
            raise ValueError(f"{fn!r} not in {WINDOW_FNS}")
        if fn in ("row_number", "rank", "dense_rank"):
            if src is not None:
                raise ValueError(f"{fn} takes no source column")
        elif src not in values:
            raise ValueError(f"{name}: unknown source column {src!r}")
    if n == 0:
        empty = {name: torch.zeros(0, dtype=torch.int32 if src is None
                                   else values[src].dtype, device=dev)
                 for name, src, fn in outputs}
        return (part, order, dict(values), empty,
                torch.zeros((), dtype=torch.int32, device=dev))
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    valid = valid.to(torch.bool)
    # validity limb: invalid rows sort last whatever `descending` says
    flag = (valid if descending else ~valid).to(torch.uint8)
    (sflag, spart, sorder), sv = sort_struct(
        (flag, part, order), dict(values), descending=descending,
        config=config)
    count = valid.sum(dtype=torch.int32)

    # partition runs break on a partition change or a validity-limb change,
    # so the invalid tail never chains onto the last real partition
    heads = _neighbour_differs(spart) | _neighbour_differs(sflag)
    heads[0] = True
    # ranks are position arithmetic over start-position fills
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    part_start = plain_scan_fast(torch.where(heads, pos, -1), "max")
    row_number = pos - part_start + 1
    peer_heads = heads | _neighbour_differs(sorder)
    peer_start = plain_scan_fast(torch.where(peer_heads, pos, -1), "max")

    out_cols = {}
    for name, src, fn in outputs:
        if fn == "row_number":
            out_cols[name] = row_number
        elif fn == "rank":
            out_cols[name] = peer_start - part_start + 1
        elif fn == "dense_rank":
            out_cols[name] = segmented_scan(peer_heads.to(torch.int32),
                                            heads, "sum")
        elif fn in _SCAN_OP:
            out_cols[name] = segmented_scan(sv[src], heads, _SCAN_OP[fn],
                                            engine=scan_engine)
        else:
            v = sv[src]
            zero = torch.zeros((), dtype=v.dtype, device=dev)
            if fn == "lag":
                out_cols[name] = twiddle.where(
                    heads, zero, twiddle.cat([v[:1], v[:-1]]))
            else:
                tails = torch.cat([heads[1:], torch.ones(
                    1, dtype=torch.bool, device=dev)])
                out_cols[name] = twiddle.where(
                    tails, zero, twiddle.cat([v[1:], v[-1:]]))
    return spart, sorder, sv, out_cols, count


@traced
def window_table(cols: dict, partition_by: str, order_by: str, spec, *,
                 valid=None, descending: bool = False,
                 scan_engine: str = "auto", config=None):
    """The window stage of Query.window and Table.window: output names
    must not collide with a column; a source may name any column, the
    partition or order column included (the running total over the order
    key), which then rides the sort a second time as payload.

    Returns (every input column reordered plus the window columns,
    count)."""
    for name, _, _ in spec:
        if name in cols:
            raise ValueError(f"window output {name!r} collides with an "
                             "existing column")
    needed = {src for _, src, _ in spec if src is not None}
    payload = {k: v for k, v in cols.items()
               if k not in (partition_by, order_by) or k in needed}
    sp, so, sv, wcols, cnt = window(
        cols[partition_by], cols[order_by], payload, spec, valid=valid,
        descending=descending, scan_engine=scan_engine, config=config)
    out = dict(sv)
    out[partition_by] = sp
    out[order_by] = so
    out.update(wcols)
    return out, cnt
