"""Plain-torch reference of TPC-H Q3 (§2.4.3) over tables too large for one
card, taken in blocks, and its control.

Imports nothing of the program. The arithmetic and the tie order are
``tpch_q3.py``'s: keys matched by ``torch.sort`` and
``torch.searchsorted``, each line's revenue and the sums per order in
int64 (``index_add_``), the answer ordered by stable sorts, revenue
descending, then o_orderdate, o_shippriority and l_orderkey ascending.
The customer table is held whole; the orders come in blocks, each with
all the lines of its orders, so an order's revenue is summed within its
block and the answer is the best ``limit`` rows of the blocks' best
``limit`` rows. One pass over the blocks answers every parameter pair.
"""

from __future__ import annotations

import importlib.util
import os

import torch

_spec = importlib.util.spec_from_file_location(
    "benchmark_reference_tpch_q3_for_mesh",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "tpch_q3.py"))
tpch_q3 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tpch_q3)

FIELDS = tpch_q3.FIELDS
mismatched_rows = tpch_q3.mismatched_rows


def _best(cols: dict, limit: int) -> dict:
    """The first ``limit`` rows of cols in the answer's order."""
    idx = torch.sort(cols["orderkey"], stable=True).indices
    for name, desc in (("o_shippriority", False), ("o_orderdate", False),
                       ("revenue", True)):
        idx = idx[torch.sort(cols[name][idx], stable=True,
                             descending=desc).indices]
    top = idx[:limit]
    return {k: v[top].cpu() for k, v in cols.items()}


def answers(customer: dict, blocks, params, limit: int) -> dict:
    """{(segment, date): answer} of Q3 for every pair of ``params``, the
    answer's rows as host int64 columns. ``customer``: the whole table;
    ``blocks``: (orders, lineitem) pairs, every line in its order's
    block."""
    params = list(params)
    cs = torch.sort(customer["custkey"].long())
    seg_sorted = customer["c_mktsegment"][cs.indices]
    best: dict = {p: None for p in params}
    for o, li in blocks:
        ck = o["custkey"].long()
        pos = torch.searchsorted(cs.values, ck).clamp_max(
            cs.values.numel() - 1)
        o_seg = torch.where(cs.values[pos] == ck, seg_sorted[pos].long(), -1)
        del ck, pos
        osort = torch.sort(o["orderkey"].long())
        n_o = osort.values.numel()
        lk = li["orderkey"].long()
        p = torch.searchsorted(osort.values, lk).clamp_max(n_o - 1)
        row = osort.indices[p]
        matched = osort.values[p] == lk
        del lk, p
        rev_all = (li["l_extendedprice"].long()
                   * (100 - li["l_discount"].long()) // 100)
        for segment, date in params:
            o_ok = (o_seg == segment) & (o["o_orderdate"] < date)
            ok = matched & (li["l_shipdate"] > date) & o_ok[row]
            sel = ok.nonzero().squeeze(1)
            sums = torch.zeros(n_o, dtype=torch.int64, device=ok.device)
            lines = torch.zeros(n_o, dtype=torch.int64, device=ok.device)
            sums.index_add_(0, row[sel], rev_all[sel])
            lines.index_add_(0, row[sel], torch.ones_like(sel))
            cand = (lines > 0).nonzero().squeeze(1)
            cols = {"orderkey": o["orderkey"][cand].long(),
                    "revenue": sums[cand],
                    "o_orderdate": o["o_orderdate"][cand].long(),
                    "o_shippriority": o["o_shippriority"][cand].long()}
            top = _best(cols, limit)
            kept = best[(segment, date)]
            if kept is not None:
                top = _best({k: torch.cat([kept[k], top[k]]) for k in top},
                            limit)
            best[(segment, date)] = top
    return best


def control(name: str, tables: dict, segment: int, date: int,
            limit: int) -> dict:
    """The reference with the exchanges left out: rank0_only answers from
    one rank's partition (``tables``) as if it were the whole data."""
    if name != "rank0_only":
        raise ValueError(f"no control {name!r}")
    return answers(tables["customer"], [(tables["orders"],
                                         tables["lineitem"])],
                   [(segment, date)], limit)[(segment, date)]
