"""Plain-torch reference of TPC-H Q3 (§2.4.3) on the ``tpch`` tables, and
its control.

Imports nothing of the program. Keys are matched by ``torch.sort`` and
``torch.searchsorted``, revenue is summed per order by ``index_add_`` in
int64, and the answer is ordered by stable sorts: revenue descending, then
o_orderdate, o_shippriority and l_orderkey ascending (SQL leaves the order
of ties open; the plan's stable sorts give this one). The lineitem rows are
taken in blocks so that the reference fits beside the tables.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 25
FIELDS = ("orderkey", "revenue", "o_orderdate", "o_shippriority")


def q3(tables: dict, segment: int, date: int, limit: int,
       money: torch.dtype = torch.int64) -> dict:
    """The answer's rows as host int64 columns. ``money=torch.float32``
    computes each line's revenue and the sums in float32 (the control)."""
    c, o, li = tables["customer"], tables["orders"], tables["lineitem"]
    cs = torch.sort(c["custkey"].long())
    ck = o["custkey"].long()
    pos = torch.searchsorted(cs.values, ck).clamp_max(cs.values.numel() - 1)
    o_ok = ((cs.values[pos] == ck)
            & (c["c_mktsegment"][cs.indices[pos]] == segment)
            & (o["o_orderdate"] < date))
    del cs, ck, pos
    osort = torch.sort(o["orderkey"].long())
    n_o = osort.values.numel()
    sums = torch.zeros(n_o, dtype=money, device=o_ok.device)
    lines = torch.zeros(n_o, dtype=torch.int64, device=o_ok.device)
    n_l = li["orderkey"].shape[0]
    for a in range(0, n_l, BLOCK):
        b = min(a + BLOCK, n_l)
        lk = li["orderkey"][a:b].long()
        p = torch.searchsorted(osort.values, lk).clamp_max(n_o - 1)
        row = osort.indices[p]
        ok = (osort.values[p] == lk) & (li["l_shipdate"][a:b] > date) \
            & o_ok[row]
        sel = ok.nonzero().squeeze(1)
        price = li["l_extendedprice"][a:b][sel]
        disc = li["l_discount"][a:b][sel]
        if money == torch.int64:
            rev = price.long() * (100 - disc.long()) // 100
        else:
            rev = price.to(money) * ((100 - disc.to(money)) / 100)
        sums.index_add_(0, row[sel], rev)
        lines.index_add_(0, row[sel], torch.ones_like(sel))
    cand = (lines > 0).nonzero().squeeze(1)
    cols = {"orderkey": o["orderkey"][cand].long(),
            "revenue": sums[cand],
            "o_orderdate": o["o_orderdate"][cand].long(),
            "o_shippriority": o["o_shippriority"][cand].long()}
    idx = torch.sort(cols["orderkey"], stable=True).indices
    for name, desc in (("o_shippriority", False), ("o_orderdate", False),
                       ("revenue", True)):
        idx = idx[torch.sort(cols[name][idx], stable=True,
                             descending=desc).indices]
    top = idx[:limit]
    out = {k: v[top] for k, v in cols.items()}
    out["revenue"] = out["revenue"].round().long() if money != torch.int64 \
        else out["revenue"]
    return {k: v.cpu() for k, v in out.items()}


def mismatched_rows(got: dict, want: dict) -> int:
    """Answer rows that differ in any field, a missing or extra row
    counting as one."""
    ng, nw = got["orderkey"].numel(), want["orderkey"].numel()
    n = min(ng, nw)
    bad = torch.zeros(n, dtype=torch.bool)
    for f in FIELDS:
        bad |= got[f][:n].long() != want[f][:n].long()
    return int(bad.sum()) + abs(ng - nw)


def control(name: str, tables: dict, segment: int, date: int,
            limit: int) -> dict:
    """The reference with the guarantee of exact money broken:
    float_revenue sums each line's revenue in float32."""
    if name != "float_revenue":
        raise ValueError(f"no control {name!r}")
    return q3(tables, segment, date, limit, money=torch.float32)
