"""Plain-torch reference of TPC-H Q1 (§2.4.1) on the ``tpch_q1`` lineitem,
and its control.

Imports nothing of the program. Each line that ships by the cutoff gets one
group code (l_returnflag * 256 + l_linestatus); the sums are ``index_add_``
of int64 columns into one slot a code, and the groups come out in the
codes' ascending order, which is ORDER BY l_returnflag, l_linestatus. The
averages are float64 of the exact sum over the count. Lineitem is taken in
blocks so that the reference fits beside the table.
"""

from __future__ import annotations

import datetime

import torch

BLOCK = 1 << 25
EPOCH = datetime.date(1992, 1, 1)
REPORT_END = "1998-12-01"  # Q1's date, from which DELTA days are taken
KEYS = ("l_returnflag", "l_linestatus")
SUMS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
        "sum_disc")
AVERAGES = {"avg_qty": "sum_qty", "avg_price": "sum_base_price",
            "avg_disc": "sum_disc"}
EXACT = KEYS + SUMS[:4] + ("count_order",)
FIELDS = EXACT + tuple(AVERAGES)
# both sides divide one exact int64 sum by one count in float64; a float32
# mean is off by about 1e-7
AVG_RTOL = 1e-12


def cutoff(delta: int) -> int:
    """The last ship date Q1 reads, in days since 1992-01-01."""
    end = datetime.date.fromisoformat(REPORT_END) - datetime.timedelta(delta)
    return (end - EPOCH).days


def q1(lineitem: dict, delta: int, *, float_mean: bool = False) -> dict:
    """The answer's rows as host columns: keys uint8, sums and count int64,
    averages float64 (``float_mean``: float32 means of the int64 sums, the
    control)."""
    li = lineitem
    last = cutoff(delta)
    dev = li["l_shipdate"].device
    sums = {k: torch.zeros(1 << 16, dtype=torch.int64, device=dev)
            for k in SUMS}
    count = torch.zeros(1 << 16, dtype=torch.int64, device=dev)
    n = li["l_shipdate"].shape[0]
    for a in range(0, n, BLOCK):
        b = min(a + BLOCK, n)
        sel = (li["l_shipdate"][a:b] <= last).nonzero().squeeze(1)

        def col(name):
            return li[name][a:b][sel].long()

        code = col("l_returnflag") * 256 + col("l_linestatus")
        qty, price, disc = col("l_quantity"), col("l_extendedprice"), \
            col("l_discount")
        disc_price = price * (100 - disc)
        charge = disc_price * (100 + col("l_tax"))
        for name, v in zip(SUMS, (qty, price, disc_price, charge, disc)):
            sums[name].index_add_(0, code, v)
        count.index_add_(0, code, torch.ones_like(code))
    groups = (count > 0).nonzero().squeeze(1)
    cnt = count[groups]
    out = {"l_returnflag": (groups // 256).to(torch.uint8),
           "l_linestatus": (groups % 256).to(torch.uint8),
           "count_order": cnt}
    out.update({k: sums[k][groups] for k in SUMS})
    for avg, s in AVERAGES.items():
        out[avg] = (out[s].float() / cnt.float() if float_mean
                    else out[s].double() / cnt.double())
    return {k: v.cpu() for k, v in out.items()}


def mismatched_rows(got: dict, want: dict) -> int:
    """Answer rows that differ in any field, a missing or extra row
    counting as one: keys, sums and count exactly, averages within
    AVG_RTOL of the reference's."""
    ng, nw = got["l_returnflag"].numel(), want["l_returnflag"].numel()
    n = min(ng, nw)
    bad = torch.zeros(n, dtype=torch.bool)
    for f in EXACT:
        bad |= got[f][:n].long() != want[f][:n].long()
    for f in AVERAGES:
        g, w = got[f][:n].double(), want[f][:n].double()
        bad |= ~((g - w).abs() <= AVG_RTOL * w.abs())
    return int(bad.sum()) + abs(ng - nw)


def control(name: str, lineitem: dict, delta: int) -> dict:
    """The reference with the guarantee of exact averages broken:
    float_mean gives each average as a float32 mean, as a group-by's
    ``mean`` of integers does."""
    if name != "float_mean":
        raise ValueError(f"no control {name!r}")
    return q1(lineitem, delta, float_mean=True)
