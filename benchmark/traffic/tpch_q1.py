"""Traffic kind ``tpch_q1``: TPC-H Q1, the pricing summary report (§2.4.1),
through the port's query layer (``Table``, ``Query.run``) over lineitem
made on the card from the seed.

Lineitem holds the columns Q1 reads, made by the distributions of TPC-H v3
§4.2.3 with the constants the configuration file states (``tables``):
``o_orderdate`` uniform in [1992-01-01, 1998-08-02] and 1-7 lines an order
(both only to place the lines, then freed); ``l_shipdate`` = order date +
1..121 days; ``l_quantity`` 1..50; ``l_extendedprice`` = quantity x the
part's retail price (§4.2.3's P_RETAILPRICE formula, in cents) of a uniform
part key; ``l_discount`` 0..10 and ``l_tax`` 0..8 percent; a receipt date
ship date + 1..30 days, which sets ``l_returnflag`` ('R' or 'A' at random
if received by CURRENTDATE, else 'N'); ``l_linestatus`` 'O' if shipped
after CURRENTDATE, else 'F'. Dates are int32 days since 1992-01-01, money
int32 cents, quantity, discount and tax int8, flag and status uint8 ASCII.

Mix keys:
  query          "q1" (§2.4.1)
  delta_first, delta_last
                 DELTA's range (§2.4.1.3): every value is used, in an order
                 drawn from the seed, and again from the start
  check_calls    answers compared with the reference: drawn from the seed
                 among the window's calls, and the last call's
  trace_calls    the calls a --trace 1 run traces
  control        the control of this mix (``reference/tpch_q1.py``)
"""

from __future__ import annotations

import datetime
import random

import torch

EPOCH = datetime.date(1992, 1, 1)
REPORT_END = "1998-12-01"  # Q1's date, from which DELTA days are taken
FIELDS = ("l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
          "sum_disc_price", "sum_charge", "avg_qty", "avg_price", "avg_disc",
          "count_order")


def day(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - EPOCH).days


def make_lineitem(config: dict, gen: torch.Generator, device) -> dict:
    """{column: tensor} of lineitem at the configuration's scale factor."""
    t = config["tables"]
    sf = config["scale_factor"]
    n_ord = int(t["orders_per_sf"] * sf)
    n_part = int(t["part_per_sf"] * sf)

    def rand(lo, hi, n, dtype=torch.int32):  # uniform in [lo, hi]
        return torch.randint(lo, hi + 1, (n,), dtype=dtype, generator=gen,
                             device=device)

    o_orderdate = rand(day(t["orderdate_first"]), day(t["orderdate_last"]),
                       n_ord)
    lo, hi = t["lines_per_order"]
    lines = rand(lo, hi, n_ord)
    n_line = int(lines.sum())
    l_shipdate = torch.repeat_interleave(o_orderdate, lines,
                                         output_size=n_line)
    del o_orderdate, lines
    l_shipdate += rand(*t["ship_days"], n_line)
    current = day(t["currentdate"])
    received = l_shipdate + rand(*t["receipt_days"], n_line) <= current
    coin = rand(0, 1, n_line, torch.uint8)  # 'A' or 'R'
    l_returnflag = torch.where(received, coin * (ord("R") - ord("A"))
                               + ord("A"), torch.full_like(coin, ord("N")))
    del received, coin
    l_linestatus = ((l_shipdate > current).to(torch.uint8)
                    * (ord("O") - ord("F")) + ord("F"))
    l_quantity = rand(*t["quantity"], n_line, torch.int8)
    partkey = rand(1, n_part, n_line)
    retail = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    del partkey
    l_extendedprice = l_quantity.to(torch.int32) * retail
    del retail
    return {"l_shipdate": l_shipdate, "l_quantity": l_quantity,
            "l_extendedprice": l_extendedprice,
            "l_discount": rand(*t["discount_pct"], n_line, torch.int8),
            "l_tax": rand(*t["tax_pct"], n_line, torch.int8),
            "l_returnflag": l_returnflag, "l_linestatus": l_linestatus}


class Q1:
    """Q1 as a user of the port writes it: one plan over the lineitem
    table, its cutoff taken from each call's DELTA."""

    def __init__(self, rt, lineitem: dict):
        self.rt = rt
        self.lineitem = rt.Table(lineitem)

    def run(self, delta: int) -> dict:
        last = day(REPORT_END) - delta
        plan = (
            self.rt.Query(self.lineitem)
            .where(lambda t: t["l_shipdate"] <= last)
            .with_column("qty", lambda t: t["l_quantity"].long())
            .with_column("price", lambda t: t["l_extendedprice"].long())
            .with_column("disc", lambda t: t["l_discount"].long())
            .with_column("disc_price",
                         lambda t: t["price"] * (100 - t["disc"]))
            .with_column("charge", lambda t: t["disc_price"]
                         * (100 + t["l_tax"].long()))
            .groupby_agg(("l_returnflag", "l_linestatus"),
                         {"sum_qty": ("qty", "sum"),
                          "sum_base_price": ("price", "sum"),
                          "sum_disc_price": ("disc_price", "sum"),
                          "sum_charge": ("charge", "sum"),
                          "sum_disc": ("disc", "sum"),
                          "count_order": ("qty", "count")})
            .with_column("avg_qty", lambda t: t["sum_qty"].double()
                         / t["count_order"].double())
            .with_column("avg_price", lambda t: t["sum_base_price"].double()
                         / t["count_order"].double())
            .with_column("avg_disc", lambda t: t["sum_disc"].double()
                         / t["count_order"].double())
            .order_by("l_returnflag", "l_linestatus"))
        # on one card Query.run's table holds only the answer's rows
        out, _, _ = plan.run()
        return {k: out[k].cpu() for k in FIELDS}


class Cell:
    def __init__(self, rt, config: dict, mix: dict, *, seed: int, device,
                 reference):
        if mix["query"] != "q1":
            raise ValueError(f"no query {mix['query']!r}")
        self.ref, self.device, self.seed = reference, device, seed
        if device.type == "cuda":
            # the deployment's allocator: the query's columns change length
            # with DELTA, and without expandable segments the caching
            # allocator of some processes freed and re-allocated its blocks
            # (one call in thirty, 30% slower) while others never did
            torch.cuda.memory._set_allocator_settings(
                "expandable_segments:True")
        gen = torch.Generator(device=device).manual_seed(seed % 2**64)
        self.lineitem = make_lineitem(config, gen, device)
        self.rows = self.lineitem["l_shipdate"].shape[0]
        deltas = list(range(int(mix["delta_first"]),
                            int(mix["delta_last"]) + 1))
        random.Random(seed).shuffle(deltas)
        self.params = deltas
        self.check_calls = int(mix["check_calls"])
        self.query = Q1(rt, self.lineitem)
        self.fn = self.query.run
        self.answers: list = []  # (call, delta, answer) of every call
        self.layer = {"rows": self.rows}

    def use_control(self, name: str) -> None:
        self.fn = lambda delta: self.ref.control(name, self.lineitem, delta)

    def call(self, i: int):
        delta = self.params[i % len(self.params)]
        out = self.fn(delta)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return delta, out

    def warm(self) -> None:
        for i in range(2):
            out = self.call(i)
            del out

    def keep(self, i: int, out, last: bool) -> None:
        self.answers.append((i,) + out)

    def release(self) -> None:
        self.fn = self.query = None

    def check(self) -> dict:
        """The most answer rows any checked call got wrong (limit 0: keys,
        sums and counts exact, averages within the reference's AVG_RTOL)."""
        n = len(self.answers)
        picked = set(random.Random(self.seed).sample(
            range(n), min(self.check_calls, n))) | {n - 1}
        want: dict = {}
        worst = 0
        for i in sorted(picked):
            _, delta, got = self.answers[i]
            if delta not in want:
                want[delta] = self.ref.q1(self.lineitem, delta)
            worst = max(worst, self.ref.mismatched_rows(got, want[delta]))
        return {"mismatched_rows": (worst, 0)}
