"""Traffic kind ``tpch``: a TPC-H query through the port's query layer
(``Table``, ``Query.run``) over tables made on the card from the seed.

The tables hold the columns the query reads, made by the distributions of
TPC-H v3 §4.2.3, with the constants the configuration file states
(``tables``): dense customer keys; sparse order keys (the first 8 of every
32); ``o_custkey`` uniform over the customer keys that are not a multiple
of 3; ``o_orderdate`` uniform in [1992-01-01, 1998-08-02]; 1-7 lines per
order; ``l_shipdate`` = order date + 1..121 days; ``l_discount`` 0..10
percent; ``l_extendedprice`` = quantity (1..50) x the part's retail price
(§4.2.3's P_RETAILPRICE formula, in cents) of a uniform part key. Dates are
int32 days since 1992-01-01, money int32 cents, ``c_mktsegment`` the int8
index into the configuration's segment list, ``l_discount`` int8 percent.

Mix keys:
  query          "q3" (§2.4.3)
  segments, date_first, date_last
                 the substitution parameters (§2.4.3.3): every (segment,
                 date) pair is used, in an order drawn from the seed, and
                 again from the start
  limit          rows of the answer (10)
  check_calls    answers compared with the reference: drawn from the seed
                 among the window's calls, and the last call's
  trace_calls    the calls a --trace 1 run traces
  control        the control of this mix (``reference/tpch_q3.py``)
"""

from __future__ import annotations

import datetime
import random

import torch

EPOCH = datetime.date(1992, 1, 1)
# Q3 groups by (l_orderkey, o_orderdate, o_shippriority); a join carries one
# build column, so the plan packs the last two into one int32 (TPC-H's
# o_shippriority is 0 on every row, below PACK)
PACK = 16


def day(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - EPOCH).days


def make_tables(config: dict, gen: torch.Generator, device) -> dict:
    """{table: {column: tensor}} at the configuration's scale factor."""
    t = config["tables"]
    sf = config["scale_factor"]
    n_cust = int(t["customer_per_sf"] * sf)
    n_ord = int(t["orders_per_sf"] * sf)
    n_part = int(t["part_per_sf"] * sf)

    def rand(lo, hi, n, dtype=torch.int32):  # uniform in [lo, hi]
        return torch.randint(lo, hi + 1, (n,), dtype=dtype, generator=gen,
                             device=device)

    customer = {
        "custkey": torch.arange(1, n_cust + 1, dtype=torch.int32,
                                device=device),
        "c_mktsegment": rand(0, len(config["segments"]) - 1, n_cust,
                             torch.int8)}
    used, every = t["order_key_sparsity"]
    i = torch.arange(n_ord, dtype=torch.int32, device=device)
    orderkey = (i // used) * every + i % used + 1
    del i
    mortality = t["cust_mortality"]  # no orders for every 3rd customer
    r = rand(0, n_cust - n_cust // mortality - 1, n_ord)
    o_custkey = (r // (mortality - 1)) * mortality + r % (mortality - 1) + 1
    del r
    o_orderdate = rand(day(t["orderdate_first"]), day(t["orderdate_last"]),
                       n_ord)
    orders = {"orderkey": orderkey, "custkey": o_custkey,
              "o_orderdate": o_orderdate,
              "o_shippriority": torch.zeros(n_ord, dtype=torch.int32,
                                            device=device)}
    lo, hi = t["lines_per_order"]
    lines = rand(lo, hi, n_ord)
    n_line = int(lines.sum())
    of_line = torch.repeat_interleave(
        torch.arange(n_ord, dtype=torch.int32, device=device), lines,
        output_size=n_line)
    del lines
    lo, hi = t["ship_days"]
    l_shipdate = o_orderdate.index_select(0, of_line) + rand(lo, hi, n_line)
    l_orderkey = orderkey.index_select(0, of_line)
    del of_line
    lo, hi = t["discount_pct"]
    l_discount = rand(lo, hi, n_line, torch.int8)
    partkey = rand(1, n_part, n_line)
    retail = 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)
    del partkey
    lo, hi = t["quantity"]
    l_extendedprice = rand(lo, hi, n_line) * retail
    del retail
    lineitem = {"orderkey": l_orderkey, "l_shipdate": l_shipdate,
                "l_extendedprice": l_extendedprice, "l_discount": l_discount}
    return {"customer": customer, "orders": orders, "lineitem": lineitem}


class Q3:
    """Q3 as a user of the port writes it: the orders plan (customer ->
    orders) built once, and the lineitem plan, whose join takes the orders
    plan's result and count as its build side, made around each result."""

    def __init__(self, rt, tables: dict, limit: int):
        self.rt, self.limit = rt, limit
        self.param = {}
        self.lineitem = rt.Table(tables["lineitem"])
        p = self.param
        self.orders_plan = (
            rt.Query(rt.Table(tables["orders"]))
            .where(lambda t: t["o_orderdate"] < p["date"])
            .join(rt.Table(tables["customer"]), on="custkey",
                  value="c_mktsegment")
            .where(lambda t: t["c_mktsegment"] == p["segment"])
            .with_column("o_datepri", lambda t: t["o_orderdate"] * PACK
                         + t["o_shippriority"]))

    def run(self, segment: int, date: int) -> dict:
        self.param.update(segment=segment, date=date)
        orders, count, _ = self.orders_plan.run()
        plan = (self.rt.Query(self.lineitem)
                .where(lambda t: t["l_shipdate"] > date)
                .with_column("revenue", lambda t: t["l_extendedprice"]
                             * (100 - t["l_discount"]) // 100)
                .join(orders, on="orderkey", value="o_datepri",
                      build_count=count)
                .groupby_agg(("orderkey", "o_datepri"),
                             {"revenue": ("revenue", "sum")})
                .with_column("neg_datepri", lambda t: -t["o_datepri"])
                .order_by("revenue", "neg_datepri", descending=True)
                .limit(self.limit))
        out, count, _ = plan.run()
        n = int(count)
        return {"orderkey": out["orderkey"][:n].cpu(),
                "revenue": out["revenue"][:n].cpu(),
                "o_orderdate": (out["o_datepri"][:n] // PACK).cpu(),
                "o_shippriority": (out["o_datepri"][:n] % PACK).cpu()}


class Cell:
    def __init__(self, rt, config: dict, mix: dict, *, seed: int, device,
                 reference):
        if mix["query"] != "q3":
            raise ValueError(f"no query {mix['query']!r}")
        self.ref, self.device, self.seed = reference, device, seed
        gen = torch.Generator(device=device).manual_seed(seed % 2**64)
        self.tables = make_tables(config, gen, device)
        self.rows = sum(next(iter(cols.values())).shape[0]
                        for cols in self.tables.values())
        codes = {name: i for i, name in enumerate(config["segments"])}
        pairs = [(codes[s], d) for s in mix["segments"]
                 for d in range(day(mix["date_first"]),
                                day(mix["date_last"]) + 1)]
        random.Random(seed).shuffle(pairs)
        self.params = pairs
        self.limit = int(mix["limit"])
        self.check_calls = int(mix["check_calls"])
        self.query = Q3(rt, self.tables, self.limit)
        self.fn = self.query.run
        self.answers: list = []  # (call, params, answer) of every call
        self.layer = {"rows": self.rows}

    def use_control(self, name: str) -> None:
        self.fn = lambda seg, date: self.ref.control(
            name, self.tables, seg, date, self.limit)

    def call(self, i: int):
        seg, date = self.params[i % len(self.params)]
        out = self.fn(seg, date)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return (seg, date), out

    def warm(self) -> None:
        for i in range(2):
            out = self.call(i)
            del out

    def keep(self, i: int, out, last: bool) -> None:
        self.answers.append((i,) + out)

    def release(self) -> None:
        self.fn = self.query = None

    def check(self) -> dict:
        """The most answer rows any checked call got wrong (limit 0: the
        answers are exact)."""
        n = len(self.answers)
        picked = set(random.Random(self.seed).sample(
            range(n), min(self.check_calls, n))) | {n - 1}
        want: dict = {}
        worst = 0
        for i in sorted(picked):
            _, params, got = self.answers[i]
            if params not in want:
                want[params] = self.ref.q3(self.tables, *params, self.limit)
            worst = max(worst, self.ref.mismatched_rows(got, want[params]))
        return {"mismatched_rows": (worst, 0)}
