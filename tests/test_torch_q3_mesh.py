"""TPC-H Q3 on partitioned tables through Query.run(mesh=): blocks made by
Table.from_partition with unequal counts, join builds that are themselves
sharded, and exchanges whose lanes are sized by the rows they move.

One gloo world of 4 CPU ranks (tests/torch_world.py, a 120 s limit) runs
every case once. The tables are Q3's columns at SF 0.01, made by the
benchmark's generator (benchmark/traffic/tpch.py); each rank keeps only
the rows murmur3's fmix32 of the key places on it (customers by custkey,
orders and lines by orderkey), which the program is not told. The answers
are held to the benchmark's plain reference (benchmark/reference/
tpch_q3.py) over the whole tables.
"""

import copy
import datetime
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import torch_world as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NDEV = 4
SEED = 2**31 + 15
PACK = 16  # o_datepri = o_orderdate * PACK + o_shippriority
EPOCH = datetime.date(1992, 1, 1)
PAIRS = [(s, (datetime.date(1995, 3, d) - EPOCH).days)
         for s, d in ((0, 1), (1, 15), (2, 31), (3, 7), (4, 22), (1, 2))]
FIELDS = ("orderkey", "revenue", "o_orderdate", "o_shippriority")


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(
        "q3_mesh_" + os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tables() -> dict:
    """Q3's tables at SF 0.01 as numpy columns."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "tpch_sf30.json")) as f:
        cfg = copy.deepcopy(json.load(f))
    cfg["scale_factor"] = 0.01
    tpch = _load("benchmark/traffic/tpch.py")
    tables = tpch.make_tables(cfg, torch.Generator().manual_seed(SEED),
                              torch.device("cpu"))
    return {t: {k: v.numpy() for k, v in cols.items()}
            for t, cols in tables.items()}


def fmix32(keys: np.ndarray) -> np.ndarray:
    x = keys.astype(np.uint64) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    return x ^ (x >> 16)


def _own_rows(tables: dict, rank: int) -> dict:
    key = {"customer": "custkey", "orders": "orderkey",
           "lineitem": "orderkey"}
    return {t: {k: v[fmix32(cols[key[t]]) % NDEV == rank]
                for k, v in cols.items()} for t, cols in tables.items()}


def _orders_plan(Q, orders, customer, p):
    return (Q(orders).where(lambda t: t["o_orderdate"] < p["date"])
            .join(customer, on="custkey", value="c_mktsegment")
            .where(lambda t: t["c_mktsegment"] == p["segment"])
            .with_column("o_datepri", lambda t: t["o_orderdate"] * PACK
                         + t["o_shippriority"]))


def _q3(Q, lineitem, orders, count, date, mesh):
    plan = (Q(lineitem).where(lambda t: t["l_shipdate"] > date)
            .with_column("revenue", lambda t: t["l_extendedprice"]
                         * (100 - t["l_discount"]) // 100)
            .select("orderkey", "revenue")
            .join(orders, on="orderkey", value="o_datepri",
                  build_count=count)
            .groupby_agg(("orderkey", "o_datepri"),
                         {"revenue": ("revenue", "sum")})
            .with_column("neg_datepri", lambda t: -t["o_datepri"])
            .order_by("revenue", "neg_datepri", descending=True)
            .limit(10))
    out, n, _ = plan.run(mesh=mesh)
    n = int(n)
    return {"orderkey": out["orderkey"][:n].numpy(),
            "revenue": out["revenue"][:n].numpy(),
            "o_orderdate": (out["o_datepri"][:n] // PACK).numpy(),
            "o_shippriority": (out["o_datepri"][:n] % PACK).numpy()}


def _valid(t, count, rank, names):
    c = int(count[rank])
    return {k: t[k][:c].numpy() for k in names}


def _ranks(rank, world, tables):
    from torch.profiler import ProfilerActivity, profile

    from cuda.radixsort_tpu_torch.ops.histogram import count_bins
    from cuda.radixsort_tpu_torch.parallel import dsort, shuffle
    from cuda.radixsort_tpu_torch.pipeline.plan import Query
    from cuda.radixsort_tpu_torch.table import Table

    mesh = dsort.make_mesh(world, device="cpu")
    own = {t: {k: torch.from_numpy(v) for k, v in cols.items()}
           for t, cols in _own_rows(tables, rank).items()}
    part = {t: Table.from_partition(cols, mesh) for t, cols in own.items()}
    out = {"blocks": {t: (b.num_rows, b._global_rows, int(b._count))
                      for t, b in part.items()}}

    # every exchange of the plans: (column rows, cap, most rows sent to one
    # rank, received rows)
    real = shuffle.exchange_rows
    exchanges = []

    def spy(columns, dest, ndev, axis_name, cap, *, mesh):
        recv, valid = real(columns, dest, ndev, axis_name, cap, mesh=mesh)
        exchanges.append((columns[0].shape[0], cap,
                          int(count_bins(dest, ndev).max()),
                          recv[0].shape[0]))
        return recv, valid

    shuffle.exchange_rows = spy
    p = {}
    plan = _orders_plan(Query, part["orders"], part["customer"], p)
    answers = {}
    for segment, date in PAIRS:
        p.update(segment=segment, date=date)
        orders, count, _ = plan.run(mesh=mesh)
        answers[segment, date] = _q3(Query, part["lineitem"], orders, count,
                                     date, mesh)
    shuffle.exchange_rows = real
    out["answers"], out["exchanges"] = answers, exchanges

    # one query under a profiler: its sized exchanges' host reads
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        p.update(segment=PAIRS[0][0], date=PAIRS[0][1])
        orders, count, _ = plan.run(mesh=mesh)
        _q3(Query, part["lineitem"], orders, count, PAIRS[0][1], mesh)
    out["syncs"] = sum(e.name == "sync.exchange_cap" for e in prof.events())

    # the orders plan's rows with three customer builds: a partitioned
    # block, a positional block (Table.shard) and the whole table
    whole = Table({k: torch.from_numpy(v)
                   for k, v in tables["customer"].items()})
    names = ("orderkey", "o_datepri")
    p.update(segment=PAIRS[1][0], date=PAIRS[1][1])
    builds = {"partitioned": part["customer"],
              "positional": whole.shard(mesh), "whole": whole}
    out["builds"] = {}
    for key, build in builds.items():
        t, c, _ = _orders_plan(Query, part["orders"], build, p).run(
            mesh=mesh)
        out["builds"][key] = _valid(t, c, rank, names)

    # lanes too narrow: every exchange overflows, and the plan's answer is
    # empty on every rank rather than a part of the rows
    saved = dsort.round_cap
    dsort.round_cap = lambda c, quantum=128, steps=1: max(int(c) // 2, 1)
    try:
        orders, count, _ = plan.run(mesh=mesh)
        out["overflow"] = (count.tolist(), len(_q3(
            Query, part["lineitem"], orders, count, PAIRS[1][1],
            mesh)["orderkey"]))
    finally:
        dsort.round_cap = saved
    return out


@pytest.fixture(scope="module")
def tables():
    return _tables()


@pytest.fixture(scope="module")
def ranks(tables):
    return W.run_world(f"{__file__}:_ranks", NDEV, timeout=120,
                       args=(tables,))


@pytest.fixture(scope="module")
def reference():
    return _load("benchmark/reference/tpch_q3.py")


def test_blocks_hold_each_rank_its_own_rows(ranks, tables):
    for t, cols in tables.items():
        rows = [ranks[r]["blocks"][t][0] for r in range(NDEV)]
        n = len(next(iter(cols.values())))
        assert sum(rows) == n and len(set(rows)) > 1  # unequal counts
        for r in range(NDEV):
            assert ranks[r]["blocks"][t] == (rows[r], n, rows[r])


@pytest.mark.parametrize("pair", PAIRS)
def test_q3_equals_the_plain_reference(ranks, tables, reference, pair):
    whole = {t: {k: torch.from_numpy(v) for k, v in cols.items()}
             for t, cols in tables.items()}
    want = reference.q3(whole, *pair, 10)
    assert len(want["orderkey"]) == 10
    for r in range(NDEV):  # the answer is replicated on every rank
        got = ranks[r]["answers"][pair]
        for f in FIELDS:
            np.testing.assert_array_equal(got[f], want[f].numpy(), err_msg=f)


def test_a_sharded_build_gives_the_rows_of_a_replicated_one(ranks):
    def rows(key):
        got = [ranks[r]["builds"][key] for r in range(NDEV)]
        pairs = np.concatenate([np.stack([g["orderkey"], g["o_datepri"]], 1)
                                for g in got])
        return pairs[np.lexsort(pairs.T[::-1])]

    want = rows("whole")
    assert len(want) > 0
    for key in ("partitioned", "positional"):
        np.testing.assert_array_equal(rows(key), want, err_msg=key)


def test_exchange_lanes_are_sized_by_their_counts(ranks):
    from cuda.radixsort_tpu_torch.parallel.dsort import round_cap

    calls = [ranks[r]["exchanges"] for r in range(NDEV)]
    assert len({len(c) for c in calls}) == 1 and len(calls[0]) == 5 * len(
        PAIRS)  # two joins (probe and build each) and a group-by a query
    grown = 0
    for i in range(len(calls[0])):
        most = max(c[i][2] for c in calls)
        for c in calls:
            rows, cap, _, received = c[i]
            assert cap == round_cap(most, steps=8)
            assert received == NDEV * cap
            grown += received > rows
    # the lineitem join's probe: a rank receives about its own rows, not
    # ndev times its column
    assert grown < len(calls[0]) * NDEV // 2


def test_each_sized_exchange_reads_its_cap_once(ranks):
    # five exchanges and the order_by gather a query
    assert all(ranks[r]["syncs"] == 6 for r in range(NDEV))


def test_an_overflowing_lane_empties_the_answer(ranks):
    for r in range(NDEV):
        counts, answer_rows = ranks[r]["overflow"]
        assert counts == [0] * NDEV and answer_rows == 0
