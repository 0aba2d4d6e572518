"""The generators and references against what they claim, on the CPU at
tiny sizes: TPC-H at SF 0.01, 2^12 keys."""

import copy
import os

import pytest
import torch

import harness

SEED = 2**31 + 11


def tpch_config(sf: float = 0.01) -> dict:
    cfg = copy.deepcopy(harness.read_json(os.path.join(
        harness.BENCH, "configs", "tpch_sf30.json")))
    cfg["scale_factor"] = sf
    return cfg


@pytest.fixture(scope="module")
def tables():
    tpch = harness.load("traffic", "tpch")
    gen = torch.Generator().manual_seed(SEED)
    return tpch.make_tables(tpch_config(), gen, torch.device("cpu"))


def test_tpch_tables_follow_the_spec(tables):
    tpch = harness.load("traffic", "tpch")
    c, o, li = tables["customer"], tables["orders"], tables["lineitem"]
    assert c["custkey"].tolist() == list(range(1, 1501))
    assert sorted(c["c_mktsegment"].unique().tolist()) == [0, 1, 2, 3, 4]
    ok = o["orderkey"].long()
    assert ok.numel() == 15000 and ok.unique().numel() == 15000
    assert bool(((ok - 1) % 32 < 8).all())  # the first 8 of every 32
    ck = o["custkey"].long()
    assert bool((ck % 3 != 0).all()) and 1 <= ck.min() and ck.max() <= 1500
    share = float((ck % 3 == 1).float().mean())
    assert 0.47 < share < 0.53  # uniform over the keys left
    od = o["o_orderdate"].long()
    assert od.min() >= 0 and od.max() == tpch.day("1998-08-02")
    assert bool((o["o_shippriority"] == 0).all())
    srt = torch.sort(ok)
    row = srt.indices[torch.searchsorted(srt.values, li["orderkey"].long())]
    assert bool((ok[row] == li["orderkey"].long()).all())
    per_order = torch.bincount(row, minlength=15000)
    assert per_order.min() == 1 and per_order.max() == 7
    assert 3.9 < li["orderkey"].numel() / 15000 < 4.1
    lag = li["l_shipdate"].long() - od[row]
    assert lag.min() == 1 and lag.max() == 121
    assert li["l_discount"].min() == 0 and li["l_discount"].max() == 10
    price = li["l_extendedprice"].long()
    assert 90000 <= price.min() and price.max() <= 50 * 209900


def brute_q3(tables, segment, date, limit):
    """Q3 by Python loops over the rows."""
    c = {k: v.tolist() for k, v in tables["customer"].items()}
    o = {k: v.tolist() for k, v in tables["orders"].items()}
    li = {k: v.tolist() for k, v in tables["lineitem"].items()}
    seg_of = dict(zip(c["custkey"], c["c_mktsegment"]))
    order = {k: (d, p) for k, ck, d, p in zip(
        o["orderkey"], o["custkey"], o["o_orderdate"], o["o_shippriority"])
        if d < date and seg_of[ck] == segment}
    rev: dict = {}
    for k, sd, price, disc in zip(li["orderkey"], li["l_shipdate"],
                                  li["l_extendedprice"], li["l_discount"]):
        if sd > date and k in order:
            rev[k] = rev.get(k, 0) + price * (100 - disc) // 100
    rows = sorted(rev, key=lambda k: (-rev[k], order[k][0], order[k][1], k))
    return [(k, rev[k], *order[k]) for k in rows[:limit]]


@pytest.mark.parametrize("segment,date", [(1, "1995-03-15"), (0, "1995-03-01"),
                                          (4, "1995-03-31")])
def test_q3_reference_equals_brute_force(tables, segment, date):
    tpch = harness.load("traffic", "tpch")
    ref = harness.load("reference", "tpch_q3")
    got = ref.q3(tables, segment, tpch.day(date), 10)
    rows = list(zip(*(got[f].tolist() for f in ref.FIELDS)))
    want = brute_q3(tables, segment, tpch.day(date), 10)
    assert len(want) == 10 and rows == want


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_entropy_words_set_each_bit_with_probability_2_to_minus_k(k):
    sort_kind = harness.load("traffic", "cccl_sort")
    gen = torch.Generator().manual_seed(SEED)
    w = sort_kind.random_words(1 << 12, torch.uint32, k, gen,
                               torch.device("cpu"))
    v = w.view(torch.int32).long() & 0xFFFFFFFF
    ones = sum(int(((v >> b) & 1).sum()) for b in range(32))
    n, p = 32 << 12, 2.0 ** -k
    assert abs(ones - n * p) < 6 * (n * p * (1 - p)) ** 0.5


def test_device_metrics_refuse_a_run_without_a_card(rt):
    spec = harness.benchmark_spec()
    w, cfg, mix = harness.cell_spec(spec, "cccl_keys_u32_2e24")
    cfg = dict(cfg, elements=[1, 1 << 28])
    mix = dict(mix, rows=1 << 12, check_pool=2, trace_calls=3)
    with pytest.raises(RuntimeError, match="device metric"):
        harness.run_cell(rt, w, cfg, mix, seed=SEED, seconds=0.2, trace=True,
                         device=torch.device("cpu"), t0=0.0,
                         metrics=harness.metrics_of(spec, "per_layer",
                                                    w["name"]))


def test_the_command_refuses_a_machine_without_a_card(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    monkeypatch.setenv("TRITON_CACHE_DIR", "unset")
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", "unset")
    assert harness.main("cccl_keys_u32_2e24", 1, 1.0, False, 0.0) == 2
    assert capsys.readouterr().out == ""
