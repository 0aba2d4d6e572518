"""The one-device Query.run cuts each stage's table to its valid rows
[0, count) before the next stage: plans whose stages drop rows, keep none,
join a build side with a shorter valid prefix or start from a given count,
held to the JAX package's plan (rows [0, count), counts and per-stage
counts; its tail rows are not compared), and the benchmark's Q3 held to
its plain reference with the rows that enter the LSD loop counted."""

import copy
import datetime
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu as rs
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.kernels import pipeline
from cuda.radixsort_tpu_torch.pipeline import plan as plan_mod
from test_torch_plan import INEXACT, _tables, assert_same

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plans(rt_mod, parts, bcount):
    """name -> plan over a source Table, built by the same code for both
    packages. ``bcount`` is the build side's valid prefix (int or 0-d
    array of the package)."""
    Q = rt_mod.Query
    agg = {"s": ("v", "sum"), "n": ("v", "count"), "mu": ("f", "mean")}
    return {
        # every stage that makes a new count, then a limit
        "where_join_agg_limit": lambda t: (
            Q(t).where(lambda t: t["v"] > -100)
            .join(parts, on="k", value="price")
            .groupby_agg(["k", "g"], agg).limit(25)),
        # stages after a limit, and a limit above the rows left
        "limit_then_stages": lambda t: (
            Q(t).where(lambda t: t["g"] == 1).limit(300)
            .with_column("w", lambda t: t["v"] * 2).order_by("w")
            .limit(10_000)),
        "where_keeps_none": lambda t: (
            Q(t).where(lambda t: t["v"] > 10_000)
            .groupby_agg(["k"], agg).order_by("s", descending=True)
            .limit(5)),
        "join_matches_none": lambda t: (  # no valid build row
            Q(t).join(parts, on="k", value="price", build_count=0)
            .groupby_agg(["k"], agg).order_by("s").limit(5)),
        "join_build_count": lambda t: (
            Q(t).join(parts, on="k", value="price", build_count=bcount)
            .groupby("k", "price", agg="max").order_by("price")),
        "right_build_count_quantiles": lambda t: (
            Q(t).join(parts, on="k", value="price", how="right",
                      build_count=bcount)
            .quantiles("k", "price", (0.5,)).distinct("k")),
    }


PLANS = list(_plans(rt, None, None))
# every plan with an int build_count; those that join a shortened build
# also with a 0-d tensor, which the port reads to the host
CASES = [(p, False) for p in PLANS] + [
    (p, True) for p in PLANS if "build_count" in p]


def _compare(gtab, gcnt, gstats, wtab, wcnt, wstats):
    assert_same(gcnt, wcnt)
    c = int(wcnt)
    assert gtab.column_names == wtab.column_names
    for k in wtab.column_names:
        assert gtab[k].shape[0] == c, k  # no tail: exactly the valid rows
        assert_same(gtab[k], np.asarray(wtab[k])[:c], exact=k not in INEXACT)
    assert list(gstats) == list(wstats)
    for k in wstats:
        assert_same(gstats[k], wstats[k])


@pytest.mark.parametrize("plan,tensor_count", CASES)
def test_plan_output_is_cut_to_its_count(plan, tensor_count):
    (jt, jparts), (tt, tparts) = _tables(7 + PLANS.index(plan))
    bcount = 70
    jq = _plans(rs, jparts, jnp.int32(bcount) if tensor_count
                else bcount)[plan](jt)
    tq = _plans(rt, tparts, torch.tensor(bcount, dtype=torch.int32)
                if tensor_count else bcount)[plan](tt)
    tail = plan_mod.TAIL_ROWS
    _compare(*tq.run(), *jq.run())
    assert plan_mod.TAIL_ROWS > tail  # every plan drops rows somewhere


@pytest.mark.parametrize("plan,stage", [("where_keeps_none", "0:where"),
                                        ("join_matches_none", "0:join")])
def test_no_row_left_gives_empty_columns(plan, stage):
    (_, _), (tt, tparts) = _tables(3)
    out, cnt, stats = _plans(rt, tparts, None)[plan](tt).run()
    assert int(cnt) == 0 and int(stats[stage]) == 0
    assert all(out[k].shape == (0,) for k in out.column_names)


def test_build_count_cuts_the_build_side(monkeypatch):
    """The join sees only the build's first build_count rows: the rows
    past it never reach join_op."""
    (_, _), (tt, tparts) = _tables(5)
    seen = []
    real = plan_mod.join_op

    def spy(bk, bv, *args, **kw):
        seen.append(bk.shape[0])
        return real(bk, bv, *args, **kw)

    monkeypatch.setattr(plan_mod, "join_op", spy)
    tail = plan_mod.TAIL_ROWS
    rt.Query(tt).join(tparts, on="k", value="price",
                      build_count=torch.tensor(33, dtype=torch.int32)).run()
    assert seen == [33]
    # the build's 87 dropped rows; the inner join's probe tail besides
    assert plan_mod.TAIL_ROWS - tail >= tparts.num_rows - 33


@pytest.mark.parametrize("count", [0, 200, "tensor"])
def test_plan_started_from_a_given_count(count, monkeypatch):
    (jt, _), (tt, _) = _tables(11)
    jc, tc = ((jnp.int32(640), torch.tensor(640, dtype=torch.int32))
              if count == "tensor" else (count, count))
    jq = rs.Query(jt, _count=jc).with_column("w", lambda t: t["v"] + 1) \
        .order_by("w").limit(500)
    tq = rt.Query(tt, _count=tc).with_column("w", lambda t: t["v"] + 1) \
        .order_by("w").limit(500)
    seen = []
    real = plan_mod._exec_order_by
    monkeypatch.setitem(plan_mod._EXEC, "order_by", lambda t, *a: (
        seen.append(t.num_rows), real(t, *a))[1])
    _compare(*tq.run(), *jq.run())
    assert seen == [640 if count == "tensor" else count]


def _load(rel: str):
    spec = importlib.util.spec_from_file_location(
        "plan_cut_" + os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_q3_sorts_only_valid_rows():
    """The benchmark's Q3 (benchmark/traffic/tpch.py) at SF 0.02, seed 7,
    three (segment, date) pairs: exact against the plain reference, and at
    most 2.4 rows enter the LSD loop per input row (2.20 with the cut, 6.63
    when every stage sorts its whole table)."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "tpch_sf30.json")) as f:
        cfg = copy.deepcopy(json.load(f))
    cfg["scale_factor"] = 0.02
    tpch = _load("benchmark/traffic/tpch.py")
    ref = _load("benchmark/reference/tpch_q3.py")
    tables = tpch.make_tables(cfg, torch.Generator().manual_seed(7),
                              torch.device("cpu"))
    rows = sum(next(iter(c.values())).shape[0] for c in tables.values())
    q3 = tpch.Q3(rt, tables, 10)
    epoch = datetime.date(1992, 1, 1)
    pairs = [(s, (datetime.date(1995, 3, d) - epoch).days)
             for s, d in ((0, 15), (1, 1), (4, 31))]
    sorted0, tail0 = pipeline.ROWS, plan_mod.TAIL_ROWS
    for seg, date in pairs:
        got = q3.run(seg, date)
        assert len(got["orderkey"]) == 10
        assert ref.mismatched_rows(got, ref.q3(tables, seg, date, 10)) == 0
    per_row = (pipeline.ROWS - sorted0) / len(pairs) / rows
    assert per_row <= 2.4, per_row
    assert (plan_mod.TAIL_ROWS - tail0) / len(pairs) / rows > 0.5
