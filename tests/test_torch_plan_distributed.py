"""Query.run(mesh=), the distributed Table operators and
filter_sort_join_distributed of the port against the JAX package's.

One gloo world of 4 CPU ranks (tests/torch_world.py, a 120 s limit) runs every
plan once, each built by the same code for both packages; each test runs
the JAX plan on a 4-device sub-mesh (or a 2x2 mesh over the ("host",
"chip") tuple axis) with the same seeded numpy tables. Every rank's valid
rows [0, count) of every column, in order, its counts and every stage's
global count match the JAX device block: integers bit for bit, float
means within F32_TOL relative, variances and standard deviations within
the cancellation bound of tests/test_torch_aggregate.py (moment_atol),
medians and quantiles within F32_TOL relative.
"""

import importlib
import warnings

import numpy as np
import pytest

from cuda.radixsort_tpu_torch.parallel import dsort as tdsort
from cuda.radixsort_tpu_torch.pipeline import plan as tplan
from cuda.radixsort_tpu_torch.pipeline import query as tquery
import torch_world as W
from cuda.radixsort_tpu_torch.utils.convert import (blocks, from_numpy,
                                                    stats_to_numpy, to_numpy)

# the packages export a function ``table`` beside the module of that name
ttable_mod = importlib.import_module("cuda.radixsort_tpu_torch.table")
NDEV = 4
U32 = np.uint32
F32_TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _kv(n, nk, nv, seed):
    return {"k": _rng(seed).integers(0, nk, size=n).astype(U32),
            "v": _rng(seed + 1).integers(0, nv, size=n).astype(np.int32)}


def _full_pipeline():
    n, nb = NDEV * 512 + 3, 64
    src = {"k": _rng(1).integers(0, 80, size=n).astype(U32),
           "v": _rng(2).integers(0, 1000, size=n).astype(np.int32)}
    build = {"k": np.arange(nb, dtype=U32),
             "p": _rng(3).integers(0, 50, size=nb).astype(np.int32)}
    return src, {"b": build}


def _join_validity():
    src = _kv(NDEV * 256, 10, 10, 4)
    return src, {"b": {"k": np.arange(10, dtype=U32),
                       "p": np.arange(10, dtype=np.int32) * 100}}


def _large_build():
    n = NDEV * 256 + 5
    src = {"k": _rng(5).integers(0, 400, size=n).astype(U32),
           "v": _rng(6).integers(0, 1000, size=n).astype(np.int32)}
    bk = np.unique((np.arange(257, dtype=U32) * 3) % 401)
    return src, {"b": {"k": bk, "p": _rng(7).integers(
        0, 50, size=bk.shape[0]).astype(np.int32)}}


def _semi_build():
    src = {"k": _rng(8).integers(0, 300, size=NDEV * 128 + 1).astype(U32),
           "v": _rng(9).integers(0, 1000, size=NDEV * 128 + 1)
           .astype(np.int32)}
    bk = np.unique(_rng(10).integers(0, 300, size=120).astype(U32))
    return src, {"b": {"k": bk, "p": np.zeros(bk.shape[0], np.int32)}}


def _abv():
    n = NDEV * 400 + 3
    return {"a": _rng(11).integers(0, 9, size=n).astype(U32),
            "b": _rng(12).integers(0, 3, size=n).astype(U32),
            "v": _rng(13).integers(0, 1000, size=n).astype(np.int32)}, {}


def _kf():
    n = NDEV * 300 + 7
    return {"k": _rng(14).integers(0, 11, size=n).astype(U32),
            "v": _rng(15).integers(-500, 500, size=n).astype(np.int32),
            "f": (_rng(16).standard_normal(n) * 40).astype(np.float32)}, {}


def _window():
    n = NDEV * 300 + 5
    return {"p": _rng(17).integers(0, 17, size=n).astype(U32),
            "o": _rng(18).integers(0, 25, size=n).astype(U32),
            "v": _rng(19).integers(0, 9, size=n).astype(np.int32)}, {}


def _full_join():
    n = NDEV * 512 + 3
    bk = _rng(20).permutation(np.arange(200, dtype=U32))[:120]
    return ({"k": _rng(21).integers(0, 260, size=n).astype(U32),
             "v": _rng(22).integers(0, 50, size=n).astype(np.int32)},
            {"b": {"k": bk, "price": _rng(23).integers(0, 100, size=120)
                   .astype(np.int32)}})


# id -> (data, plan(Query, source, builds), plan-module patches, tuple axis)
PLANS = {
    "where-groupby": (lambda: (_kv(NDEV * 1024 + 11, 40, 100, 30), {}),
                      lambda Q, t, b: Q(t).where(lambda t: t["v"] > 50)
                      .groupby("k", "v", agg="sum"), {}, False),
    "full-pipeline": (_full_pipeline,
                      lambda Q, t, b: Q(t).where(lambda t: t["v"] > 400)
                      .join(b["b"], on="k", value="p")
                      .groupby("k", "v", agg="sum")
                      .order_by("v", descending=True).limit(7), {}, False),
    "join-validity": (_join_validity,
                      lambda Q, t, b: Q(t).where(lambda t: t["v"] == 3)
                      .join(b["b"], on="k", value="p"), {}, False),
    "groupby-count": (lambda: (_kv(NDEV * 300, 12, 1000, 31), {}),
                      lambda Q, t, b: Q(t).groupby("k", "k", agg="count"),
                      {}, False),
    "groupby-min": (lambda: (_kv(NDEV * 300, 12, 1000, 31), {}),
                    lambda Q, t, b: Q(t).groupby("k", "v", agg="min"),
                    {}, False),
    "select-with-column": (
        lambda: ({"x": _rng(32).integers(0, 100, size=NDEV * 128 + 5)
                  .astype(np.int32)}, {}),
        lambda Q, t, b: Q(t).with_column("y", lambda t: t["x"] + 1)
        .where(lambda t: t["y"] % 2 == 0).select("y"), {}, False),
    "tuple-axis": (lambda: (_kv(NDEV * 300 + 3, 23, 100, 33), {}),
                   lambda Q, t, b: Q(t).where(lambda t: t["v"] > 30)
                   .groupby("k", "v", agg="sum"), {}, True),
    "hash-join-large-build": (_large_build,
                              lambda Q, t, b: Q(t).join(b["b"], on="k",
                                                        value="p")
                              .groupby("k", "v", agg="sum"),
                              {"_JOIN_BROADCAST_ROWS": 64}, False),
    "semi-large-build": (_semi_build,
                         lambda Q, t, b: Q(t).join(b["b"], on="k",
                                                   how="semi"),
                         {"_JOIN_BROADCAST_ROWS": 32}, False),
    "order-by-gather-warns": (
        lambda: ({"k": _rng(34).integers(0, 1 << 20, size=NDEV * 512)
                  .astype(U32)}, {}),
        lambda Q, t, b: Q(t).order_by("k"), {"_GATHER_WARN_BYTES": 64},
        False),
    "groupby-agg": (_abv,
                    lambda Q, t, b: Q(t).where(lambda t: t["v"] > 300)
                    .groupby_agg(["a", "b"], {"s": ("v", "sum"),
                                              "c": ("v", "count"),
                                              "hi": ("v", "max")}),
                    {}, False),
    "groupby-moments": (_kf,
                        lambda Q, t, b: Q(t).groupby_agg(
                            ["k"], {"m": ("f", "mean"), "va": ("f", "var"),
                                    "sd": ("f", "std"), "mi": ("v", "mean")}),
                        {}, False),
    "groupby-median": (_kf, lambda Q, t, b: Q(t).groupby("k", "v",
                                                         agg="median"),
                       {}, False),
    "groupby-agg-median": (_kf,
                           lambda Q, t, b: Q(t).groupby_agg(
                               ["k"], {"s": ("v", "sum"),
                                       "md": ("f", "median")}), {}, False),
    "quantiles-hint": (_kf, lambda Q, t, b: Q(t).quantiles(
        "k", "v", (0.25, 0.5), max_groups=16), {}, False),
    "quantiles-auto": (_kf, lambda Q, t, b: Q(t).where(
        lambda t: t["v"] > 0).quantiles("k", "f", (0.1, 0.9)), {}, False),
    "quantiles-many-groups": (lambda: (_kv(NDEV * 300, 200, 1000, 35), {}),
                              lambda Q, t, b: Q(t).quantiles("k", "v"),
                              {}, False),
    "window": (_window, lambda Q, t, b: Q(t).window(
        "p", "o", {"rn": "row_number", "rk": "rank", "cs": ("v", "cumsum"),
                   "lg": ("v", "lag")}), {}, False),
    "distinct": (_abv, lambda Q, t, b: Q(t).distinct("a", "b"), {}, False),
    "full-join": (_full_join, lambda Q, t, b: Q(t).join(
        b["b"], on="k", value="price", how="full"), {}, False),
}


def _fsj_data(seed):
    rng = _rng(seed)
    nb, npr = NDEV * 64, NDEV * 4096
    bk = rng.permutation(np.arange(4 * nb, dtype=U32))[:nb]
    bv = rng.integers(0, 1000, size=nb).astype(np.int32)
    pk = rng.choice(np.arange(4 * nb, dtype=U32), size=npr)
    pv = rng.integers(-1000, 1000, size=npr).astype(np.int32)
    return pk, pv, bk, bv


def _table_data():
    rng = _rng(40)
    n = NDEV * 1024
    return ({"k": rng.integers(0, 5000, size=n).astype(U32),
             "v": rng.integers(0, 100, size=n).astype(np.int32)},
            {"k": np.arange(NDEV * 64, dtype=U32),
             "bval": np.arange(NDEV * 64, dtype=np.int32) * 2})


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------


def _ttable(cols):
    return ttable_mod.Table({k: from_numpy(v, "cpu") for k, v in cols.items()})


def _np_table(t):
    return {k: to_numpy(t[k]) for k in t.column_names}


def BLOCK_PLAN(Q, t):
    return (Q(t.with_column("w", t["v"] * 2)).where(lambda t: t["w"] > 50)
            .groupby("k", "w", agg="sum"))


def _ranks(rank, world):
    mesh = tdsort.make_mesh(world, device="cpu")
    mesh2 = tdsort.make_mesh_2d(2, world // 2, device="cpu")

    out = {}
    for key, (make, plan, patches, tuple_axis) in PLANS.items():
        src, builds = make()
        t = _ttable(src).shard(mesh2 if tuple_axis else mesh,
                               ("host", "chip") if tuple_axis else "x")
        b = {name: _ttable(cols) for name, cols in builds.items()}
        saved = {name: getattr(tplan, name) for name in patches}
        for name, v in patches.items():
            setattr(tplan, name, v)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res, counts, stats = plan(tplan.Query, t, b).run(
                    mesh=mesh2 if tuple_axis else mesh,
                    axis_name=("host", "chip") if tuple_axis else "x")
        finally:
            for name, v in saved.items():
                setattr(tplan, name, v)
        out["plan", key] = (_np_table(res), to_numpy(counts),
                            {k: to_numpy(v) for k, v in stats.items()},
                            [str(w.message) for w in caught])
    # the distributed Table operators (from a full table: they shard it)
    src, build = _table_data()
    full = _ttable(src)
    ts = full.shard(mesh)
    out["shard"] = (_np_table(ts), ts._global_rows)
    g, c, st = ttable_mod.groupby_distributed(full, "k", "v", mesh=mesh)
    out["table-groupby"] = (_np_table(g), to_numpy(c), stats_to_numpy(st))
    j, c, st = ttable_mod.join_distributed(ts, _ttable(build), on="k",
                                           value="bval", mesh=mesh)
    out["table-join"] = (_np_table(j), to_numpy(c), stats_to_numpy(st))
    o, c, st = ttable_mod.sort_distributed(ts, "v", mesh=mesh,
                                           descending=True)
    out["table-sort"] = (to_numpy(o), to_numpy(c), stats_to_numpy(st))
    # a block keeps its mark through select and with_column, so the
    # operators take it as the block it is, not as a whole table to shard
    g, c, st = ttable_mod.groupby_distributed(ts.select(["k", "v"]), "k", "v",
                                              mesh=mesh)
    out["block-select-groupby"] = (_np_table(g), to_numpy(c),
                                   stats_to_numpy(st), g._global_rows)
    res, c, stats = BLOCK_PLAN(tplan.Query, ts).run(mesh=mesh)
    out["block-with-column-plan"] = (_np_table(res), to_numpy(c),
                                     {k: to_numpy(v) for k, v in
                                      stats.items()}, res._global_rows)
    # filter_sort_join_distributed, both join strategies
    for strategy in ("broadcast", "hash"):
        pk, pv, bk, bv = _fsj_data(22)
        s = len(pk) // world
        k, pvv, bvv, c, st = tquery.filter_sort_join_distributed(
            from_numpy(pk[rank * s:(rank + 1) * s], "cpu"),
            from_numpy(pv[rank * s:(rank + 1) * s], "cpu"),
            from_numpy(bk, "cpu"), from_numpy(bv, "cpu"), 0, mesh=mesh,
            join_strategy=strategy)
        out["fsj", strategy] = (to_numpy(k), to_numpy(pvv), to_numpy(bvv),
                                to_numpy(c), stats_to_numpy(st))
    return out


@pytest.fixture(scope="module")
def ranks():
    return W.run_world(f"{__file__}:_ranks", NDEV, timeout=120)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _jmesh(tuple_axis):
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:NDEV])
    if tuple_axis:
        return Mesh(devs.reshape(2, NDEV // 2), ("host", "chip"))
    return Mesh(devs, ("x",))


def _jtable(cols):
    import jax.numpy as jnp

    from cuda.radixsort_tpu.table import Table

    return Table({k: jnp.asarray(v) for k, v in cols.items()})


def _moment_atol(name, col):
    big = float(np.max(np.abs(col.astype(np.float64)))) ** 2 * F32_TOL
    return {"va": big, "sd": np.sqrt(big)}.get(name, 0.0)


def _same_column(name, got, want, src):
    assert got.dtype == want.dtype, name
    if np.issubdtype(want.dtype, np.floating):
        atol = _moment_atol(name, src.get("f", np.zeros(1)))
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=atol,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def _check_rows(ranks, key, out, counts, src):
    counts = np.asarray(counts)
    replicated = counts.ndim == 0
    for r in range(NDEV):
        got, gcounts = ranks[r][key][:2]
        assert set(got) == set(out.column_names)
        np.testing.assert_array_equal(gcounts, counts)
        for name in out.column_names:
            want = np.asarray(out[name])
            wb = want if replicated else blocks(want, NDEV)[r]
            c = int(counts) if replicated else counts[r]
            assert got[name].shape == wb.shape, name
            _same_column(name, got[name][:c], wb[:c], src)


# the JAX reference runs jitted (one compile; eager shard_map dispatches op
# by op), except where the plan reads a value on the host before it traces:
# the auto-routed quantiles stage is the JAX plan with the hint its router
# fills in (the port must route the same way to place the same groups); a
# router that finds too many groups, and the gather warning (a trace-time
# warning in JAX), run eagerly
JAX_PLANS = {"quantiles-auto": lambda Q, t, b: Q(t).where(
    lambda t: t["v"] > 0).quantiles("k", "f", (0.1, 0.9), max_groups=64)}
EAGER = ("order-by-gather-warns", "quantiles-many-groups")


@pytest.mark.parametrize("key", list(PLANS))
def test_query_run_mesh_matches_jax(ranks, key, monkeypatch):
    import jax

    import cuda.radixsort_tpu.pipeline.plan as jplan

    make, plan, patches, tuple_axis = PLANS[key]
    plan = JAX_PLANS.get(key, plan)
    src, builds = make()
    for name, v in patches.items():
        monkeypatch.setattr(jplan, name, v)
    mesh = _jmesh(tuple_axis)
    axis = ("host", "chip") if tuple_axis else "x"

    def run(t, b):
        return plan(jplan.Query, t, b).run(mesh=mesh, axis_name=axis)

    b = {name: _jtable(cols) for name, cols in builds.items()}
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        out, counts, stats = (run if key in EAGER else jax.jit(run))(
            _jtable(src), b)
    _check_rows(ranks, ("plan", key), out, counts, src)
    for r in range(NDEV):
        gstats = ranks[r]["plan", key][2]
        assert set(gstats) == set(stats)
        for k, v in stats.items():
            np.testing.assert_array_equal(gstats[k], np.asarray(v), err_msg=k)
    msgs = ranks[0]["plan", key][3]
    if key == "order-by-gather-warns":
        assert any("replicated view" in m for m in msgs)
    else:
        assert not any("replicated view" in m for m in msgs)


def test_full_pipeline_matches_single_gpu(ranks):
    # the replicated result after order_by/limit is the single-GPU plan's
    src, builds = _full_pipeline()
    b = {name: _ttable(cols) for name, cols in builds.items()}
    out, count, _ = PLANS["full-pipeline"][1](tplan.Query, _ttable(src),
                                              b).run()
    c = int(count)
    got, gc = ranks[0]["plan", "full-pipeline"][:2]
    assert int(gc) == c
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name][:c], to_numpy(out[name])[:c])


def test_table_shard_keeps_the_rank_block(ranks):
    src, _ = _table_data()
    s = len(src["k"]) // NDEV
    for r in range(NDEV):
        cols, n = ranks[r]["shard"]
        assert n == len(src["k"])
        for k in src:
            np.testing.assert_array_equal(cols[k], src[k][r * s:(r + 1) * s])


def test_table_distributed_operators_match_jax(ranks):
    jtable_mod = importlib.import_module("cuda.radixsort_tpu.table")
    src, build = _table_data()
    mesh = _jmesh(False)
    jt = _jtable(src).shard(mesh)
    g, c, st = jtable_mod.groupby_distributed(jt, "k", "v", mesh=mesh)
    j, jc, jst = jtable_mod.join_distributed(jt, _jtable(build), on="k",
                                             value="bval", mesh=mesh)
    o, oc, ost = jtable_mod.sort_distributed(jt, "v", mesh=mesh,
                                             descending=True)
    for key, (t_, cc, ss) in (("table-groupby", (g, c, st)),
                              ("table-join", (j, jc, jst))):
        _check_rows(ranks, key, t_, cc, src)
        for r in range(NDEV):
            for f, w in stats_to_numpy(ss).items():
                np.testing.assert_array_equal(ranks[r][key][2][f], w)
    ob = blocks(o, NDEV)
    for r in range(NDEV):
        np.testing.assert_array_equal(ranks[r]["table-sort"][0], ob[r])
        np.testing.assert_array_equal(ranks[r]["table-sort"][1],
                                      np.asarray(oc))
    # join: probe_row is the global probe row of every match
    k = src["k"]
    total = 0
    for r in range(NDEV):
        cols, cnt = ranks[r]["table-join"][:2]
        sl = slice(0, cnt[r])
        total += int(cnt[r])
        np.testing.assert_array_equal(cols["bval"][sl], cols["k"][sl] * 2)
        np.testing.assert_array_equal(k[cols["probe_row"][sl]],
                                      cols["k"][sl])
    assert total == int((k < NDEV * 64).sum())


def test_block_after_select_matches_jax(ranks):
    jtable_mod = importlib.import_module("cuda.radixsort_tpu.table")
    src, _ = _table_data()
    mesh = _jmesh(False)
    jt = _jtable(src).shard(mesh)
    g, c, st = jtable_mod.groupby_distributed(jt.select(["k", "v"]), "k",
                                              "v", mesh=mesh)
    _check_rows(ranks, "block-select-groupby", g, c, src)
    for r in range(NDEV):
        for f, w in stats_to_numpy(st).items():
            np.testing.assert_array_equal(
                ranks[r]["block-select-groupby"][2][f], w)
        # the output is marked as a block of an ndev-block table
        rows = ranks[r]["block-select-groupby"][0]["k"].shape[0]
        assert ranks[r]["block-select-groupby"][3] == NDEV * rows


def test_block_after_with_column_runs_the_plan_as_jax(ranks):
    import jax

    from cuda.radixsort_tpu.pipeline import plan as jplan

    src, _ = _table_data()
    mesh = _jmesh(False)
    out, counts, stats = jax.jit(lambda t: BLOCK_PLAN(jplan.Query, t).run(
        mesh=mesh))(_jtable(src))
    _check_rows(ranks, "block-with-column-plan", out, counts, src)
    for r in range(NDEV):
        got = ranks[r]["block-with-column-plan"]
        assert set(got[2]) == set(stats)
        for k, v in stats.items():
            np.testing.assert_array_equal(got[2][k], np.asarray(v),
                                          err_msg=k)
        assert got[3] == NDEV * got[0]["k"].shape[0]


@pytest.mark.parametrize("strategy", ["broadcast", "hash"])
def test_filter_sort_join_distributed_matches_jax(ranks, strategy):
    import jax.numpy as jnp

    from cuda.radixsort_tpu.pipeline import query as jquery

    pk, pv, bk, bv = _fsj_data(22)
    k, pvv, bvv, c, st = jquery.filter_sort_join_distributed(
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bk), jnp.asarray(bv),
        0, mesh=_jmesh(False), join_strategy=strategy)
    c = np.asarray(c)
    wants = [blocks(x, NDEV) for x in (k, pvv, bvv)]
    for r in range(NDEV):
        got = ranks[r]["fsj", strategy]
        np.testing.assert_array_equal(got[3], c)
        for g, w in zip(got[:3], wants):
            np.testing.assert_array_equal(g[:c[r]], w[r][:c[r]])
        for f, w in stats_to_numpy(st).items():
            np.testing.assert_array_equal(got[4][f], w)
    lut = dict(zip(bk.tolist(), bv.tolist()))
    want = sorted((int(a), int(b), lut[int(a)]) for a, b in zip(pk, pv)
                  if b > 0 and int(a) in lut)
    rows = sorted((int(a), int(b), int(x)) for r in range(NDEV)
                  for a, b, x in zip(*[g[:c[r]] for g in
                                       ranks[r]["fsj", strategy][:3]]))
    assert rows == want
