"""The port's query layer vs the JAX package's: Query plans through every
stage (``run``'s rows [0, count), count and per-stage counts, and
``explain()``'s text), ``run(timed=True)``, filter_sort_join, the three
query flagships and ``python -m cuda.radixsort_tpu_torch --device cpu``.
Tail rows past the count are real dropped rows, not compared. Integer
columns bit for bit, float aggregates within F32_TOL."""

import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu as rs
from cuda.radixsort_tpu.models import flagships as jflag
from cuda.radixsort_tpu.pipeline.query import filter_sort_join as j_fsj
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.models import flagships as tflag
from cuda.radixsort_tpu_torch.pipeline.query import QueryStats
from cuda.radixsort_tpu_torch.pipeline.query import filter_sort_join as t_fsj
from cuda.radixsort_tpu_torch.utils.convert import (from_numpy,
                                                    table_from_numpy, to_numpy)

REPO = pathlib.Path(__file__).resolve().parent.parent
N, NB = 1500, 120
F32_TOL = 1e-5


def _raw(a):
    a = np.asarray(a)
    return a if a.dtype == np.bool_ else a.view(f"uint{a.dtype.itemsize * 8}")


def assert_same(got, want, exact=True, atol=F32_TOL):
    g, w = to_numpy(got), np.asarray(want)
    if w.ndim == 0:
        assert g.dtype == np.int32 and g.ndim == 0 and int(g) == int(w)
        return
    assert g.dtype == w.dtype and g.shape == w.shape
    if exact:
        np.testing.assert_array_equal(_raw(g), _raw(w))
    else:
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=atol)


def _tables(seed):
    """orders (k, g, v, f) and a build table parts (k, g, price) whose keys
    cover about two thirds of the orders' keys."""
    rng = np.random.default_rng(seed)
    src = {"k": rng.integers(0, 180, size=N).astype(np.uint32),
           "g": rng.integers(0, 3, size=N).astype(np.int32),
           "v": rng.integers(-300, 300, size=N).astype(np.int32),
           "f": np.clip(rng.standard_normal(N) * 10, -39, 39)
           .astype(np.float32)}
    parts = {"k": rng.permutation(180)[:NB].astype(np.uint32),
             "g": rng.integers(0, 3, size=NB).astype(np.int32),
             "price": rng.integers(1, 500, size=NB).astype(np.int32)}
    jx = [rs.Table({k: jnp.asarray(v) for k, v in d.items()})
          for d in (src, parts)]
    pt = [table_from_numpy(d, "cpu") for d in (src, parts)]
    return jx, pt


def _plans(rt_mod, parts):
    """name -> (plan over a source Table, float columns compared within
    F32_TOL). Built by the same code for both packages."""
    Q = rt_mod.Query
    return {
        "readme": lambda t: (Q(t).where(lambda t: t["v"] > 100)
                             .join(parts, on="k", value="price")
                             .groupby("k", "v", agg="sum")
                             .order_by("v", descending=True).limit(10)),
        "select_with_column": lambda t: (
            Q(t).select("k", "v").with_column("w", lambda t: t["v"] * 3)
            .where(lambda t: t["w"] > 0).order_by("k", "w")),
        "left_matched_count": lambda t: (
            Q(t).join(parts, on="k", value="price", how="left")
            .where(lambda t: t["matched"]).groupby("k", "k", agg="count")),
        "right_build_count": lambda t: (
            Q(t).where(lambda t: t["v"] < 0)
            .join(parts, on="k", value="price", how="right", build_count=90)
            .order_by("k")),
        "full_window_distinct": lambda t: (
            Q(t).join(parts, on="k", value="price", how="full")
            .window("k", "v", {"rn": "row_number", "cs": ("v", "cumsum"),
                               "dr": "dense_rank"})
            .distinct("k", "rn")),
        "semi_composite": lambda t: (
            Q(t).join(parts, on=("k", "g"), how="semi").order_by(key="v")),
        "anti_then_limit": lambda t: (
            Q(t).join(parts, on="k", how="anti").limit(7)),
        "groupby_agg_median": lambda t: (
            Q(t).where(lambda t: t["f"] > -5)
            .groupby_agg(["g", "k"], {"s": ("v", "sum"), "mu": ("f", "mean"),
                                      "med": ("f", "median"),
                                      "mv": ("v", "median"),
                                      "sd": ("f", "std")})
            .order_by("g", "s", descending=True)),
        "median_only_agg": lambda t: (
            Q(t).groupby_agg(["k"], {"m1": ("v", "median"),
                                     "m2": ("v", "median")})),
        "quantiles": lambda t: (
            Q(t).where(lambda t: t["g"] != 1)
            .quantiles("k", "f", (0.25, 0.5, 0.9))),
        "groupby_median_desc_window": lambda t: (
            Q(t).groupby("g", "f", agg="median")
            .window("g", "f", {"r": "rank"}, descending=True)),
    }


INEXACT = {"mu", "med", "sd", "f", "q25", "q50", "q90", "mv", "m1", "m2"}
# E[x^2] - E[x]^2 cancels (test_torch_aggregate.py::moment_atol): a standard
# deviation agrees within the square root of F32_TOL of the largest x^2
STD_ATOL = np.sqrt(F32_TOL) * 40.0  # |f| < 40 in _tables' data
PLANS = list(_plans(rt, None))


@pytest.mark.parametrize("plan", PLANS)
def test_query_plan_matches_jax(plan):
    (jt, jparts), (tt, tparts) = _tables(PLANS.index(plan))
    jq = _plans(rs, jparts)[plan](jt)
    tq = _plans(rt, tparts)[plan](tt)
    assert tq.explain() == jq.explain()
    wtab, wcnt, wstats = jq.run()
    gtab, gcnt, gstats = tq.run()
    assert_same(gcnt, wcnt)
    c = int(wcnt)
    assert gtab.column_names == wtab.column_names
    for k in wtab.column_names:
        assert_same(gtab[k][:c], np.asarray(wtab[k])[:c],
                    exact=k not in INEXACT,
                    atol=STD_ATOL if k == "sd" else F32_TOL)
    assert list(gstats) == list(wstats)
    for k in wstats:
        assert_same(gstats[k], wstats[k])


def test_pre_counted_source_and_timed_run():
    (jt, _), (tt, _) = _tables(99)
    jq = rs.Query(jt, _count=200).where(lambda t: t["v"] > 0).order_by("v")
    tq = rt.Query(tt, _count=200).where(lambda t: t["v"] > 0).order_by("v")
    assert tq.explain() == jq.explain() and "[pre-counted]" in tq.explain()
    wtab, wcnt, _ = jq.run()
    gtab, gcnt, stats = tq.run(timed=True)
    assert_same(gcnt, wcnt)
    assert_same(gtab["v"][:int(wcnt)], np.asarray(wtab["v"])[:int(wcnt)])
    assert set(stats) == {"0:where", "0:where:ms", "1:order_by",
                          "1:order_by:ms"}
    assert all(isinstance(stats[k], float) and stats[k] >= 0
               for k in stats if k.endswith(":ms"))


def test_plan_errors():
    (_, _), (tt, tparts) = _tables(0)
    q = rt.Query(tt)
    with pytest.raises(ValueError):
        q.join(tparts, on="k", how="cross")
    with pytest.raises(ValueError, match="value="):
        q.join(tparts, on="k", how="inner")
    with pytest.raises(ValueError, match="collide"):
        q.quantiles("k", "f", (0.5,), names=("k",))
    with pytest.raises(ValueError):
        q.order_by()
    left = q.join(tparts, on="k", value="price", how="left")
    with pytest.raises(ValueError, match="matched"):
        left.join(tparts, on="k", value="price", how="left").run()


def _fsj_data(seed, n=N, nb=NB):
    rng = np.random.default_rng(seed)
    bk = rng.permutation(2 * nb)[:nb].astype(np.uint32)
    bv = rng.integers(-2**31, 2**31, size=nb, dtype=np.int64).astype(np.int32)
    pk = rng.integers(0, 2 * nb, size=n).astype(np.uint32)
    pv = rng.integers(0, 1000, size=n).astype(np.int32)
    return pk, pv, bk, bv


@pytest.mark.parametrize("threshold", [-1, 400, 999])
def test_filter_sort_join_matches_jax(threshold):
    args = _fsj_data(threshold + 2)
    want = j_fsj(*[jnp.asarray(a) for a in args], threshold)
    got = t_fsj(*[torch.from_numpy(a.view(np.int32)).view(torch.uint32)
                  if a.dtype == np.uint32 else torch.from_numpy(a)
                  for a in args], threshold)
    c = int(want[3])
    for g, w in zip(got[:3], want[:3]):
        assert_same(g[:c], np.asarray(w)[:c])
    assert_same(got[3], want[3])
    assert isinstance(got[4], QueryStats)
    for g, w in zip(got[4], want[4]):
        assert_same(g, w)


def test_filter_sort_join_unsigned_values_match_jax():
    """u32 probe values: the filter compares them as numbers (no uint32
    `>`, which neither CPU torch nor the card's torch has)."""
    pk, pv, bk, bv = _fsj_data(5)
    pv = (pv.astype(np.int64) * 4_000_000 + 7).astype(np.uint32)  # past 2^31
    want = j_fsj(*[jnp.asarray(a) for a in (pk, pv, bk, bv)], 2**31 + 5)
    got = t_fsj(*[from_numpy(a, device="cpu") for a in (pk, pv, bk, bv)],
                2**31 + 5)
    c = int(want[3])
    assert 0 < c < N
    for g, w in zip(got[:3], want[:3]):
        assert_same(g[:c], np.asarray(w)[:c])
    assert_same(got[3], want[3])


@pytest.mark.parametrize("recipe,sizes", [
    ("filter_sort_join_query", (4096, 256)), ("table_query", (4096, 256)),
    ("window_pipeline", (4096,))])
def test_query_flagships_match_jax(recipe, sizes):
    gen = torch.Generator().manual_seed(len(recipe))
    fn, args = tflag.REGISTRY[recipe](*sizes, generator=gen, device="cpu")
    jfn, _ = jflag.REGISTRY[recipe](*[16] * len(sizes))
    want = jfn(*[jnp.asarray(to_numpy(a)) for a in args])
    got = fn(*args)
    flat_g = list(got[:-1]) + list(got[-1]) if recipe.startswith("filter") \
        else list(got)
    flat_w = list(want[:-1]) + list(want[-1]) if recipe.startswith("filter") \
        else list(want)
    for g, w in zip(flat_g, flat_w):
        assert_same(g, w)
    if recipe == "filter_sort_join_query":  # about half the probe rows pass
        assert 0.4 < int(got[4].rows_after_filter) / 4096 < 0.6
    if recipe == "table_query":  # the build rows ride the join's tail
        assert int(got[2]) == 256


def test_self_test_entry_point_on_the_cpu():
    # one torch thread, as the test workers (tests/test_torch_card_ops.py)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "cuda.radixsort_tpu_torch", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    status = json.loads(proc.stdout.strip().splitlines()[-1])
    assert status["sort_1M_ok"] and status["query_plan_ok"]
    assert status["device"] == "cpu"
