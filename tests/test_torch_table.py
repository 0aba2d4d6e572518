"""The port's Table vs the JAX package's Table, both built from the same
numpy columns (utils/convert.py::table_from_numpy): every method's output
columns bit for bit (float aggregates within F32_TOL) and its count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu as rs
from cuda.radixsort_tpu.table import concat_tables as j_concat
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.table import concat_tables
from cuda.radixsort_tpu_torch.utils.convert import table_from_numpy, to_numpy

N = 1800
F32_TOL = 1e-5


def _raw(a):
    a = np.asarray(a)
    return a if a.dtype == np.bool_ else a.view(f"uint{a.dtype.itemsize * 8}")


def assert_same(got, want, exact=True):
    g, w = to_numpy(got), np.asarray(want)
    if w.ndim == 0:
        assert g.ndim == 0 and int(g) == int(w)
        return
    assert g.dtype == w.dtype and g.shape == w.shape
    if exact:
        np.testing.assert_array_equal(_raw(g), _raw(w))
    else:
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)


def assert_tables(got, want, inexact=()):
    assert got.column_names == want.column_names
    assert repr(got) == repr(want)
    for k in want.column_names:
        assert_same(got[k], want[k], exact=k not in inexact)


def _columns(rng, n=N):
    return {"k": rng.integers(0, 60, size=n).astype(np.uint32),
            "g": rng.integers(-3, 3, size=n).astype(np.int64),
            "v": rng.integers(-1000, 1000, size=n).astype(np.int32),
            "f": (rng.standard_normal(n) * 5).astype(np.float32)}


def _pair(seed):
    cols = _columns(np.random.default_rng(seed))
    return (rs.Table({k: jnp.asarray(v) for k, v in cols.items()}),
            table_from_numpy(cols, "cpu"))


METHODS = {
    "sort_by": lambda t: t.sort_by("v"),
    "sort_by_desc": lambda t: t.sort_by("f", descending=True),
    "sort_by_columns": lambda t: t.sort_by_columns(["g", "k"]),
    "filter": lambda t: t.filter(t["v"] > 0),
    "partition_by": lambda t: t.partition_by("k", bits=4),
    "partition_by_hash": lambda t: t.partition_by("v", bits=3, by_hash=True),
    "groupby": lambda t: t.groupby("k", "v", agg="sum"),
    "groupby_mean": lambda t: t.groupby("g", "f", agg="mean"),
    "groupby_agg": lambda t: t.groupby_agg(
        ["g", "k"], {"s": ("v", "sum"), "m": ("f", "max"), "c": ("v", "count"),
                     "mu": ("f", "mean")}),
    "distinct": lambda t: t.distinct("g", "k"),
    "distinct_all": lambda t: t.select(["g", "k"]).distinct(),
    "window": lambda t: t.window("g", "v", {"rn": "row_number",
                                            "cs": ("v", "cumsum"),
                                            "lg": ("f", "lag")}),
}


@pytest.mark.parametrize("method", list(METHODS))
def test_table_method_matches_jax(method):
    jt, tt = _pair(list(METHODS).index(method))
    want, got = METHODS[method](jt), METHODS[method](tt)
    inexact = {"f", "mu"} if method in ("groupby_mean", "groupby_agg") else ()
    if isinstance(want, tuple):
        assert_tables(got[0], want[0], inexact)
        assert_same(got[1], want[1])
    else:
        assert_tables(got, want, inexact)


def test_table_join_matches_jax():
    jt, tt = _pair(3)
    rng = np.random.default_rng(4)
    build = {"k": rng.permutation(80).astype(np.uint32)[:50],
             "price": rng.integers(0, 99, size=50).astype(np.int32)}
    jb = rs.Table({k: jnp.asarray(v) for k, v in build.items()})
    tb = table_from_numpy(build, "cpu")
    want, got = jt.join(jb, on="k", value="price"), tt.join(tb, on="k",
                                                            value="price")
    assert_tables(got[0], want[0])
    assert_same(got[1], want[1])


@pytest.mark.parametrize("with_counts", [False, True])
def test_concat_tables_matches_jax(with_counts):
    parts = [_pair(s) for s in (5, 6, 7)]
    counts = [10, 0, 1800] if with_counts else None
    want = j_concat([p[0] for p in parts], counts)
    got = concat_tables([p[1] for p in parts], counts)
    if with_counts:
        assert_tables(got[0], want[0])
        assert_same(got[1], want[1])
    else:
        assert_tables(got, want)


def test_table_basics_and_errors():
    t = rt.table(b=torch.arange(3), a=torch.zeros(3, dtype=torch.int32))
    assert t.column_names == ("a", "b") and t.num_rows == 3
    assert repr(t) == "Table(3 rows, {a, b})"
    assert t.select(["b"]).column_names == ("b",)
    assert t.with_column("c", t["b"] * 2)["c"].tolist() == [0, 2, 4]
    with pytest.raises(ValueError):
        rt.Table({})
    with pytest.raises(ValueError, match="lengths"):
        rt.table(a=torch.arange(3), b=torch.arange(4))
    with pytest.raises(ValueError, match="clash"):
        t.groupby_agg(["a"], {"a": ("b", "sum")})
    with pytest.raises(ValueError, match="column sets"):
        concat_tables([t, t.select(["a"])])
    # an unsharded table records no global row count (Table.shard does;
    # the distributed operators run in tests/test_torch_plan_distributed.py)
    assert t._global_rows is None


def test_block_mark_is_kept_and_refused_by_one_device_operators():
    # one rank's block of a sharded table (what Table.shard returns):
    # select and with_column keep its global row count; an operator that
    # would see only this rank's rows refuses it
    t = table_from_numpy({"a": np.arange(8, dtype=np.uint32),
                          "b": np.arange(8, dtype=np.int32)}, "cpu")
    blk = rt.Table({k: t[k] for k in t.column_names}, global_rows=29)
    assert blk.select(["a"])._global_rows == 29
    assert blk.with_column("c", blk["b"] * 2)._global_rows == 29
    with pytest.raises(ValueError, match="column lengths"):
        blk.with_column("c", torch.zeros(29, dtype=torch.int32))
    calls = {
        "Table.sort_by": lambda: blk.sort_by("a"),
        "Table.sort_by_columns": lambda: blk.sort_by_columns(["a"]),
        "Table.filter": lambda: blk.filter(blk["b"] > 2),
        "Table.partition_by": lambda: blk.partition_by("a", bits=2),
        "Table.groupby": lambda: blk.groupby("a", "b"),
        "Table.groupby_agg": lambda: blk.groupby_agg(["a"],
                                                     {"s": ("b", "sum")}),
        "Table.distinct": lambda: blk.distinct("a"),
        "Table.window": lambda: blk.window("a", "b", {"r": "row_number"}),
        "Table.join": lambda: blk.join(t, on="a", value="b"),
        "Table.join's build": lambda: t.join(blk, on="a", value="b"),
        "Table.shard": lambda: blk.shard(None),
        "concat_tables": lambda: concat_tables([t, blk]),
        "Query.run without mesh=": lambda: rt.Query(blk).run(),
    }
    for what, call in calls.items():
        with pytest.raises(ValueError, match="block of a sharded table") as e:
            call()
        assert str(e.value).startswith(what + ":"), str(e.value)
