"""The port's shuffle, distributed group-by and joins (parallel/shuffle.py)
against the JAX package's.

One gloo world of 4 CPU ranks (tests/torch_world.py, a 120 s limit) runs every
case once; each test runs the JAX function on a 4-device sub-mesh of the
suite's 8 CPU devices with the same seeded numpy input and holds every
rank's valid rows [0, count), in order, the (ndev,) counts and every
ExchangeStats field to the JAX device block, bit for bit (integer
aggregates only: every value here is an integer).
"""

import numpy as np
import pytest
import torch

from cuda.radixsort_tpu_torch.parallel import dsort as tdsort
from cuda.radixsort_tpu_torch.parallel import shuffle as tshuffle
from cuda.radixsort_tpu_torch.parallel import stats as tstats
import torch_world as W
from cuda.radixsort_tpu_torch.utils.convert import (blocks, from_numpy,
                                                    stats_to_numpy, to_numpy)

NDEV = 4
U32 = np.uint32


def _zipf(n, seed):
    rng = np.random.default_rng(seed)
    keys = np.where(rng.random(n) < 0.6, 42,
                    rng.integers(0, 300, size=n)).astype(U32)
    return keys, rng.integers(-500, 500, size=n).astype(np.int32)


def _max_key(n=NDEV * 1024):
    rng = np.random.default_rng(44)
    keys = rng.integers(0, 50, size=n).astype(U32)
    keys[::5] = 0xFFFFFFFF
    return keys, rng.integers(-500, 500, size=n).astype(np.int32)


def _small(n, seed, nkeys):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, nkeys, size=n).astype(U32),
            rng.integers(-500, 500, size=n).astype(np.int32))


def _non_div_sized():
    keys, vals = _small(NDEV * 500 + 7, 46, 64)
    keys[:9] = 0xFFFFFFFF
    return keys, vals


# id -> ((keys, values), agg, sized)
GROUPBYS = {
    **{f"zipf-{a}": (lambda: _zipf(NDEV * 4096, 11), a, False)
       for a in ("sum", "count", "min", "max")},
    **{f"max-key-{a}": (_max_key, a, False)
       for a in ("sum", "count", "min", "max")},
    **{f"non-divisible-{n}-{a}": (lambda n=n: _small(n, 45, 40), a, False)
       for n in (NDEV * 300 + 1, NDEV * 1024 - 3, 17) for a in ("sum",
                                                                "count")},
    "sized": (lambda: _zipf(NDEV * 4096, 23), "sum", True),
    "non-divisible-sized": (_non_div_sized, "min", True),
}


def _fk(nb, npr, seed, span=4):
    rng = np.random.default_rng(seed)
    bk = rng.permutation(np.arange(span * nb, dtype=U32))[:nb]
    bv = rng.integers(0, 2**31, size=nb).astype(np.int32)
    pk = rng.choice(np.arange(span * nb, dtype=U32), size=npr)
    return bk, bv, pk


def _skewed_probe():
    rng = np.random.default_rng(56)
    nb, npr = NDEV * 128, NDEV * 2048
    bk = rng.permutation(np.arange(2 * nb, dtype=U32))[:nb]
    bv = rng.integers(0, 2**31, size=nb).astype(np.int32)
    pk = np.where(rng.random(npr) < 0.6, bk[17],
                  rng.choice(np.arange(2 * nb, dtype=U32), size=npr))
    return bk, bv, pk.astype(U32)


def _dup_builds():
    rng = np.random.default_rng(57)
    nb, npr = NDEV * 64, NDEV * 512
    return (rng.integers(0, 100, size=nb).astype(U32),
            np.arange(nb, dtype=np.int32),
            rng.integers(0, 200, size=npr).astype(U32))


# id -> ((build keys, build values, probe keys), how, keyword arguments)
JOINS = {
    "broadcast": (lambda: _fk(NDEV * 128, NDEV * 4096, 12), "broadcast", {}),
    "hash": (lambda: _fk(NDEV * 256, NDEV * 2048, 55), "hash", {}),
    "hash-ragged": (lambda: _fk(NDEV * 256 + 5, NDEV * 2048 - 7, 55),
                    "hash", {}),
    "hash-skewed-probe": (_skewed_probe, "hash", {}),
    "hash-duplicate-builds": (_dup_builds, "hash", {}),
    "broadcast-duplicate-builds": (_dup_builds, "broadcast", {}),
    "sized": (lambda: _fk(NDEV * 256, NDEV * 1024 + 13, 58, 2), "sized", {}),
    "routed-hash": (lambda: _fk(NDEV * 128, NDEV * 1024, 59, 2), "routed",
                    {"broadcast_threshold": 0}),
    "routed-broadcast": (lambda: _fk(NDEV * 128, NDEV * 1024, 59, 2),
                         "routed", {"broadcast_threshold": 10**9}),
}


def _exchange_input(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**31, size=n).astype(np.int32),
            rng.integers(0, NDEV, size=n).astype(np.int32))


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------


def _ranks(rank, world):
    mesh = tdsort.make_mesh(world, device="cpu")
    mesh2 = tdsort.make_mesh_2d(2, world // 2, device="cpu")

    def shard(x):
        return from_numpy(W.shard_of(x, rank, world), "cpu")

    out = {}
    for key, (make, agg, sized) in GROUPBYS.items():
        k, v = make()
        if sized:
            gk, gv, c, cap, st = tshuffle.groupby_distributed_sized(
                shard(k), shard(v), mesh=mesh, agg=agg, n=len(k))
        else:
            gk, gv, c, st = tshuffle.groupby_distributed(
                shard(k), shard(v), mesh=mesh, agg=agg, n=len(k))
            cap = None
        out["groupby", key] = (to_numpy(gk), to_numpy(gv), to_numpy(c),
                               stats_to_numpy(st), cap)
    k, v = _small((1 << 12) - 9, 84, 100)
    gk, gv, c, st = tshuffle.groupby_distributed(
        shard(k), shard(v), mesh=mesh2, axis_name=("host", "chip"),
        agg="sum", n=len(k))
    out["groupby-tuple"] = (to_numpy(gk), to_numpy(gv), to_numpy(c),
                            stats_to_numpy(st), None)
    for key, (make, how, kw) in JOINS.items():
        bk, bv, pk = make()
        args = (from_numpy(bk, "cpu"), from_numpy(bv, "cpu"), shard(pk))
        fn = {"broadcast": tshuffle.join_distributed_broadcast,
              "hash": tshuffle.join_distributed_hash,
              "sized": tshuffle.join_distributed_sized,
              "routed": tshuffle.join_distributed}[how]
        res = fn(*args, mesh=mesh, n=len(pk), **kw)
        caps = res[4] if how == "sized" else None
        ok, ov, oi, c, st = res[:4] + res[-1:]
        out["join", key] = (to_numpy(ok), to_numpy(ov), to_numpy(oi),
                            to_numpy(c), stats_to_numpy(st), caps)
    for key, n, cap in (("basic", NDEV * 512, 512), ("undersized", NDEV * 64,
                                                      16)):
        data, dest = _exchange_input(n, 13 if key == "basic" else 7)
        if key == "undersized":
            dest = np.zeros(n, np.int32)  # all to rank 0: 64 rows > cap 16
        (rx,), valid = tshuffle.exchange_rows(
            [shard(data)], shard(dest), world, "x", cap, mesh=mesh)
        out["exchange", key] = (to_numpy(rx), to_numpy(valid))
    return out


@pytest.fixture(scope="module")
def ranks():
    return W.run_world(f"{__file__}:_ranks", NDEV, timeout=120)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jmesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:NDEV]), ("x",))


def _jshuffle():
    from cuda.radixsort_tpu.parallel import shuffle

    return shuffle


def _same_stats(got: dict, st):
    for k, w in stats_to_numpy(st).items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert got[k].dtype == w.dtype, k


def _same_valid_rows(got, want_cols, counts):
    """Every rank's rows [0, counts[r]) of each column, in order."""
    for j, w in enumerate(want_cols):
        wb = blocks(w, NDEV)
        for r in range(NDEV):
            c = counts[r]
            assert got[r][j].shape == wb[r].shape
            np.testing.assert_array_equal(got[r][j][:c], wb[r][:c],
                                          err_msg=f"column {j} rank {r}")


@pytest.mark.parametrize("key", list(GROUPBYS))
def test_groupby_distributed_matches_jax(ranks, jmesh, key):
    import jax.numpy as jnp

    make, agg, sized = GROUPBYS[key]
    k, v = make()
    js = _jshuffle()
    if sized:
        gk, gv, c, cap, st = js.groupby_distributed_sized(
            jnp.asarray(k), jnp.asarray(v), mesh=jmesh, agg=agg)
    else:
        gk, gv, c, st = js.groupby_distributed(
            jnp.asarray(k), jnp.asarray(v), mesh=jmesh, agg=agg)
        cap = None
    got = [ranks[r]["groupby", key] for r in range(NDEV)]
    counts = np.asarray(c)
    _same_valid_rows(got, (gk, gv), counts)
    for g in got:
        np.testing.assert_array_equal(g[2], counts)
        _same_stats(g[3], st)
        assert g[4] == cap
    # and against numpy: every group once, exact aggregates
    res = {}
    for r, g in enumerate(got):
        for kk, vv in zip(g[0][:counts[r]], g[1][:counts[r]]):
            assert int(kk) not in res, "group on two ranks"
            res[int(kk)] = int(vv)
    want = {int(u): int({"sum": np.sum, "count": np.size, "min": np.min,
                         "max": np.max}[agg](v[k == u]))
            for u in np.unique(k)}
    assert res == want


def test_groupby_distributed_tuple_axis(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    m2 = Mesh(np.array(jax.devices()[:NDEV]).reshape(2, 2), ("host", "chip"))
    k, v = _small((1 << 12) - 9, 84, 100)
    gk, gv, c, st = _jshuffle().groupby_distributed(
        jnp.asarray(k), jnp.asarray(v), mesh=m2, axis_name=("host", "chip"),
        agg="sum")
    got = [ranks[r]["groupby-tuple"] for r in range(NDEV)]
    _same_valid_rows(got, (gk, gv), np.asarray(c))
    for g in got:
        _same_stats(g[3], st)


@pytest.mark.parametrize("key", list(JOINS))
def test_join_distributed_matches_jax(ranks, jmesh, key):
    import jax.numpy as jnp

    make, how, kw = JOINS[key]
    bk, bv, pk = make()
    js = _jshuffle()
    fn = {"broadcast": js.join_distributed_broadcast,
          "hash": js.join_distributed_hash,
          "sized": js.join_distributed_sized,
          "routed": js.join_distributed}[how]
    res = fn(jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), mesh=jmesh,
             **kw)
    ok, ov, oi, c, st = res[:4] + res[-1:]
    got = [ranks[r]["join", key] for r in range(NDEV)]
    counts = np.asarray(c)
    _same_valid_rows(got, (ok, ov, oi), counts)
    for g in got:
        np.testing.assert_array_equal(g[3], counts)
        _same_stats(g[4], st)
        if how == "sized":
            assert g[5] == tuple(int(x) for x in res[4])
    # and against a dict oracle (the last duplicate build key wins)
    lut = dict(zip(bk.tolist(), bv.tolist()))
    want = sorted((int(k), lut[int(k)], i) for i, k in enumerate(pk)
                  if int(k) in lut)
    rows = sorted((int(a), int(b), int(i)) for r, g in enumerate(got)
                  for a, b, i in zip(g[0][:counts[r]], g[1][:counts[r]],
                                     g[2][:counts[r]]))
    assert rows == want


def _jax_exchange(jmesh, data, dest, cap):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    def fn(d, x):
        (rx,), v = _jshuffle().exchange_rows([x.reshape(-1)], d.reshape(-1),
                                             NDEV, "x", cap)
        return rx.reshape(1, -1), v.reshape(1, -1)

    return jax.jit(shard_map(fn, mesh=jmesh, in_specs=(P("x"), P("x")),
                             out_specs=(P("x"), P("x"))))(
        jnp.asarray(dest), jnp.asarray(data))


def test_exchange_rows_matches_jax(ranks, jmesh):
    data, dest = _exchange_input(NDEV * 512, 13)
    rx, v = _jax_exchange(jmesh, data, dest, 512)
    for r in range(NDEV):
        grx, gv = ranks[r]["exchange", "basic"]
        np.testing.assert_array_equal(gv, np.asarray(v)[r])
        np.testing.assert_array_equal(grx, np.asarray(rx)[r])
        # every valid row on rank r was sent to r, in (source, order) order
        want = np.concatenate([data[s * 512:(s + 1) * 512][
            dest[s * 512:(s + 1) * 512] == r] for s in range(NDEV)])
        np.testing.assert_array_equal(grx[gv], want)


def test_exchange_rows_undersized_cap_is_loud(ranks, jmesh):
    data, _ = _exchange_input(NDEV * 64, 7)
    _, v = _jax_exchange(jmesh, data, np.zeros(NDEV * 64, np.int32), 16)
    assert not np.asarray(v).any()
    for r in range(NDEV):
        assert not ranks[r]["exchange", "undersized"][1].any()


def test_describe_flags_overflow():
    import jax.numpy as jnp

    from cuda.radixsort_tpu.parallel.stats import ExchangeStats, describe

    fields = dict(rows_in=[10], rows_out=[10], wire_bytes=[1e10], cap=4,
                  cap_utilization=2.5, skew=1.0)
    dt = dict(rows_in="int32", rows_out="int32", wire_bytes="float32",
              cap="int32", cap_utilization="float32", skew="float32")
    want = describe(ExchangeStats(**{k: jnp.asarray(v, dt[k])
                                     for k, v in fields.items()}))
    got = tstats.describe(tstats.ExchangeStats(**{
        k: torch.tensor(v, dtype=getattr(torch, dt[k]))
        for k, v in fields.items()}))
    assert got == want
    assert "OVERFLOW" in got and "wire_MB=10000" in got


@pytest.mark.parametrize("dtype", ["uint32", "int32", "int64", "float32",
                                   "uint8"])
def test_owners_match_jax(dtype):
    import jax.numpy as jnp

    from cuda.radixsort_tpu.parallel import shuffle as js

    rng = np.random.default_rng(5)
    a = (rng.integers(-1000, 1000, size=512) if dtype != "uint8"
         else rng.integers(0, 256, size=512)).astype(dtype)
    b = rng.integers(0, 2**31, size=512).astype(np.int32)
    for ndev in (1, 3, 4, 8):
        np.testing.assert_array_equal(
            to_numpy(tshuffle._owner_of_keys(from_numpy(a, "cpu"), ndev)),
            np.asarray(js._owner_of_keys(jnp.asarray(a), ndev)))
        np.testing.assert_array_equal(
            to_numpy(tshuffle._owner_of_key_tuple(
                [from_numpy(a, "cpu"), from_numpy(b, "cpu")], ndev)),
            np.asarray(js._owner_of_key_tuple(
                [jnp.asarray(a), jnp.asarray(b)], ndev)))
