"""The port's distributed sort (parallel/dsort.py) against the JAX package's.

One gloo world of 4 CPU ranks (tests/torch_world.py, a 120 s limit) runs every
case of this file once; each test then runs the JAX function on a
4-device sub-mesh of the suite's 8 CPU devices with the same seeded
numpy input and holds every rank's block, the (ndev,) counts and every
ExchangeStats field to the JAX device block, bit for bit. The 2-D cases
run on a 2x2 mesh ("host", "chip").
"""

import os

import numpy as np
import pytest
import torch

from cuda.radixsort_tpu_torch.parallel import dsort as tdsort
import torch_world as W
from cuda.radixsort_tpu_torch.utils.convert import (blocks, from_numpy,
                                                    stats_to_numpy, to_numpy)

NDEV = 4
U32 = np.uint32


def _u32(n, seed, hi=2**32):
    return np.random.default_rng(seed).integers(0, hi, size=n,
                                                dtype=np.uint64).astype(U32)


def _heavy(n, seed, key, frac=0.7):
    keys = _u32(n, seed)
    keys[: int(frac * n)] = key
    np.random.default_rng(seed + 1).shuffle(keys)
    return keys


def _i32(n, seed):
    return np.random.default_rng(seed).integers(
        -(2**31), 2**31 - 1, size=n, dtype=np.int64).astype(np.int32)


def _f32(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _sentinels(n, seed, step=7):
    keys = _u32(n, seed)
    keys[::step] = 0xFFFFFFFF
    return keys


def _dups(n, seed):
    keys = _u32(n, seed, hi=64)  # duplicate-heavy
    keys[::9] = 0xFFFFFFFF
    return keys


def _i32_max(n=4096):
    x = _i32(n, 34)
    x[:64] = np.iinfo(np.int32).max  # twiddles to 0xFFFFFFFF
    return x


def _nan_ones(n=4096):
    x = _f32(n, 35)
    x[:64] = np.frombuffer(np.uint32(0x7FFFFFFF).tobytes(), np.float32)[0]
    return x


def _non_div(n):
    keys = _u32(n, 35)
    keys[:5] = 0xFFFFFFFF  # real keys equal to the pad fill
    return keys


def _stragglers(n=1 << 13):
    keys = _u32(n, 38)
    h = int(0.7 * n)
    keys[:h] = 0xDEAD0001
    keys[h:h + 32] = 0xDEAD0000
    keys[h + 32:h + 64] = 0xDEADFFFF
    np.random.default_rng(39).shuffle(keys)
    return keys


def _pair_heavy(n=1 << 14):
    keys = _u32(n, 37)
    keys[: int(0.4 * n)] = 0x10000001
    keys[int(0.4 * n): int(0.8 * n)] = 0xF0000001
    np.random.default_rng(38).shuffle(keys)
    return keys


# id -> (keys, keyword arguments of sort_distributed)
SORTS = {
    "uniform-4": (lambda: _u32(NDEV, 4), {}),
    "uniform-1024": (lambda: _u32(1024, 1024), {}),
    "uniform-10000": (lambda: _u32(10_000, 10_000), {}),
    "uniform-16384": (lambda: _u32(1 << 14, 1 << 14), {}),
    "heavy-hitter": (lambda: _heavy(1 << 14, 7, 0xDEADBEEF), {}),
    "heavy-pair": (_pair_heavy, {}),
    "heavy-stragglers": (_stragglers, {}),
    "signed": (lambda: _i32(4096, 3), {}),
    "float": (lambda: _f32(4096, 3), {}),
    "descending": (lambda: _u32(4096, 5), {"descending": True}),
    "sentinels-4096": (lambda: _sentinels(1 << 12, 33), {}),
    "sentinels-10000": (lambda: _sentinels(10_000, 33), {}),
    "i32-max": (_i32_max, {}),
    "nan-all-ones": (_nan_ones, {}),
    "non-divisible-403": (lambda: _non_div(NDEV * 100 + 3), {}),
    "non-divisible-8191": (lambda: _non_div((1 << 13) - 1), {}),
    "rounds-2": (lambda: _sentinels(1 << 14, 62, 11), {"rounds": 2}),
    "rounds-4": (lambda: _sentinels(1 << 14, 64, 11), {"rounds": 4}),
}

# id -> (keys, values, keyword arguments of sort_pairs_distributed)
PAIRS = {
    "stable": (lambda: _dups((1 << 13) - 3, 70), {}),
    "heavy": (lambda: _heavy(1 << 13, 71, 0xCAFEBABE), {}),
    "descending": (lambda: _u32(1 << 12, 72, hi=32), {"descending": True}),
}

# id -> (keys, keyword arguments of sort_distributed_hier)
HIER = {
    "u32-1024": (lambda: _sentinels(1024, 1024, 11), {}),
    "u32-16377": (lambda: _sentinels((1 << 14) - 7, 16377, 11), {}),
    "f32-descending": (lambda: np.concatenate(
        [np.full(32, -0.0, np.float32), _f32(4096 - 32, 82)]),
        {"descending": True}),
    "skewed": (lambda: _heavy(1 << 14, 83, 0xBEEFCAFE), {}),
}

ROUNDS_ENV_KEYS = (lambda: _sentinels(1 << 14, 61, 11))
SIZED = {
    "uniform": lambda: _u32(1 << 14, 21),
    "skewed": lambda: _heavy(1 << 13, 22, 0xDEADBEEF),
}
ROUNDS_SIZED_KEYS = (lambda: _heavy((1 << 14) - 5, 65, 0x1234ABCD, 0.5))
FLAT_KEYS = (lambda: _u32((1 << 13) - 3, 81))


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------


def _t(x):
    return from_numpy(x, "cpu")


def _np_stats(st):
    return stats_to_numpy(st)


def _ranks(rank, world):
    mesh = tdsort.make_mesh(world, device="cpu")
    mesh2 = tdsort.make_mesh_2d(2, world // 2, device="cpu")

    def shard(x):
        return _t(W.shard_of(x, rank, world))

    out = {}
    for key, (make, kw) in SORTS.items():
        x = make()
        o, c, st = tdsort.sort_distributed(shard(x), mesh=mesh, n=len(x),
                                           **kw)
        out["sort", key] = (to_numpy(o), to_numpy(c), _np_stats(st))
    for key, (make, kw) in PAIRS.items():
        k = make()
        v = np.arange(len(k), dtype=np.int32)
        ok, ov, c, st = tdsort.sort_pairs_distributed(
            shard(k), shard(v), mesh=mesh, n=len(k), **kw)
        out["pairs", key] = (to_numpy(ok), to_numpy(ov), to_numpy(c),
                             _np_stats(st))
    for key, (make, kw) in HIER.items():
        x = make()
        o, c, (s1, s2) = tdsort.sort_distributed_hier(
            shard(x), mesh=mesh2, n=len(x), **kw)
        out["hier", key] = (to_numpy(o), to_numpy(c), _np_stats(s1),
                            _np_stats(s2))
    x = FLAT_KEYS()
    o, c, st = tdsort.sort_distributed(shard(x), mesh=mesh2, n=len(x),
                                       axis_name=("host", "chip"))
    out["flat"] = (to_numpy(o), to_numpy(c), _np_stats(st))
    for key, make in SIZED.items():
        x = make()
        o, c, cap, st = tdsort.sort_distributed_sized(shard(x), mesh=mesh,
                                                      n=len(x))
        out["sized", key] = (to_numpy(o), to_numpy(c), cap, _np_stats(st))
    x = ROUNDS_SIZED_KEYS()
    cap = tdsort.round_cap(int(tdsort.exchange_cap_for_sort(
        shard(x), mesh=mesh, n=len(x))))
    o, c, st = tdsort.sort_distributed(shard(x), mesh=mesh, n=len(x),
                                       cap=cap, rounds=4)
    out["rounds-sized"] = (to_numpy(o), to_numpy(c), cap, _np_stats(st))
    os.environ["RS_EXCHANGE_ROUNDS_LANE_BYTES"] = "1024"
    try:
        x = ROUNDS_ENV_KEYS()
        o, c, st = tdsort.sort_distributed(shard(x), mesh=mesh, n=len(x))
        out["rounds-env"] = (to_numpy(o), to_numpy(c), _np_stats(st))
        out["rounds-env-resolved"] = (tdsort.resolve_rounds(1 << 12),
                                      tdsort.resolve_rounds(64))
    finally:
        del os.environ["RS_EXCHANGE_ROUNDS_LANE_BYTES"]
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


@pytest.fixture(scope="module")
def jmesh2():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:NDEV]).reshape(2, NDEV // 2),
                ("host", "chip"))


def _jdsort():
    from cuda.radixsort_tpu.parallel import dsort

    return dsort


def _same_stats(got: dict, st):
    want = stats_to_numpy(st)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert got[k].dtype == w.dtype, k


def _same_blocks(got_blocks, want_global):
    want = blocks(want_global, NDEV)
    for r in range(NDEV):
        np.testing.assert_array_equal(got_blocks[r], want[r],
                                      err_msg=f"rank {r}")


def _check_sort(ranks, key, want, x, descending=False):
    o, c, st = want
    _same_blocks([ranks[r][key][0] for r in range(NDEV)], o)
    for r in range(NDEV):
        np.testing.assert_array_equal(ranks[r][key][1], np.asarray(c))
        _same_stats(ranks[r][key][-1] if key[0] != "hier"
                    else ranks[r][key][2], st)
    got = tdsort.reconstruct_sorted([ranks[r][key][0] for r in range(NDEV)],
                                    ranks[0][key][1], _torch_dtype(x),
                                    len(x), descending=descending)
    want_sorted = np.sort(x)
    np.testing.assert_array_equal(
        got, want_sorted[::-1] if descending else want_sorted)


def _torch_dtype(x):
    return from_numpy(x[:1], "cpu").dtype


@pytest.mark.parametrize("key", list(SORTS))
def test_sort_distributed_matches_jax(ranks, jmesh, key):
    import jax.numpy as jnp

    make, kw = SORTS[key]
    x = make()
    want = _jdsort().sort_distributed(jnp.asarray(x), mesh=jmesh, **kw)
    _check_sort(ranks, ("sort", key), want, x, kw.get("descending", False))
    assert int(ranks[0]["sort", key][1].sum()) == len(x)


def test_heavy_hitter_spreads(ranks):
    # a 70%-mass key must not land on one rank (JAX: test_dsort.py)
    o, c, st = ranks[0]["sort", "heavy-hitter"]
    assert c.max() / c.mean() <= 2.0
    assert float(st["skew"]) <= 2.0
    np.testing.assert_array_equal(st["rows_out"], c)
    assert 0.0 < float(st["cap_utilization"]) <= 1.0


@pytest.mark.parametrize("key", list(PAIRS))
def test_sort_pairs_distributed_matches_jax(ranks, jmesh, key):
    import jax.numpy as jnp

    make, kw = PAIRS[key]
    k = make()
    v = np.arange(len(k), dtype=np.int32)
    ok, ov, c, st = _jdsort().sort_pairs_distributed(
        jnp.asarray(k), jnp.asarray(v), mesh=jmesh, **kw)
    got = [ranks[r]["pairs", key] for r in range(NDEV)]
    _same_blocks([g[0] for g in got], ok)
    _same_blocks([g[1] for g in got], ov)
    for g in got:
        np.testing.assert_array_equal(g[2], np.asarray(c))
        _same_stats(g[3], st)
    # stable: equal keys keep their input order
    gk = np.concatenate([g[0][:g[2][r]] for r, g in enumerate(got)])
    gv = np.concatenate([g[1][:g[2][r]] for r, g in enumerate(got)])
    order = np.argsort(-k.astype(np.int64) if kw else k, kind="stable")
    np.testing.assert_array_equal(gk, k[order])
    np.testing.assert_array_equal(gv, v[order])


@pytest.mark.parametrize("key", list(HIER))
def test_sort_distributed_hier_matches_jax(ranks, jmesh2, key):
    import jax.numpy as jnp

    make, kw = HIER[key]
    x = make()
    o, c, (s1, s2) = _jdsort().sort_distributed_hier(jnp.asarray(x),
                                                     mesh=jmesh2, **kw)
    _check_sort(ranks, ("hier", key), (o, c, s1), x,
                kw.get("descending", False))
    for r in range(NDEV):
        _same_stats(ranks[r]["hier", key][3], s2)


def test_hier_matches_flat_tuple_axis(ranks, jmesh2):
    import jax.numpy as jnp

    x = FLAT_KEYS()
    want = _jdsort().sort_distributed(jnp.asarray(x), mesh=jmesh2,
                                      axis_name=("host", "chip"))
    _check_sort(ranks, "flat", want, x)
    flat = tdsort.reconstruct_sorted([ranks[r]["flat"][0] for r in
                                      range(NDEV)], ranks[0]["flat"][1],
                                     torch.uint32, len(x))
    hier = tdsort.reconstruct_sorted(
        [ranks[r]["hier", "u32-16377"][0] for r in range(NDEV)],
        ranks[0]["hier", "u32-16377"][1], torch.uint32, (1 << 14) - 7)
    np.testing.assert_array_equal(flat, np.sort(x))
    np.testing.assert_array_equal(hier, np.sort(HIER["u32-16377"][0]()))


@pytest.mark.parametrize("key", list(SIZED))
def test_sort_distributed_sized_matches_jax(ranks, jmesh, key):
    import jax.numpy as jnp

    x = SIZED[key]()
    o, c, cap, st = _jdsort().sort_distributed_sized(jnp.asarray(x),
                                                     mesh=jmesh)
    for r in range(NDEV):
        assert ranks[r]["sized", key][2] == cap
    _check_sort(ranks, ("sized", key), (o, c, st), x)
    if key == "uniform":
        assert cap < len(x) // NDEV


def test_round_based_sized_skewed_matches_jax(ranks, jmesh):
    import jax.numpy as jnp

    x = ROUNDS_SIZED_KEYS()
    jd = _jdsort()
    cap = jd.round_cap(int(jd.exchange_cap_for_sort(jnp.asarray(x),
                                                    mesh=jmesh)))
    assert ranks[0]["rounds-sized"][2] == cap
    want = jd.sort_distributed(jnp.asarray(x), mesh=jmesh, cap=cap, rounds=4)
    _check_sort(ranks, "rounds-sized", want, x)


def test_default_routed_rounds_engage(ranks, jmesh, monkeypatch):
    import jax
    import jax.numpy as jnp

    monkeypatch.setenv("RS_EXCHANGE_ROUNDS_LANE_BYTES", "1024")
    assert ranks[0]["rounds-env-resolved"] == (2, 1)
    jax.clear_caches()  # the JAX package reads the variable at trace time
    x = ROUNDS_ENV_KEYS()
    want = _jdsort().sort_distributed(jnp.asarray(x), mesh=jmesh)
    # 2 rounds, each chunk ndev * 2^11 rows: the output is 2 chunks long
    assert ranks[0]["rounds-env"][0].shape[0] == 2 * NDEV * (1 << 11)
    _check_sort(ranks, "rounds-env", want, x)


def test_resolve_rounds_and_round_cap(monkeypatch):
    jd = _jdsort()
    for v in (1, 127, 128, 129, 5000):
        assert tdsort.round_cap(v) == jd.round_cap(v)
    monkeypatch.delenv("RS_EXCHANGE_ROUNDS", raising=False)
    monkeypatch.delenv("RS_EXCHANGE_ROUNDS_LANE_BYTES", raising=False)
    for rows in (64, 1 << 20, 1 << 21):
        assert tdsort.resolve_rounds(rows) == jd.resolve_rounds(rows)
    monkeypatch.setenv("RS_EXCHANGE_ROUNDS", "4")
    assert tdsort.resolve_rounds(64) == jd.resolve_rounds(64) == 4


@pytest.mark.parametrize("nbins", [16, 256, 1024, 1 << 16, 1 << 22])
@pytest.mark.parametrize("crowd", ["uniform", "one-bin", "spare-bin"])
def test_crowded_count_is_exact(nbins, crowd):
    # the routing counts' copies of the bins sum to numpy's bincount (the
    # spare bin nbins, which drops a row, is left out); 2^16 bins take 64
    # copies, 2^22 one
    rng = np.random.default_rng(nbins)
    n = 5000
    idx = rng.integers(0, nbins, size=n)
    if crowd == "one-bin":
        idx[rng.random(n) < 0.9] = nbins // 3
    elif crowd == "spare-bin":
        idx[rng.random(n) < 0.9] = nbins
    got = tdsort._count_crowded(torch.from_numpy(idx), nbins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.bincount(idx, minlength=nbins + 1)[:nbins])


def test_make_mesh_needs_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()  # the ranks run in their own processes
    with pytest.raises(RuntimeError, match="init_process_group"):
        tdsort.make_mesh(1, device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tdsort.make_mesh_2d(1, 1, device="cpu")


# public names of the five JAX parallel/ modules: each is in the port, except
# the JAX types a shard_map body is written with
NOT_PORTED = {"Mesh": "the port takes a torch DeviceMesh",
              "P": "PartitionSpec: ranks pass their shards",
              "shard_map": "each rank runs the body itself"}


@pytest.mark.parametrize("name", ["dsort", "shuffle", "dscan", "dselect",
                                  "stats"])
def test_public_names_match_the_jax_module(name):
    import importlib
    import inspect

    def public(mod):
        return {k: v for k, v in vars(mod).items()
                if not k.startswith("_") and not inspect.ismodule(v)
                and k != "annotations"}

    jmod = importlib.import_module(f"cuda.radixsort_tpu.parallel.{name}")
    tmod = importlib.import_module(
        f"cuda.radixsort_tpu_torch.parallel.{name}")
    theirs, mine = public(jmod), public(tmod)
    missing = sorted(set(theirs) - set(mine) - set(NOT_PORTED))
    assert not missing, f"{name}: not in the port: {missing}"
    for attr, obj in theirs.items():
        if inspect.isclass(obj) and attr in mine:
            gone = sorted(a for a in vars(obj) if not a.startswith("_")
                          and not hasattr(mine[attr], a))
            assert not gone, f"{name}.{attr}: not in the port: {gone}"
