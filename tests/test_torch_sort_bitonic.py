"""The port's sort API on the network engine vs the JAX package.

The port runs SortConfig(engine="bitonic"). Where the result is one array
whatever sorts it (keys only, argsort, stable pairs and structs: a stable
sort has one output), the reference is JAX's default engine, which
compiles in a second. Unstable pairs, whose tie order is the network's
own, and the tag route (ties by the tag), are held to the JAX network
engine in interpret mode: its public
functions' bodies without their outer jit (``__wrapped__``), so its
network kernel compiles once per plane count and padded size instead of
once per dtype. Everything is compared bit for bit, unstable pairs
included: the port runs the JAX network, so equal keys' payloads land in
the same places. N = 1000 pads to 1024 rows; 1024 is a power of two (the
tie-safe route)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu as rs
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.kernels import bitonic as tb
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, tree_from_numpy
from test_torch_sort import KEY_DTYPES, _eq, make_keys

JB = rs.SortConfig(engine="bitonic", interpret=True)
JS = rs.SortConfig()  # JAX's default engine: the reference of unique results
TB = rt.SortConfig(engine="bitonic")
j_sort = rs.sort.__wrapped__
j_pairs = rs.sort_pairs.__wrapped__
j_struct = rs.sort_struct.__wrapped__
N, NPOW = 1000, 1024


def _j(tree):
    if isinstance(tree, dict):
        return {k: jnp.asarray(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jnp.asarray(v) for v in tree)
    return jnp.asarray(tree)


def _eq_tree(got, want):
    if isinstance(want, dict):
        for k in want:
            _eq(got[k], np.asarray(want[k]))
    elif isinstance(want, (list, tuple)):
        for g, w in zip(got, want):
            _eq(g, np.asarray(w))
    else:
        _eq(got, np.asarray(want))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", KEY_DTYPES, ids=lambda d: np.dtype(d).name)
def test_sort_matches_jax_network(dtype, descending):
    # ascending: a padded size; descending: a power of two
    keys = make_keys(dtype, n=NPOW if descending else N, seed=5)
    want = rs.sort(jnp.asarray(keys), descending=descending, config=JS)
    _eq(rt.sort(from_numpy(keys, device="cpu"), descending=descending, config=TB),
        np.asarray(want))


PAIR_CASES = {
    # name: (key dtype, n, distinct keys, values, stable, unique tag)
    "stable u32 + f32": (np.uint32, N, 40, [np.float32], True, False),
    "stable u64 + i32, 4 planes": (np.uint64, N, 50, [np.int32], True, False),
    "stable f32 + (u8, bool), widened": (np.float32, NPOW, 30,
                                         [np.uint8, np.bool_], True, False),
    "tag u32 + (tag, i32)": (np.uint32, N, 30, ["tag", np.int32], True, True),
    "unstable u32 + u32, tie-safe": (np.uint32, NPOW, 20, [np.uint32], False,
                                     False),
    "unstable u32 + u32, padded": (np.uint32, N, 20, [np.uint32], False,
                                   False),
    "unstable u64 + f32, tie-safe": (np.uint64, NPOW, 16, [np.float32], False,
                                     False),
    "unstable constant keys": (np.int32, NPOW, 1, [np.uint32], False, False),
    "unstable i64 + u32 padded": (np.int64, N, 40, [np.uint32], False, False),
}


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_sort_pairs_matches_jax_network(case, descending):
    dtype, n, distinct, vdtypes, stable, tag = PAIR_CASES[case]
    keys = make_keys(dtype, n=n, seed=7, distinct=distinct)
    rng = np.random.default_rng(9)
    vals = []
    for i, vd in enumerate(vdtypes):
        if vd == "tag":  # unique, not increasing: ties order by the tag
            vals.append(rng.permutation(n).astype(np.uint32))
        elif vd == np.bool_:
            vals.append(rng.random(n) < 0.5)
        else:
            vals.append(make_keys(vd, n=n, seed=11 + i))
    vals = tuple(vals)
    # one output but for unstable pairs and the tag route (which orders
    # ties by the tag on the network, stably on every other engine)
    unique = stable and not tag
    jk, jv = (rs.sort_pairs if unique else j_pairs)(
        jnp.asarray(keys), _j(vals), descending=descending,
        config=JS if unique else JB, stable=stable,
        unique_leading_payload=tag)
    tk, tv = rt.sort_pairs(from_numpy(keys, device="cpu"), tree_from_numpy(vals, device="cpu"),
                           descending=descending, config=TB, stable=stable,
                           unique_leading_payload=tag)
    _eq(tk, np.asarray(jk))
    _eq_tree(tv, jv)


@pytest.mark.parametrize("dtype,descending", [
    (np.uint32, False), (np.float32, True), (np.int16, False),
    (np.uint64, True), (np.float64, False)])
def test_argsort_matches_jax_network(dtype, descending):
    keys = make_keys(dtype, n=N, seed=13, distinct=300)
    want = rs.argsort(jnp.asarray(keys), descending=descending, config=JS)
    got = rt.argsort(from_numpy(keys, device="cpu"), descending=descending, config=TB)
    assert got.dtype == torch.int32
    _eq(got, np.asarray(want))


@pytest.mark.parametrize("stable", [True, False])
def test_sort_struct_matches_jax_network(stable):
    hi = make_keys(np.uint32, n=NPOW, seed=17, distinct=4)
    lo = make_keys(np.int32, n=NPOW, seed=19, distinct=4)
    v = make_keys(np.float32, n=NPOW, seed=23)
    (jh, jl), jv = (rs.sort_struct if stable else j_struct)(
        (jnp.asarray(hi), jnp.asarray(lo)), jnp.asarray(v),
        config=JS if stable else JB, stable=stable)
    (th, tl), tv = rt.sort_struct((from_numpy(hi, device="cpu"), from_numpy(lo, device="cpu")),
                                  from_numpy(v, device="cpu"), config=TB, stable=stable)
    for g, w in ((th, jh), (tl, jl), (tv, jv)):
        _eq(g, np.asarray(w))
    keys_only = rt.sort_struct((from_numpy(hi, device="cpu"), from_numpy(lo, device="cpu")), config=TB)
    for g, w in zip(keys_only, rs.sort_struct((jnp.asarray(hi), jnp.asarray(lo)),
                                              config=JS)):
        _eq(g, np.asarray(w))


def test_split_sort_merge_matches_jax(monkeypatch):
    """A 2^13 padded size a quarter empty takes split-sort-merge: the JAX
    engine from RS_SPLIT_SORT_MIN_LOGN, the port from its config field."""
    monkeypatch.setenv("RS_SPLIT_SORT_MIN_LOGN", "12")
    cfg = TB.replace(split_sort_min_logn=12)
    merges = []
    orig = tb.merge_sorted_planes_bitonic
    monkeypatch.setattr(tb, "merge_sorted_planes_bitonic",
                        lambda *a, **k: merges.append(1) or orig(*a, **k))
    n = 4096 + 700
    keys = make_keys(np.uint32, n=n, seed=29, distinct=60)
    v = make_keys(np.int32, n=n, seed=31)
    _eq(rt.sort(from_numpy(keys, device="cpu"), config=cfg),
        np.asarray(rs.sort(jnp.asarray(keys), config=JS)))
    tk, tv = rt.sort_pairs(from_numpy(keys, device="cpu"), from_numpy(v, device="cpu"), config=cfg)
    jk, jv = rs.sort_pairs(jnp.asarray(keys), jnp.asarray(v), config=JS)
    _eq(tk, np.asarray(jk))
    _eq(tv, np.asarray(jv))
    # unstable and padded: every plane compares, so the result is the
    # (key, value) order, whatever the route
    tk, tv = rt.sort_pairs(from_numpy(keys, device="cpu"), from_numpy(v, device="cpu"), config=cfg,
                           stable=False)
    o = np.lexsort((v.view(np.uint32), keys))
    _eq(tk, keys[o])
    _eq(tv, v[o])
    assert len(merges) == 3
    # below the threshold the padded network runs
    _eq(rt.sort(from_numpy(keys, device="cpu"), config=TB), np.sort(keys))
    assert len(merges) == 3


def test_fallbacks_take_the_stable_radix_path(monkeypatch):
    """Shapes the JAX engine sends to its stable fallback never reach the
    network here, and give the same result."""
    def no_network(*a, **k):
        raise AssertionError("the network ran")
    monkeypatch.setattr(tb, "sort_planes_bitonic", no_network)
    keys = make_keys(np.uint32, n=N, seed=37, distinct=50)
    k64 = make_keys(np.uint64, n=N, seed=41, distinct=50)
    idx = np.arange(N, dtype=np.uint32)
    f64 = make_keys(np.float64, n=N, seed=43)
    cases = [
        (keys, idx, dict(begin_bit=3, end_bit=20)),     # a bit range
        (keys, f64, {}),                                 # an 8-byte payload
        (k64, (idx, idx, idx), {}),                      # 6 planes
        (make_keys(np.uint8, n=N, seed=47), idx, {}),    # a narrow key
    ]
    for k, v, kw in cases:
        jk, jv = j_pairs(jnp.asarray(k), _j(v), config=JB, **kw)
        tk, tv = rt.sort_pairs(from_numpy(k, device="cpu"), tree_from_numpy(v, device="cpu"), config=TB,
                               **kw)
        _eq(tk, np.asarray(jk))
        _eq_tree(tv, jv)
    _eq(rt.sort(from_numpy(keys, device="cpu"), end_bit=9, config=TB),
        np.asarray(j_sort(jnp.asarray(keys), end_bit=9, config=JB)))


@pytest.mark.parametrize("op", ["join inner", "join full", "groupby mean"])
def test_operators_on_the_network_equal_radix(op):
    # the join sorts (key, position tag, value) with the tag as tie-break
    # and the group-by sorts stable pairs: tags increase in input order, so
    # both give the radix engine's bits
    rng = np.random.default_rng(53)
    bk = from_numpy(rng.permutation(300).astype(np.uint32), device="cpu")
    bv = from_numpy(rng.integers(-100, 100, 300).astype(np.int32), device="cpu")
    pk = from_numpy(rng.integers(0, 400, 700).astype(np.uint32), device="cpu")
    if op == "groupby mean":
        run = lambda cfg: rt.groupby(pk, bv.repeat(3)[:700], agg="mean",
                                     config=cfg)
    else:
        run = lambda cfg: rt.join(bk, bv, pk, how=op.split()[1], config=cfg)
    for g, w in zip(run(TB), run(None)):
        assert torch.equal(g, w), op
