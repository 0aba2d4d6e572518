"""The port's merge and set operations vs the JAX package, bit for bit.

Both merge routes run on the CPU: the network (engine 'bitonic', one
network level, here through the plain version) and rank-scatter (every
other engine). A merge is stable, so its output is one array whichever
route computes it: both port routes are held to JAX's rank-scatter route,
which compiles in a second where JAX's network in interpret mode takes
tens."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

import cuda.radixsort_tpu as rs
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.kernels import bitonic as tb
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, tree_from_numpy
from test_torch_sort import _eq, make_keys

TB = rt.SortConfig(engine="bitonic")
ENGINES = {"bitonic": (TB, None), "radix": (rt.SortConfig(engine="radix"),
                                            None)}


def _sorted(keys, descending=False):
    """keys in the order the sort gives them (floats on twiddled bits)."""
    out = np.asarray(rs.sort(jnp.asarray(keys), descending=descending))
    return out


def _j_merge(jcfg):
    return rs.merge_sorted.__wrapped__ if jcfg else rs.merge_sorted


def _j_merge_pairs(jcfg):
    return (rs.merge_sorted_pairs.__wrapped__ if jcfg
            else rs.merge_sorted_pairs)


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("dtype,descending,na,nb", [
    (np.uint32, False, 700, 300), (np.int64, True, 1024, 1000),
    (np.float32, False, 513, 511), (ml_dtypes.bfloat16, True, 40, 900)])
def test_merge_sorted_matches_jax(engine, dtype, descending, na, nb):
    tcfg, jcfg = ENGINES[engine]
    a = _sorted(make_keys(dtype, n=na, seed=na, distinct=50), descending)
    b = _sorted(make_keys(dtype, n=nb, seed=nb, distinct=50), descending)
    want = _j_merge(jcfg)(jnp.asarray(a), jnp.asarray(b),
                          descending=descending, config=jcfg)
    got = rt.merge_sorted(from_numpy(a, device="cpu"), from_numpy(b, device="cpu"),
                          descending=descending, config=tcfg)
    _eq(got, np.asarray(want))


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("key_dtype,values,descending", [
    (np.uint32, "u32", False),            # 3 planes on the network
    (np.float32, "tuple", True),          # 4 planes
    (np.uint64, "i32", False),            # 4 planes: 2 limbs, index, value
    (np.int32, "f64", False),             # an 8-byte value: rank-scatter
])
def test_merge_sorted_pairs_matches_jax(engine, key_dtype, values,
                                        descending):
    tcfg, jcfg = ENGINES[engine]
    na, nb = 600, 1000
    # many equal keys across the two sides: stability shows in the values
    ka = _sorted(make_keys(key_dtype, n=na, seed=1, distinct=30), descending)
    kb = _sorted(make_keys(key_dtype, n=nb, seed=2, distinct=30), descending)
    va = {"u32": np.arange(na, dtype=np.uint32),
          "i32": np.arange(na, dtype=np.int32),
          "f64": make_keys(np.float64, n=na, seed=3),
          "tuple": (np.arange(na, dtype=np.uint32),
                    make_keys(np.float32, n=na, seed=4))}[values]
    vb = {"u32": np.arange(na, na + nb, dtype=np.uint32),
          "i32": np.arange(na, na + nb, dtype=np.int32),
          "f64": make_keys(np.float64, n=nb, seed=5),
          "tuple": (np.arange(na, na + nb, dtype=np.uint32),
                    make_keys(np.float32, n=nb, seed=6))}[values]
    to_j = (lambda v: tuple(jnp.asarray(x) for x in v)
            if isinstance(v, tuple) else jnp.asarray(v))
    jk, jv = _j_merge_pairs(jcfg)(jnp.asarray(ka), to_j(va), jnp.asarray(kb),
                                  to_j(vb), descending=descending,
                                  config=jcfg)
    tk, tv = rt.merge_sorted_pairs(from_numpy(ka, device="cpu"), tree_from_numpy(va, device="cpu"),
                                   from_numpy(kb, device="cpu"), tree_from_numpy(vb, device="cpu"),
                                   descending=descending, config=tcfg)
    _eq(tk, np.asarray(jk))
    if values == "tuple":
        assert isinstance(tv, tuple)
        for g, w in zip(tv, jv):
            _eq(g, np.asarray(w))
    else:
        _eq(tv, np.asarray(jv))


def test_merge_routes_follow_the_engine(monkeypatch):
    calls = []
    orig = tb.merge_sorted_planes_bitonic
    monkeypatch.setattr(tb, "merge_sorted_planes_bitonic",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    a = from_numpy(np.arange(5, dtype=np.uint32), device="cpu")
    b = from_numpy(np.arange(3, dtype=np.uint32), device="cpu")
    rt.merge_sorted(a, b)
    rt.merge_sorted_pairs(a, a, b, b, config=rt.SortConfig(engine="radix"))
    assert calls == []
    rt.merge_sorted(a, b, config=TB)
    rt.merge_sorted_pairs(a, a, b, b, config=TB)
    assert len(calls) == 2


def test_merge_edge_cases():
    a = from_numpy(np.array([1, 5, 9], dtype=np.int32), device="cpu")
    e = from_numpy(np.array([], dtype=np.int32), device="cpu")
    for cfg in (TB, None):
        _eq(rt.merge_sorted(a, e, config=cfg), np.array([1, 5, 9], np.int32))
        k, v = rt.merge_sorted_pairs(e, {"x": e}, a, {"x": a}, config=cfg)
        _eq(k, np.array([1, 5, 9], np.int32))
        _eq(v["x"], np.array([1, 5, 9], np.int32))
    with pytest.raises(TypeError):
        rt.merge_sorted(a, from_numpy(np.array([1], dtype=np.int64), device="cpu"))
    with pytest.raises(TypeError):
        rt.merge_sorted_pairs(a, a, a, (a,))


SET_OPS = ["set_intersection", "set_difference", "set_union",
           "set_symmetric_difference"]


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("op", SET_OPS)
def test_set_ops_match_jax(op, engine):
    tcfg, _ = ENGINES[engine]
    rng = np.random.default_rng(61)
    for dtype, descending in ((np.uint32, False), (np.float32, True),
                              (np.int64, False)):
        a = make_keys(dtype, n=500, seed=7, distinct=60)
        b = make_keys(dtype, n=300, seed=8, distinct=60)
        if dtype == np.uint32:  # the largest key, kept and dropped
            a[:5] = np.uint32(0xFFFFFFFF)
            b[:2] = np.uint32(0xFFFFFFFF)
            b[2:] = rng.permutation(b[2:])
        a, b = _sorted(a, descending), _sorted(b, descending)
        jo, jc = getattr(rs, op)(jnp.asarray(a), jnp.asarray(b),
                                 descending=descending)
        to, tc = getattr(rt, op)(from_numpy(a, device="cpu"), from_numpy(b, device="cpu"),
                                 descending=descending, config=tcfg)
        c = int(jc)
        assert int(tc) == c and tc.dim() == 0
        assert to.shape[0] == np.asarray(jo).shape[0]
        _eq(to[:c], np.asarray(jo)[:c])
