"""The port's thrust-shaped API against the JAX package's, function by
function.

The same numpy inputs go through ``cuda.radixsort_tpu.thrust_compat`` (JAX
arrays) and ``cuda.radixsort_tpu_torch.thrust_compat`` (CPU tensors, the
kernels' plain versions). Tolerance: sorts, permutations, integer results,
indices and counts bit for bit (a 0-d count by value: JAX under x64 sums an
int32 mask to int64, the port keeps int32), ``sort`` with a custom
comparator (the network's unstable order) included; a float32 sum or scan
within F32_TOL = 1e-5 of the sum of |x| over its prefix: the two add in
different orders, and the rounding error of a sum of n float32 terms of
random sign grows like sqrt(n) * eps * sum|x| (7.6e-6 at 4096 rows).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda.radixsort_tpu import thrust_compat as jthrust
from cuda.radixsort_tpu_torch import thrust_compat as tthrust
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

F32_TOL = 1e-5
J = types.SimpleNamespace(th=jthrust, arr=jnp.asarray, maximum=jnp.maximum,
                          minimum=jnp.minimum)
T = types.SimpleNamespace(th=tthrust, arr=lambda x: from_numpy(x, device="cpu"),
                          maximum=torch.maximum, minimum=torch.minimum)
SIZES = [1, 2, 3, 1000]


def _np(x):
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, f32_scale=None):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k], f32_scale)
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, f32_scale)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.ndim == 0 and w.dtype.kind in "iub":
        assert int(g) == int(w)
        return
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    if f32_scale is not None and w.dtype.kind == "f":
        bound = np.broadcast_to(F32_TOL * np.asarray(f32_scale, np.float64),
                                w.shape)
        fin = np.isfinite(w)  # identities of empty runs: exact
        np.testing.assert_array_equal(g[~fin], w[~fin])
        np.testing.assert_array_less(
            np.abs(g[fin].astype(np.float64) - w[fin]), bound[fin] + 1e-30)
    else:
        np.testing.assert_array_equal(g, w)


def both(fn, f32_scale=None):
    got = fn(T)
    _same(got, fn(J), f32_scale)
    return got


def _u32(rng, n, hi=2**32):
    return rng.integers(0, hi, size=n, dtype=np.uint64).astype(np.uint32)


def _by_score(a, b):  # score descending, then id ascending
    return (a["score"] > b["score"]) | ((a["score"] == b["score"])
                                        & (a["id"] < b["id"]))


@pytest.mark.parametrize("n", SIZES + [4096])
def test_sort_family(n):
    rng = np.random.default_rng(n)
    k = _u32(rng, n, 60)  # heavy ties
    ki = k.astype(np.int32)
    v = np.arange(n, dtype=np.int32)
    for name in ("sort", "stable_sort"):
        both(lambda p: getattr(p.th, name)(p.arr(k)))
        both(lambda p: getattr(p.th, name)(p.arr(k), p.th.greater))
        # a custom comparator: the comparator network, unstable for sort
        both(lambda p: getattr(p.th, name)(p.arr(ki),
                                           lambda a, b: (a % 7) < (b % 7)))
    for name in ("sort_by_key", "stable_sort_by_key"):
        both(lambda p: getattr(p.th, name)(p.arr(k), p.arr(v)))
        both(lambda p: getattr(p.th, name)(p.arr(k), p.arr(v),
                                           p.th.greater))
        both(lambda p: getattr(p.th, name)(
            p.arr(ki), {"v": p.arr(v), "w": p.arr(v.astype(np.float32))},
            lambda a, b: (a % 5) > (b % 5)))


def test_sort_struct_keys():
    rng = np.random.default_rng(1)
    n = 500
    rec = {"score": rng.integers(0, 4, n).astype(np.float32),
           "id": rng.integers(0, 3, n).astype(np.int32)}
    v = np.arange(n, dtype=np.int32)
    for name in ("sort", "stable_sort"):
        both(lambda p: getattr(p.th, name)(
            {c: p.arr(a) for c, a in rec.items()}, _by_score))
    both(lambda p: p.th.stable_sort_by_key(
        {c: p.arr(a) for c, a in rec.items()}, p.arr(v), _by_score))


def test_sort_by_key_2d_values():
    """(N, 3) float columns split into planes; (N, 16) and 8-byte 2-D
    leaves take the argsort route; keys unique, so every route is exact."""
    rng = np.random.default_rng(2)
    n = 700
    k = rng.permutation(np.arange(1000, dtype=np.uint32))[:n]
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    v = np.arange(n, dtype=np.int32)
    wide = rng.standard_normal((n, 16)).astype(np.float32)
    w64 = rng.integers(-2**60, 2**60, size=(n, 2), dtype=np.int64)
    u2 = _u32(rng, 2 * n).reshape(n, 2)
    for vals in (pts, {"v": v, "pts": pts}, wide, w64, u2, (v, u2)):
        for name in ("sort_by_key", "stable_sort_by_key"):
            both(lambda p: getattr(p.th, name)(
                p.arr(k), _tree(vals, p.arr), p.th.greater))


def _tree(t, f):
    if isinstance(t, dict):
        return {k: _tree(v, f) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_tree(v, f) for v in t)
    return f(t)


@pytest.mark.parametrize("n", SIZES)
def test_is_sorted(n):
    rng = np.random.default_rng(n + 3)
    x = np.sort(_u32(rng, n, 100))
    y = x.copy()
    y[n // 2] = 1000
    for a in (x, y, x[::-1].copy()):
        both(lambda p: p.th.is_sorted(p.arr(a)))
        both(lambda p: p.th.is_sorted(p.arr(a), p.th.greater))
        if n > 1:  # JAX's argmax of no pairs raises
            both(lambda p: p.th.is_sorted_until(p.arr(a)))
            both(lambda p: p.th.is_sorted_until(p.arr(a), p.th.greater))
    assert int(tthrust.is_sorted_until(T.arr(x[:1]))) == min(n, 1)


@pytest.mark.parametrize("desc", [False, True])
def test_merge_and_sets(desc):
    rng = np.random.default_rng(4)
    a, b = np.sort(_u32(rng, 900, 200)), np.sort(_u32(rng, 600, 200))
    comp = "greater" if desc else "less"
    if desc:
        a, b = a[::-1].copy(), b[::-1].copy()
    va, vb = np.arange(900, dtype=np.int32), -np.arange(600, dtype=np.int32)
    both(lambda p: p.th.merge(p.arr(a), p.arr(b), getattr(p.th, comp)))
    both(lambda p: p.th.merge_by_key(p.arr(a), p.arr(va), p.arr(b),
                                     p.arr(vb), getattr(p.th, comp)))
    if not desc:
        for name in ("set_intersection", "set_union", "set_difference",
                     "set_symmetric_difference"):
            both(lambda p: getattr(p.th, name)(p.arr(a), p.arr(b)))
    with pytest.raises(NotImplementedError):
        tthrust.merge(T.arr(a), T.arr(b), lambda x, y: x < y)
    with pytest.raises(NotImplementedError):
        tthrust.merge_by_key(T.arr(a), T.arr(va), T.arr(b), T.arr(vb),
                             lambda x, y: x < y)


@pytest.mark.parametrize("n", SIZES)
def test_unique_and_partition(n):
    rng = np.random.default_rng(n + 5)
    x = np.sort(rng.integers(0, 30, n)).astype(np.int32)
    v = rng.standard_normal(n).astype(np.float32)
    both(lambda p: p.th.unique(p.arr(x)))
    both(lambda p: p.th.unique_by_key(p.arr(x), p.arr(v)))
    both(lambda p: p.th.unique_count(p.arr(x)))
    pred = lambda a: a % 3 == 1  # noqa: E731
    for name in ("copy_if", "remove_if", "stable_partition", "partition",
                 "partition_copy"):
        both(lambda p: getattr(p.th, name)(p.arr(x), pred))
    px = np.concatenate([x[x % 3 == 1], x[x % 3 != 1]])
    both(lambda p: p.th.partition_point(p.arr(px), pred))


def _values(dtype, rng, n):
    if dtype == np.float32:
        return (rng.standard_normal(n) * 100).astype(np.float32)
    if dtype == np.uint32:
        return _u32(rng, n)
    return rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(dtype)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
def test_reduce_scan_count(n, dtype):
    rng = np.random.default_rng([n, np.dtype(dtype).num])
    x = _values(dtype, rng, n)
    x[rng.integers(0, n, 2)] = x[0]
    total = np.abs(x.astype(np.float64)).sum()
    prefix = np.cumsum(np.abs(x.astype(np.float64))) + 3
    both(lambda p: p.th.reduce(p.arr(x)), total)
    both(lambda p: p.th.reduce(p.arr(x), 3), total + 3)
    both(lambda p: p.th.inclusive_scan(p.arr(x)), prefix)
    both(lambda p: p.th.exclusive_scan(p.arr(x), 3), prefix)
    both(lambda p: p.th.count(p.arr(x), x[0]))
    both(lambda p: p.th.find(p.arr(x), x[-1]))
    both(lambda p: p.th.find(p.arr(x), 12345))
    both(lambda p: p.th.replace(p.arr(x), x[0], 7))
    both(lambda p: p.th.fill(p.arr(x), 9))
    both(lambda p: p.th.reverse(p.arr(x)))
    both(lambda p: p.th.adjacent_difference(p.arr(x)))
    for name in ("min_element", "max_element"):
        both(lambda p: getattr(p.th, name)(p.arr(x)))
        both(lambda p: getattr(p.th, name)(p.arr(x), p.th.greater))
    if dtype == np.uint32:  # the user's ops: CPU torch has no uint32 max
        return
    both(lambda p: p.th.reduce(p.arr(x), x[0], p.maximum))
    both(lambda p: p.th.inclusive_scan(p.arr(x), p.maximum))
    both(lambda p: p.th.exclusive_scan(p.arr(x), -5, p.minimum))
    both(lambda p: p.th.count_if(p.arr(x), lambda a: a > 0))
    both(lambda p: p.th.replace_if(p.arr(x), lambda a: a < 0, 0))
    both(lambda p: p.th.find_if(p.arr(x), lambda a: a > x[-1]))
    both(lambda p: p.th.adjacent_difference(p.arr(x),
                                            lambda a, b: a * 2 - b))
    for name in ("all_of", "any_of", "none_of"):
        both(lambda p: getattr(p.th, name)(p.arr(x), lambda a: a > -50))
    for name in ("min_element", "max_element"):
        both(lambda p: getattr(p.th, name)(p.arr(x),
                                           lambda a, b: (a % 7) < (b % 7)))


@pytest.mark.parametrize("op", ["sum", "min", "max", "prod"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_reduce_by_key(op, dtype):
    rng = np.random.default_rng(6)
    n = 1000
    k = np.sort(rng.integers(0, 100, n)).astype(np.int32)
    v = rng.integers(-3, 4, n).astype(dtype)
    both(lambda p: p.th.reduce_by_key(p.arr(k), p.arr(v), op),
         np.full(n, 1e3))


@pytest.mark.parametrize("n", SIZES)
def test_scans_by_key(n):
    rng = np.random.default_rng(n + 7)
    k = np.sort(rng.integers(0, max(1, n // 9), n)).astype(np.int32)
    v = rng.integers(-100, 100, n).astype(np.int32)
    both(lambda p: p.th.inclusive_scan_by_key(p.arr(k), p.arr(v)))
    both(lambda p: p.th.inclusive_scan_by_key(p.arr(k), p.arr(v), "max"))
    both(lambda p: p.th.exclusive_scan_by_key(p.arr(k), p.arr(v), 4))
    both(lambda p: p.th.exclusive_scan_by_key(
        p.arr(k), p.arr(v), 4, p.maximum, identity=-2**31))
    both(lambda p: p.th.inclusive_scan_by_key(
        p.arr(k), p.arr(v), binary_pred=lambda a, b: (a // 2) == (b // 2)))


def test_gather_scatter_sequence_bounds():
    rng = np.random.default_rng(8)
    n = 1000
    src = _u32(rng, n)
    perm = rng.permutation(n).astype(np.int32)
    both(lambda p: p.th.gather(p.arr(perm), p.arr(src)))
    both(lambda p: p.th.scatter(p.arr(src), p.arr(perm), n))
    both(lambda p: p.th.scatter(p.arr(src[:10]), p.arr(perm[:10]), n))
    for dtype in (torch.int32, torch.uint32, torch.float32, torch.int64):
        jd = {torch.int32: jnp.int32, torch.uint32: jnp.uint32,
              torch.float32: jnp.float32, torch.int64: jnp.int64}[dtype]
        _same(tthrust.sequence(1000, 5, 3, dtype, device="cpu"),
              jthrust.sequence(1000, 5, 3, jd))
    _same(tthrust.sequence(7, 2**32 - 3, 1, torch.uint32, device="cpu"),
          jthrust.sequence(7, 2**32 - 3, 1, jnp.uint32))
    s = np.sort(_u32(rng, 4000, 500))
    q = _u32(rng, 999, 520)
    for name in ("lower_bound", "upper_bound", "binary_search"):
        both(lambda p: getattr(p.th, name)(p.arr(s), p.arr(q)))
        both(lambda p: getattr(p.th, name)(p.arr(s[::-1].copy()), p.arr(q),
                                           p.th.greater))
    f = np.sort(rng.standard_normal(300).astype(np.float32))
    both(lambda p: p.th.lower_bound(p.arr(f), p.arr(f[::3] + 0.001)))
    with pytest.raises(NotImplementedError):
        tthrust.lower_bound(T.arr(s), T.arr(q), lambda a, b: a < b)


def test_transform_family():
    rng = np.random.default_rng(9)
    a, b = _values(np.int32, rng, 500), _values(np.int32, rng, 500)
    f = _values(np.float32, rng, 500)
    both(lambda p: p.th.for_each(p.arr(a), lambda x: x * 3 - 1))
    both(lambda p: p.th.transform(lambda x, y: x ^ y, p.arr(a), p.arr(b)))
    both(lambda p: p.th.transform_reduce(p.arr(a), lambda x: x % 11, 0,
                                         p.maximum))
    both(lambda p: p.th.transform_inclusive_scan(p.arr(a), lambda x: x // 4,
                                                 p.maximum))
    both(lambda p: p.th.transform_exclusive_scan(p.arr(a), lambda x: -x, 7,
                                                 p.minimum))
    _same(tthrust.tabulate(100, lambda i: i * i, device="cpu"),
          jthrust.tabulate(100, lambda i: i * i))
    both(lambda p: p.th.inner_product(p.arr(a), p.arr(b), 5))
    both(lambda p: p.th.inner_product(p.arr(f), p.arr(f)),
         (f.astype(np.float64) ** 2).sum())
    both(lambda p: p.th.mismatch(p.arr(a), p.arr(a)))
    c = a.copy()
    c[321] += 1
    both(lambda p: p.th.mismatch(p.arr(a), p.arr(c)))
    both(lambda p: p.th.equal(p.arr(a), p.arr(c)))
    both(lambda p: p.th.equal(p.arr(a), p.arr(a)))
    x, y = tthrust.swap_ranges(T.arr(a), T.arr(b))
    _same((x, y), (b, a))


def test_empty_inputs():
    """n = 0 through the port: empty outputs, zero counts, len(x) for a
    search that finds nothing."""
    e = T.arr(np.zeros(0, np.int32))
    assert tthrust.sort(e).shape == (0,)
    assert tthrust.sort(e, lambda a, b: a < b).shape == (0,)
    assert int(tthrust.copy_if(e, lambda a: a > 0)[1]) == 0
    assert tthrust.inclusive_scan(e).shape == (0,)
    assert tthrust.exclusive_scan(e, 3, torch.maximum).shape == (0,)
    assert int(tthrust.find(e, 1)) == 0
    assert int(tthrust.is_sorted_until(e)) == 0
    assert bool(tthrust.is_sorted(e))
    assert tthrust.sequence(0, device="cpu").shape == (0,)
