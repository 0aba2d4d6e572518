"""The port's comparator sort against the JAX package's, bit for bit.

Both run the same network (p = the next power of two, the same stage
order, edge-copied pads ordered last, a swap only when a pair is strictly
out of order), so the output is fixed by the input and the comparator:
``stable=False`` too must give the JAX bits, since equal keys land where the
network leaves them. Each package gets its own ``less``/``greater`` markers;
custom comparators use plain operators, so one lambda serves both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda.radixsort_tpu.ops import comparator_sort as J
from cuda.radixsort_tpu_torch.ops import comparator_sort as T
from cuda.radixsort_tpu_torch.utils.convert import to_numpy, tree_from_numpy

SIZES = [0, 1, 2, 3, 5, 100, 1000, 4096]


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        g, w = to_numpy(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _both(keys, values=None):
    """The same numpy keys and values as JAX arrays and as CPU tensors."""
    jk = _tree(keys, jnp.asarray)
    tk = tree_from_numpy(keys, device="cpu")
    jv = None if values is None else _tree(values, jnp.asarray)
    tv = None if values is None else tree_from_numpy(values, device="cpu")
    return jk, tk, jv, tv


def _tree(t, f):
    if isinstance(t, dict):
        return {k: _tree(v, f) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_tree(v, f) for v in t)
    return f(t)


def _ints(rng, n, hi, dtype):
    return rng.integers(0, hi, size=n, dtype=np.uint64).astype(dtype)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("stable", [True, False], ids=["stable", "unstable"])
@pytest.mark.parametrize("comp", ["less", "greater", "mod7"])
def test_keys_and_payload(n, stable, comp):
    rng = np.random.default_rng([n, stable])
    keys = _ints(rng, n, 40, np.int32)  # heavy ties
    vals = np.arange(n, dtype=np.int32)
    jk, tk, jv, tv = _both(keys, vals)
    jc, tc = {"less": (J.less, T.less), "greater": (J.greater, T.greater),
              "mod7": ((lambda a, b: (a % 7) < (b % 7)),) * 2}[comp]
    want = J.comparator_sort(jk, jc, values=jv, stable=stable)
    got = T.comparator_sort(tk, tc, values=tv, stable=stable)
    _same(got, want)
    if stable and n:
        order = np.argsort({"less": keys, "greater": -keys,
                            "mod7": keys % 7}[comp], kind="stable")
        np.testing.assert_array_equal(to_numpy(got[1]), order)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.uint64,
                                   np.int64, np.float32, np.float64])
@pytest.mark.parametrize("stable", [True, False], ids=["stable", "unstable"])
def test_primitive_markers_every_dtype(dtype, stable):
    rng = np.random.default_rng(np.dtype(dtype).num)
    n = 777
    if np.dtype(dtype).kind == "f":
        keys = (rng.standard_normal(n) * 4).round().astype(dtype)
        keys[:3] = [np.inf, -0.0, -np.inf]
    else:
        bits = np.iinfo(dtype).bits
        keys = rng.integers(0, 2**64, size=n, dtype=np.uint64).astype(dtype)
        keys[::5] = np.array(2**(bits - 1) + 3, np.uint64).astype(dtype)
    for jc, tc in ((J.less, T.less), (J.greater, T.greater)):
        jk, tk, _, _ = _both(keys)
        _same(T.comparator_sort(tk, tc, stable=stable),
              J.comparator_sort(jk, jc, stable=stable))
        _same(T.comparator_argsort(tk, tc, stable=stable),
              J.comparator_argsort(jk, jc, stable=stable))


def _struct_comp(a, b):
    # score descending, then id ascending
    return (a["score"] > b["score"]) | ((a["score"] == b["score"])
                                        & (a["id"] < b["id"]))


@pytest.mark.parametrize("n", [3, 100, 4096])
@pytest.mark.parametrize("stable", [True, False], ids=["stable", "unstable"])
def test_struct_keys_and_payload_tree(n, stable):
    rng = np.random.default_rng(n)
    keys = {"score": rng.integers(0, 5, n).astype(np.float32),
            "id": rng.integers(0, 3, n).astype(np.int64)}
    vals = (np.arange(n, dtype=np.int32),
            rng.standard_normal((n, 3)).astype(np.float32))
    jk, tk, jv, tv = _both(keys, vals)
    want = J.comparator_sort(jk, _struct_comp, values=jv, stable=stable)
    got = T.comparator_sort(tk, _struct_comp, values=tv, stable=stable)
    _same(got, want)


def test_tuple_keys_with_trailing_dims():
    rng = np.random.default_rng(4)
    n = 333
    keys = (rng.integers(0, 4, (n, 2)).astype(np.int32),
            rng.integers(0, 9, n).astype(np.int16))

    def comp(a, b):
        return ((a[0][:, 0] < b[0][:, 0])
                | ((a[0][:, 0] == b[0][:, 0]) & (a[1] > b[1])))

    jk, tk, _, _ = _both(keys)
    for stable in (True, False):
        _same(T.comparator_sort(tk, comp, stable=stable),
              J.comparator_sort(jk, comp, stable=stable))
        _same(T.comparator_argsort(tk, comp, stable=stable),
              J.comparator_argsort(jk, comp, stable=stable))


def test_float_keys_with_nan():
    keys = np.array([3.0, np.nan, -1.0, np.nan, 0.0, -0.0, 2.0], np.float32)
    jk, tk, _, _ = _both(keys)
    for stable in (True, False):
        _same(T.comparator_argsort(tk, T.less, stable=stable),
              J.comparator_argsort(jk, J.less, stable=stable))


def test_primitive_comparator():
    assert T.primitive_comparator(T.less) == (True, False)
    assert T.primitive_comparator(T.Greater) == (True, True)
    assert T.primitive_comparator(T.Less()) == (True, False)
    assert T.primitive_comparator(lambda a, b: a < b) == (False, False)
    # each package recognises its own markers only
    assert T.primitive_comparator(J.less) == (False, False)


def test_users_comparator_on_unsigned_names_the_dtype():
    keys = torch.arange(10, dtype=torch.int32).view(torch.uint32)
    try:
        keys < keys
    except (RuntimeError, NotImplementedError):
        with pytest.raises(TypeError, match="uint32"):
            T.comparator_sort(keys, lambda a, b: a < b)
    else:  # this torch orders uint32: the comparator simply works
        out = T.comparator_sort(keys, lambda a, b: a > b)
        assert to_numpy(out).tolist() == list(range(9, -1, -1))


@pytest.mark.parametrize("case", ["keys", "values", "empty"])
def test_rejects_bad_structures(case):
    a = torch.arange(5)
    with pytest.raises((ValueError, TypeError)):
        {"keys": lambda: T.comparator_sort((a, a[:4]), T.less),
         "values": lambda: T.comparator_sort(a, T.less, values=a[:3]),
         "empty": lambda: T.comparator_sort((), T.less)}[case]()
