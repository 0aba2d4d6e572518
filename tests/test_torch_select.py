"""The port's radix select vs the JAX package's default CPU engine, bit for
bit: kth_value over every key dtype and both directions, top_k with heavy
threshold ties (taken in row order), sorted and unsorted."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu as rs
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

N = 1200


def _raw(a):
    a = np.asarray(a)
    return a.view(f"uint{a.dtype.itemsize * 8}")


def assert_same(got, want):
    g, w = to_numpy(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(_raw(g), _raw(w))


def _keys(rng, dtype, n=N, distinct=None):
    """Keys with ties: ``distinct`` values drawn n times (full-range values
    for integers; floats with -0.0, infinities and NaN)."""
    dtype = np.dtype(dtype)
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        pool = rng.integers(info.min, info.max, size=distinct or n,
                            endpoint=True, dtype=dtype)
    else:
        pool = (rng.standard_normal(distinct or n) * 100).astype(dtype)
        pool[:4] = [-0.0, np.inf, -np.inf, np.nan]
    return pool[rng.integers(0, pool.shape[0], size=n)]


DTYPES = [np.uint8, np.int16, np.uint32, np.int32, np.float32, np.int64,
          np.uint64, np.float64, np.float16, ml_dtypes.bfloat16]


def _jax_kth(jk, kk):
    """JAX's k-th smallest key. The k-th largest is the (N-1-k)-th
    smallest in the same total order (twiddle space, where the descending
    bits are the ascending ones inverted), so both directions are held to
    JAX's ascending select: one compile per dtype where each direction
    would be one."""
    return rs.kth_value(jk, kk)


@pytest.mark.parametrize("largest", [False, True], ids=["smallest", "largest"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_kth_value_matches_jax(dtype, largest):
    rng = np.random.default_rng(DTYPES.index(dtype) + 20 * largest)
    k = _keys(rng, dtype, distinct=300)
    jk, tk = jnp.asarray(k), from_numpy(k, device="cpu")
    for kk in (0, 1, 77, N // 2, N - 1):
        got = rt.kth_value(tk, kk, largest=largest)
        assert got.dim() == 0
        assert_same(got, _jax_kth(jk, N - 1 - kk if largest else kk))
    # k as a 0-d tensor on the keys' device
    assert_same(rt.kth_value(tk, torch.tensor(5), largest=largest),
                _jax_kth(jk, N - 1 - 5 if largest else 5))


@pytest.mark.parametrize("dtype,largest,sorted_result", [
    (np.int32, True, True), (np.uint32, False, True),
    (np.float32, True, False), (np.int64, False, False),
    (np.float16, True, True)],
    ids=["i32-largest-sorted", "u32-smallest-sorted", "f32-largest-row_order",
         "i64-smallest-row_order", "f16-largest-sorted"])
def test_top_k_matches_jax(dtype, largest, sorted_result):
    rng = np.random.default_rng(7 + 2 * largest + sorted_result)
    k = _keys(rng, dtype, distinct=40)  # ~30 copies of each value
    jk, tk = jnp.asarray(k), from_numpy(k, device="cpu")
    for kk in (45, N):
        wv, wi = rs.top_k(jk, kk, largest=largest, sorted_result=sorted_result)
        gv, gi = rt.top_k(tk, kk, largest=largest, sorted_result=sorted_result)
        assert_same(gv, wv)
        assert_same(gi, wi)
        assert gi.dtype == torch.int32


def test_top_k_takes_threshold_ties_in_row_order():
    k = torch.tensor([5, 9, 5, 1, 5, 9, 5], dtype=torch.int32)
    vals, idx = rt.top_k(k, 4)
    assert vals.tolist() == [9, 9, 5, 5] and idx.tolist() == [1, 5, 0, 2]
    vals, idx = rt.top_k(k, 3, largest=False, sorted_result=False)
    assert vals.tolist() == [5, 5, 1] and idx.tolist() == [0, 2, 3]
