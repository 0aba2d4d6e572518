"""The port's unique / run-length encoding vs the JAX package's default CPU
engine, bit for bit: every output row (the tail past the count included)
and the count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu as rs
from cuda.radixsort_tpu.ops.unique import _run_starts as j_run_starts
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.ops.unique import _run_starts as t_run_starts
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

N = 2000


def _raw(a):
    a = np.asarray(a)
    return a if a.dtype == np.bool_ else a.view(f"uint{a.dtype.itemsize * 8}")


def assert_same(got, want):
    got, want = tuple(got), tuple(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = to_numpy(g), np.asarray(w)
        if w.ndim == 0:  # counts: int32 here, the JAX default int there
            assert g.dtype == np.int32 and g.ndim == 0 and int(g) == int(w)
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(_raw(g), _raw(w))


def _runs(rng, dtype, n=N):
    """Keys in runs of 1-6 equal values (a few values recur in later runs);
    floats also hold NaN runs and -0.0 beside 0.0."""
    vals = rng.integers(0, 40, size=n)
    reps = rng.integers(1, 7, size=n)
    k = np.repeat(vals, reps)[:n]
    if np.dtype(dtype).kind == "f":
        k = k.astype(dtype) - 20
        k[10:13] = np.nan
        k[20:23] = [0.0, -0.0, 0.0]
        return k
    if np.dtype(dtype).kind == "i":
        return (k - 20).astype(dtype)
    return k.astype(dtype)


DTYPES = [np.uint8, np.int16, np.uint32, np.int32, np.int64, np.uint64,
          np.float32, np.float64]
FNS = ["unique", "run_length_encode", "non_trivial_runs", "distinct"]


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_matches_jax(fn, dtype):
    rng = np.random.default_rng(FNS.index(fn) * 10 + DTYPES.index(dtype))
    k = _runs(rng, dtype)
    if fn == "distinct":
        rng.shuffle(k)
    want = getattr(rs, fn)(jnp.asarray(k))
    got = getattr(rt, fn)(from_numpy(k, device="cpu"))
    assert_same(got, want)


def test_run_starts_match_jax():
    k = _runs(np.random.default_rng(3), np.float32)
    np.testing.assert_array_equal(to_numpy(t_run_starts(from_numpy(k, device="cpu"))),
                                  np.asarray(j_run_starts(jnp.asarray(k))))


@pytest.mark.parametrize("n", [0, 1, 2])
def test_tiny_inputs_match_jax(n):
    k = np.array([7, 7][:n], dtype=np.uint32)
    for fn in FNS:
        assert_same(getattr(rt, fn)(from_numpy(k, device="cpu")),
                    getattr(rs, fn)(jnp.asarray(k)))


def test_run_length_encode_and_distinct_semantics():
    k = torch.tensor([3, 3, 1, 1, 1, 3, 2], dtype=torch.int32)
    uk, lens, count = rt.run_length_encode(k)
    assert int(count) == 4
    assert uk[:4].tolist() == [3, 1, 3, 2]
    assert lens.tolist() == [2, 3, 1, 1, 0, 0, 0]
    offs, lens, nruns = rt.non_trivial_runs(k)
    assert int(nruns) == 2 and offs[:2].tolist() == [0, 2]
    assert lens.tolist() == [2, 3, 0, 0, 0, 0, 0]
    vals, count = rt.distinct(k)
    assert vals[:int(count)].tolist() == [1, 2, 3]
