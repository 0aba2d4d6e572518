"""The port's radix partition vs the JAX package's default CPU engine, bit
for bit: hash32, bucket_ids (by range and by hash) and partition's keys,
payloads and offsets."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

import cuda.radixsort_tpu as rs
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

N = 1500


def _raw(a):
    a = np.asarray(a)
    return a if a.dtype == np.bool_ else a.view(f"uint{a.dtype.itemsize * 8}")


def assert_same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    else:
        g, w = to_numpy(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_raw(g), _raw(w))


def _keys(rng, dtype, n=N):
    """Keys of every kind the hash meets: full-range integers, floats with
    negatives, fractions, NaN, infinities and values past 2^32."""
    dtype = np.dtype(dtype)
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        k = rng.integers(info.min, info.max, size=n, endpoint=True,
                         dtype=dtype)
        k[:2] = [info.min, info.max]
        return k
    k = (rng.standard_normal(n) * 1e3).astype(dtype)
    k[:6] = [np.nan, np.inf, -np.inf, -0.0, 0.5, 6e4]
    if dtype == np.float64:
        k[6:8] = [1e12, 4294967295.7]
    return k


DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32,
          np.uint64, np.int64, np.float16, np.float32, np.float64]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_hash32_and_bucket_ids_match_jax(dtype):
    rng = np.random.default_rng(DTYPES.index(dtype))
    k = _keys(rng, dtype)
    jk, tk = jnp.asarray(k), from_numpy(k, device="cpu")
    assert_same(rt.hash32(tk), rs.hash32(jk))
    width = np.dtype(dtype).itemsize * 8
    for bits in sorted({1, 5, min(8, width), min(32, width)}):
        for by_hash in (False, True):
            assert_same(rt.bucket_ids(tk, bits=bits, by_hash=by_hash),
                        rs.bucket_ids(jk, bits=bits, by_hash=by_hash))


def test_hash32_of_bfloat16_converts_its_value():
    k = np.array([-3.5, 0.0, 1.0, 300.0, 7e9, np.nan],
                 dtype=ml_dtypes.bfloat16)
    assert_same(rt.hash32(from_numpy(k, device="cpu")), rs.hash32(jnp.asarray(k)))


def _payload(rng, shape):
    ints = rng.integers(-2**31, 2**31, size=N, dtype=np.int64).astype(np.int32)
    floats = rng.standard_normal(N).astype(np.float32)
    if shape == "none":
        return None
    if shape == "tensor":
        return ints
    if shape == "tuple":
        return (ints, floats, rng.integers(0, 2**64, size=N, dtype=np.uint64))
    return {"a": ints, "b": floats.astype(np.float16)}


def _to(tree, conv):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: conv(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(conv(v) for v in tree)
    return conv(tree)


@pytest.mark.parametrize("bits", [1, 2, 5, 8])
@pytest.mark.parametrize("by_hash", [False, True], ids=["range", "hash"])
@pytest.mark.parametrize("dtype,payload", [
    (np.uint32, "tensor"), (np.int32, "none"), (np.float32, "tuple"),
    (np.int64, "dict"), (np.uint16, "tensor")],
    ids=["u32", "i32", "f32", "i64", "u16"])
def test_partition_matches_jax(bits, by_hash, dtype, payload):
    rng = np.random.default_rng(bits + 10 * by_hash)
    k = _keys(rng, dtype)
    vals = _payload(rng, payload)
    want = rs.partition(jnp.asarray(k), _to(vals, jnp.asarray), bits=bits,
                        by_hash=by_hash)
    got = rt.partition(from_numpy(k, device="cpu"),
                       _to(vals, lambda v: from_numpy(v, device="cpu")), bits=bits,
                       by_hash=by_hash)
    assert_same(got[0], want[0])
    if vals is None:
        assert got[1] is None and want[1] is None
    else:
        assert_same(got[1], want[1])
    assert_same(got[2], want[2])
    offs = to_numpy(got[2])
    assert offs.shape == (2**bits + 1,) and offs[-1] == N
    assert (np.diff(offs) >= 0).all()


def test_bucket_ids_rejects_bits_out_of_range():
    k = from_numpy(np.arange(8, dtype=np.uint8), device="cpu")
    with pytest.raises(ValueError, match="bits"):
        rt.bucket_ids(k, bits=9)
    with pytest.raises(ValueError, match="bits"):
        rt.bucket_ids(k, bits=0, by_hash=True)
    assert rt.bucket_ids(k, bits=20, by_hash=True).shape == (8,)
