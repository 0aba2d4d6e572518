"""The port's histogram operators vs the JAX package's default CPU engine,
bit for bit: digit_histogram at every digit width and position,
histogram_even (the same float32 bin edges) and histogram_range, with
out-of-range samples dropped."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu as rs
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.ops.histogram import count_bins
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

N = 3000
# JAX's digit_histogram without its outer jit: begin_bit and bits are
# static there, so the jitted form compiles once per digit; its body's ops
# compile once per dtype and its bincount once per bin count
j_digit_histogram = rs.digit_histogram.__wrapped__


def assert_same(got, want):
    g, w = to_numpy(got), np.asarray(want)
    assert g.dtype == np.int32 and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


def _keys(rng, dtype, n=N):
    dtype = np.dtype(dtype)
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, size=n, endpoint=True,
                            dtype=dtype)
    k = (rng.standard_normal(n) * 100).astype(dtype)
    k[:4] = [-0.0, np.inf, -np.inf, np.nan]
    return k


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.uint32, np.int32,
                                   np.float32, np.int64, np.float64,
                                   np.float16],
                         ids=lambda d: np.dtype(d).name)
def test_digit_histogram_matches_jax(dtype):
    rng = np.random.default_rng(np.dtype(dtype).itemsize)
    k = _keys(rng, dtype)
    jk, tk = jnp.asarray(k), from_numpy(k, device="cpu")
    width = np.dtype(dtype).itemsize * 8
    for bits in (1, 2, 3, 4, 5, 8):
        for begin in sorted({0, min(3, width - bits), width - bits}):
            got = rt.digit_histogram(tk, begin_bit=begin, bits=bits)
            assert_same(got, j_digit_histogram(jk, begin_bit=begin,
                                               bits=bits))
            assert int(got.sum()) == N
    if width >= 16:  # wider than the kernel's one-digit route: index_add_
        assert_same(rt.digit_histogram(tk, begin_bit=width - 10, bits=10),
                    j_digit_histogram(jk, begin_bit=width - 10, bits=10))
    with pytest.raises(ValueError, match="digit range"):
        rt.digit_histogram(tk, begin_bit=width - 2, bits=4)


@pytest.mark.parametrize("num_bins", [1, 7, 100, 300])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float16,
                                   ml_dtypes.bfloat16],
                         ids=lambda d: np.dtype(d).name)
def test_histogram_even_matches_jax(num_bins, dtype):
    rng = np.random.default_rng(num_bins)
    s = (rng.standard_normal(N) * 40).astype(dtype)
    if np.dtype(dtype).kind == "f":
        s[:5] = [np.nan, np.inf, -np.inf, -25.0, 25.0]
    for lo, hi in ((-25, 25), (-3.3, 70.1), (0, 1)):
        got = rt.histogram_even(from_numpy(s, device="cpu"), num_bins, lo, hi)
        assert_same(got, rs.histogram_even(jnp.asarray(s), num_bins, lo, hi))


@pytest.mark.parametrize("levels", [
    np.array([-50.0, -10.0, 0.0, 0.5, 3.0, 60.0], dtype=np.float32),
    np.linspace(-90, 90, 301).astype(np.float32),
    np.array([-100, -3, 0, 4, 17, 1000], dtype=np.int32)],
    ids=["5-bins", "300-bins", "int"])
def test_histogram_range_matches_jax(levels):
    rng = np.random.default_rng(len(levels))
    s = (rng.standard_normal(N) * 40).astype(np.float32)
    s[:3] = [np.nan, levels[0], levels[-1]]
    got = rt.histogram_range(from_numpy(s, device="cpu"), from_numpy(levels, device="cpu"))
    assert_same(got, rs.histogram_range(jnp.asarray(s),
                                        jnp.asarray(levels)))


@pytest.mark.parametrize("nbins", [1, 16, 255, 256, 1000])
def test_count_bins_drops_the_spare_bin(nbins):
    rng = np.random.default_rng(nbins)
    idx = torch.from_numpy(rng.integers(0, nbins + 1, size=N))
    want = np.bincount(idx.numpy(), minlength=nbins + 1)[:nbins]
    got = count_bins(idx, nbins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
