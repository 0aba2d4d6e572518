"""The port's group-by vs the JAX package's default CPU engine: every output
row (the tail past count included) and count. Integer aggregates, counts,
min/max and keys bit for bit; float sums, means, variances and quantiles
within F32_TOL relative (the group's sums may associate differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu as rs
from cuda.radixsort_tpu.models import flagships as jflag
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.models import flagships as tflag
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

N = 3001
F32_TOL = 1e-5


def _raw(a):
    a = np.asarray(a)
    return a if a.dtype == np.bool_ else a.view(f"uint{a.dtype.itemsize * 8}")


def assert_close(got, want, exact, atol=F32_TOL):
    g, w = to_numpy(got), np.asarray(want)
    if w.ndim == 0:
        assert g.ndim == 0 and int(g) == int(w)
    elif not np.issubdtype(w.dtype, np.floating):
        np.testing.assert_array_equal(_raw(g), _raw(w))
    elif exact:  # by value: which NaN's bits a min/max keeps is not fixed
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    else:
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=atol)


def moment_atol(agg, values):
    """var = E[x^2] - E[x]^2 cancels: XLA may fuse the subtraction into an
    FMA, so a variance agrees within F32_TOL of the largest x^2, and a
    standard deviation within the square root of that."""
    big = float(np.max(np.abs(values.astype(np.float64)))) ** 2 * F32_TOL
    return {"var": big, "std": np.sqrt(big)}.get(agg, F32_TOL)


def _data(rng, n=N):
    keys = rng.integers(0, 97, size=n).astype(np.uint32)
    ints = rng.integers(-2**31, 2**31, size=n, dtype=np.int64).astype(np.int32)
    floats = (rng.standard_normal(n) * 50).astype(np.float32)
    return keys, ints, floats


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max", "mean", "var",
                                 "std", "median"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
def test_groupby_matches_jax(agg, masked):
    rng = np.random.default_rng(len(agg) + 10 * masked)
    keys, ints, floats = _data(rng)
    valid = rng.random(N) < 0.7 if masked else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else from_numpy(valid)
    # int32 values (sums wrap) for the exact aggregates, f32 for the moments
    vals = ints if agg in ("sum", "count", "min", "max") else floats
    want = rs.groupby(jnp.asarray(keys), jnp.asarray(vals), agg=agg, valid=jv)
    got = rt.groupby(from_numpy(keys), from_numpy(vals), agg=agg, valid=tv)
    assert_close(got[0], want[0], exact=True)
    assert_close(got[1], want[1], exact=agg in ("count", "min", "max"),
                 atol=moment_atol(agg, vals))
    assert_close(got[2], want[2], exact=True)
    assert got[2].dtype == torch.int32


def test_groupby_float_min_max_and_unsigned_sums():
    rng = np.random.default_rng(41)
    keys, ints, floats = _data(rng)
    floats[:3] = [np.nan, -np.inf, np.inf]
    for agg in ("min", "max"):
        want = rs.groupby(jnp.asarray(keys), jnp.asarray(floats), agg=agg)
        got = rt.groupby(from_numpy(keys), from_numpy(floats), agg=agg)
        for g, w in zip(got, want):
            assert_close(g, w, exact=True)
    u = ints.view(np.uint32)
    want = rs.groupby(jnp.asarray(keys), jnp.asarray(u), agg="sum")
    got = rt.groupby(from_numpy(keys), from_numpy(u), agg="sum")
    for g, w in zip(got, want):
        assert_close(g, w, exact=True)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
def test_groupby_multi_matches_jax(masked):
    rng = np.random.default_rng(43 + masked)
    k1, ints, floats = _data(rng)
    k2 = rng.integers(-2, 2, size=N).astype(np.int64)
    valid = rng.random(N) < 0.6 if masked else None
    aggs = ("sum", "count", "min", "mean", "std")
    vcols = (ints, ints, floats, floats, floats)
    want = rs.groupby_multi((jnp.asarray(k1), jnp.asarray(k2)),
                            tuple(jnp.asarray(v) for v in vcols), aggs,
                            valid=None if valid is None else jnp.asarray(valid))
    got = rt.groupby_multi((from_numpy(k1), from_numpy(k2)),
                           tuple(from_numpy(v) for v in vcols), aggs,
                           valid=None if valid is None else from_numpy(valid))
    for g, w in zip(got[0], want[0]):
        assert_close(g, w, exact=True)
    for g, w, a, v in zip(got[1], want[1], aggs, vcols):
        assert_close(g, w, exact=a in ("sum", "count", "min"),
                     atol=moment_atol(a, v))
    assert_close(got[2], want[2], exact=True)


def test_groupby_quantile_matches_jax():
    rng = np.random.default_rng(47)
    keys, ints, floats = _data(rng)
    keys2 = (keys % 3).astype(np.int32)
    valid = rng.random(N) < 0.8
    qs = (0.0, 0.25, 0.5, 0.9, 1.0)
    for k_j, k_t, vals in [
            (jnp.asarray(keys), from_numpy(keys), floats),
            ((jnp.asarray(keys), jnp.asarray(keys2)),
             (from_numpy(keys), from_numpy(keys2)), ints)]:
        want = rs.groupby_quantile(k_j, jnp.asarray(vals), qs,
                                   valid=jnp.asarray(valid))
        got = rt.groupby_quantile(k_t, from_numpy(vals), qs,
                                  valid=from_numpy(valid))
        gk, wk = ((got[0], want[0]) if isinstance(got[0], tuple)
                  else ((got[0],), (want[0],)))
        for g, w in zip(gk, wk):
            assert_close(g, w, exact=True)
        assert len(got[1]) == len(qs)
        for g, w in zip(got[1], want[1]):
            assert_close(g, w, exact=False)
        assert_close(got[2], want[2], exact=True)
    with pytest.raises(ValueError):
        rt.groupby_quantile(from_numpy(keys), from_numpy(floats), 1.5)


def test_groupby_empty_and_errors():
    e = torch.zeros(0, dtype=torch.int32)
    gk, gv, count = rt.groupby(e, e)
    assert gk.shape == (0,) and int(count) == 0
    with pytest.raises(ValueError):
        rt.groupby(e, e, agg="mode")
    with pytest.raises(ValueError):
        rt.groupby(e, None, agg="median")
    with pytest.raises(ValueError):
        rt.groupby_multi((e,), (e,), ("sum", "max"))


def test_groupby_zipf_flagship_matches_jax():
    gen = torch.Generator().manual_seed(11)
    fn, args = tflag.groupby_zipf(4096, generator=gen, device="cpu")
    jfn, _ = jflag.groupby_zipf(16)
    want = jfn(*[jnp.asarray(to_numpy(a)) for a in args])
    got = fn(*args)
    for g, w in zip(got, want):
        assert_close(g, w, exact=True)
    assert (to_numpy(args[0]) == 42).mean() > 0.4  # the skew is there
