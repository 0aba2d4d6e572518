"""The port's group-by vs the JAX package's default CPU engine: every output
row (the tail past count included) and count. Integer aggregates, counts,
min/max and keys bit for bit; float sums, means, variances and quantiles
within F32_TOL relative (the group's sums may associate differently).
Half-precision values: bfloat16 bit for bit; float16 moments within a
bound derived from each group's row count, against JAX and against a
float64 truth, and float16 quantiles within one ulp."""

import jax.numpy as jnp
import ml_dtypes
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


def _jax_valid(valid, n):
    """JAX's valid= for a port call given ``valid`` (None: every row).
    Every row valid is the same group-by as no mask, and one JAX program
    per aggregate and dtype serves both the masked and unmasked cases, so
    the JAX side always passes a mask."""
    return jnp.asarray(np.ones(n, bool) if valid is None else valid)


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
    jv = _jax_valid(valid, N)
    tv = None if valid is None else from_numpy(valid, device="cpu")
    # int32 values (sums wrap) for the exact aggregates, f32 for the moments
    vals = ints if agg in ("sum", "count", "min", "max") else floats
    want = rs.groupby(jnp.asarray(keys), jnp.asarray(vals), agg=agg, valid=jv)
    got = rt.groupby(from_numpy(keys, device="cpu"), from_numpy(vals, device="cpu"), agg=agg, valid=tv)
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
        got = rt.groupby(from_numpy(keys, device="cpu"), from_numpy(floats, device="cpu"), agg=agg)
        for g, w in zip(got, want):
            assert_close(g, w, exact=True)
    u = ints.view(np.uint32)
    want = rs.groupby(jnp.asarray(keys), jnp.asarray(u), agg="sum")
    got = rt.groupby(from_numpy(keys, device="cpu"), from_numpy(u, device="cpu"), agg="sum")
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
                            valid=_jax_valid(valid, N))
    got = rt.groupby_multi((from_numpy(k1, device="cpu"), from_numpy(k2, device="cpu")),
                           tuple(from_numpy(v, device="cpu") for v in vcols), aggs,
                           valid=None if valid is None else from_numpy(valid, device="cpu"))
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
            (jnp.asarray(keys), from_numpy(keys, device="cpu"), floats),
            ((jnp.asarray(keys), jnp.asarray(keys2)),
             (from_numpy(keys, device="cpu"), from_numpy(keys2, device="cpu")), ints)]:
        want = rs.groupby_quantile(k_j, jnp.asarray(vals), qs,
                                   valid=jnp.asarray(valid))
        got = rt.groupby_quantile(k_t, from_numpy(vals, device="cpu"), qs,
                                  valid=from_numpy(valid, device="cpu"))
        gk, wk = ((got[0], want[0]) if isinstance(got[0], tuple)
                  else ((got[0],), (want[0],)))
        for g, w in zip(gk, wk):
            assert_close(g, w, exact=True)
        assert len(got[1]) == len(qs)
        for g, w in zip(got[1], want[1]):
            assert_close(g, w, exact=False)
        assert_close(got[2], want[2], exact=True)
    with pytest.raises(ValueError):
        rt.groupby_quantile(from_numpy(keys, device="cpu"), from_numpy(floats, device="cpu"), 1.5)


HALF = {"float16": np.float16, "bfloat16": ml_dtypes.bfloat16}


def half_bound(agg, n, big, eps):
    """First-order bound on a group's error, in any summation order, with
    unit roundoff u = eps / 2 and big = max x^2 over the group's n rows:
    the sum of x errs by at most (n - 1) u n sqrt(big), so the mean by
    n u sqrt(big); x^2 rounded and summed, then divided by n, by (n + 1) u
    big; the mean squared and rounded by (2n + 1) u big; the difference's
    rounding by u big. A variance is then within c eps big of the truth,
    c = 3 (n + 1) / 2; a standard deviation within sqrt(c eps big) (since
    |sqrt(a) - sqrt(b)| <= sqrt(|a - b|)) plus its own rounding, eps
    sqrt(big); a mean within c eps sqrt(big)."""
    c = 1.5 * (n + 1)
    if agg == "var":
        return c * eps * big
    if agg == "std":
        return np.sqrt(c * eps * big) + eps * np.sqrt(big)
    return c * eps * np.sqrt(big)


def _half_data(rng, dtype, masked, n=N):
    """97 keys, about 31 rows a group (22 under the mask); values of
    standard deviation 4, so no group's sum of x^2 nears float16's 65504."""
    keys = rng.integers(0, 97, size=n).astype(np.uint32)
    vals = (rng.standard_normal(n) * 4).astype(dtype)
    valid = rng.random(n) < 0.7 if masked else np.ones(n, bool)
    return keys, vals, valid


def _group_truth(keys, vals, valid, agg):
    """Per group, key-ascending: (rows, max x^2, float64 aggregate)."""
    out = []
    x_all = vals.astype(np.float64)
    for k in np.unique(keys[valid]):
        x = x_all[valid & (keys == k)]
        truth = {"mean": x.mean(), "var": x.var(), "std": x.std()}[agg]
        out.append((x.size, float(np.max(x * x)), truth))
    return out


@pytest.mark.parametrize("agg", ["mean", "var", "std"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("dtype", list(HALF))
def test_groupby_half_moments_within_derived_bound(dtype, masked, agg):
    """float16: the port and JAX each within half_bound of the float64
    truth, and of each other within twice it (the two sides' bounds);
    bfloat16: the port equals JAX bit for bit, and both meet the bound."""
    rng = np.random.default_rng(["mean", "var", "std"].index(agg)
                                + 3 * masked + 6 * (dtype == "bfloat16"))
    keys, vals, valid = _half_data(rng, HALF[dtype], masked)
    jv = _jax_valid(valid, N)
    tv = from_numpy(valid, device="cpu") if masked else None
    want = rs.groupby(jnp.asarray(keys), jnp.asarray(vals), agg=agg, valid=jv)
    got = rt.groupby(from_numpy(keys, device="cpu"), from_numpy(vals, device="cpu"), agg=agg, valid=tv)
    assert_close(got[0], want[0], exact=True)
    assert_close(got[2], want[2], exact=True)
    c = int(want[2])
    g = to_numpy(got[1])[:c].astype(np.float64)
    w = np.asarray(want[1])[:c].astype(np.float64)
    assert to_numpy(got[1]).dtype == np.asarray(want[1]).dtype
    truth = _group_truth(keys, vals, valid, agg)
    assert len(truth) == c
    eps = float(ml_dtypes.finfo(HALF[dtype]).eps)
    bounds = np.array([half_bound(agg, n, big, eps) for n, big, _ in truth])
    exact = np.array([t for _, _, t in truth])
    # the margins, for `pytest -k half_moments -s`: worst error over the
    # bound, and the port's distance from JAX in units of eps * max x^2
    unit = np.array([eps * (big if agg == "var" else np.sqrt(big))
                     for _, big, _ in truth])
    print(f"[half] {dtype} {agg} {'valid' if masked else 'all'}: "
          f"port/bound {np.max(np.abs(g - exact) / bounds):.3f}, "
          f"JAX/bound {np.max(np.abs(w - exact) / bounds):.3f}, "
          f"|port - JAX| {np.max(np.abs(g - w) / unit):.3f} units")
    assert (np.abs(g - exact) <= bounds).all(), "port beyond the bound"
    assert (np.abs(w - exact) <= bounds).all(), "JAX beyond the bound"
    if dtype == "bfloat16":
        np.testing.assert_array_equal(g, w)
    else:
        assert (np.abs(g - w) <= 2 * bounds).all()


@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("dtype", list(HALF))
def test_groupby_half_quantiles_within_one_ulp(dtype, masked):
    """Interpolated quantiles of half values: the port within one ulp of
    the value dtype of JAX's (float16), bit for bit (bfloat16)."""
    rng = np.random.default_rng(20 + masked + 2 * (dtype == "bfloat16"))
    keys, vals, valid = _half_data(rng, HALF[dtype], masked)
    qs = (0.1, 0.25, 0.5, 0.9)
    jv = _jax_valid(valid, N)
    tv = from_numpy(valid, device="cpu") if masked else None
    want = rs.groupby_quantile(jnp.asarray(keys), jnp.asarray(vals), qs,
                               valid=jv)
    got = rt.groupby_quantile(from_numpy(keys, device="cpu"), from_numpy(vals, device="cpu"), qs,
                              valid=tv)
    assert_close(got[0], want[0], exact=True)
    assert_close(got[2], want[2], exact=True)
    c = int(want[2])
    for gq, wq in zip(got[1], want[1]):
        g, w = to_numpy(gq)[:c], np.asarray(wq)[:c]
        assert g.dtype == w.dtype == HALF[dtype]
        if dtype == "bfloat16":
            np.testing.assert_array_equal(_raw(g), _raw(w))
        else:
            ulp = np.spacing(np.maximum(np.abs(g), np.abs(w)))
            assert (np.abs(g.astype(np.float64) - w) <= ulp).all()


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
