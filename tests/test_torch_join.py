"""The port's joins vs the JAX package's default CPU engine, bit for bit:
every output row (the tail past count included) and count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu as rs
from cuda.radixsort_tpu.models import flagships as jflag
from cuda.radixsort_tpu.ops.join import join_count as jjoin_count
from cuda.radixsort_tpu.ops.join import join_expand as jjoin_expand
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.models import flagships as tflag
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

NB, NP = 700, 2100


def _raw(a):
    a = np.asarray(a)
    return a if a.dtype == np.bool_ else a.view(f"uint{a.dtype.itemsize * 8}")


def assert_outputs_equal(got, want):
    got, want = tuple(got), tuple(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            assert_outputs_equal(g, w)
            continue
        g, w = to_numpy(g), np.asarray(w)
        if w.ndim == 0:  # counts: int32 here, the JAX default int there
            assert g.dtype == np.int32 and g.ndim == 0
            assert int(g) == int(w)
        else:
            np.testing.assert_array_equal(_raw(g), _raw(w))


def _tables(rng, key_dtype=np.uint32):
    """Build keys with duplicates (the last one wins) and probe keys of
    which about a third find no build row."""
    bk = rng.integers(0, 600, size=NB).astype(key_dtype)
    bv = rng.integers(-2**31, 2**31, size=NB, dtype=np.int64).astype(np.int32)
    pk = rng.integers(0, 900, size=NP).astype(key_dtype)
    return bk, bv, pk


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti", "right",
                                 "full"])
def test_join_matches_jax(how):
    rng = np.random.default_rng(["inner", "left", "semi", "anti", "right",
                                 "full"].index(how))
    bk, bv, pk = _tables(rng)
    want = rs.join(jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk), how=how)
    got = rt.join(from_numpy(bk, device="cpu"), from_numpy(bv, device="cpu"), from_numpy(pk, device="cpu"), how=how)
    assert_outputs_equal(got, want)


@pytest.mark.parametrize("how", ["inner", "full"])
def test_composite_keys_and_validity(how):
    rng = np.random.default_rng(11)
    bk, bv, pk = _tables(rng)
    bk2 = (rng.random(NB) < 0.5).astype(np.int32) - 1
    pk2 = (rng.random(NP) < 0.5).astype(np.int32) - 1
    bval = rng.random(NB) < 0.8
    pval = rng.random(NP) < 0.9
    bv = bv.astype(np.uint32)  # an unsigned value column
    want = rs.join((jnp.asarray(bk), jnp.asarray(bk2)), jnp.asarray(bv),
                   (jnp.asarray(pk), jnp.asarray(pk2)), how=how,
                   build_valid=jnp.asarray(bval), probe_valid=jnp.asarray(pval))
    got = rt.join((from_numpy(bk, device="cpu"), from_numpy(bk2, device="cpu")), from_numpy(bv, device="cpu"),
                  (from_numpy(pk, device="cpu"), from_numpy(pk2, device="cpu")), how=how,
                  build_valid=from_numpy(bval, device="cpu"), probe_valid=from_numpy(pval, device="cpu"))
    assert isinstance(got[0], tuple)
    assert_outputs_equal(got, want)


def test_float_keys_left_join():
    rng = np.random.default_rng(13)
    bk, bv, pk = _tables(rng, np.float32)
    bk[:3] = [np.nan, -0.0, 5.0]
    pk[:4] = [np.nan, 0.0, -0.0, 5.0]
    want = rs.join(jnp.asarray(bk), jnp.asarray(bv.astype(np.float32)),
                   jnp.asarray(pk), how="left",
                   probe_valid=jnp.asarray(pk != 7))
    got = rt.join(from_numpy(bk, device="cpu"), from_numpy(bv.astype(np.float32), device="cpu"),
                  from_numpy(pk, device="cpu"), how="left", probe_valid=from_numpy(pk != 7, device="cpu"))
    assert_outputs_equal(got, want)


@pytest.mark.parametrize("how,capacity", [("inner", None), ("left", 1500)])
def test_join_count_and_expand(how, capacity):
    rng = np.random.default_rng(17)
    bk, bv, pk = _tables(rng)
    want_count = jjoin_count(jnp.asarray(bk), jnp.asarray(pk))
    got_count = rt.join_count(from_numpy(bk, device="cpu"), from_numpy(pk, device="cpu"))
    assert_outputs_equal((got_count,), (want_count,))
    capacity = capacity or int(want_count)  # a truncating one for "left"
    want = jjoin_expand(jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(pk),
                        capacity=capacity, how=how)
    got = rt.join_expand(from_numpy(bk, device="cpu"), from_numpy(bv, device="cpu"), from_numpy(pk, device="cpu"),
                         capacity=capacity, how=how)
    assert_outputs_equal(got, want)


def test_rejects_bad_input():
    k = torch.arange(4, dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError):
        rt.join(k, k, k, how="cross")
    with pytest.raises(ValueError):
        rt.join((k, k), k, (k,))
    with pytest.raises(ValueError):
        rt.join_expand(k, k, k, capacity=4, how="full")


@pytest.mark.parametrize("recipe", ["fk_join", "outer_join_agg"])
def test_flagship_matches_jax(recipe):
    """The slice end to end: the port's recipe makes the inputs on the CPU
    and both packages' pipelines run on them."""
    gen = torch.Generator().manual_seed(7)
    fn, args = tflag.REGISTRY[recipe](4096, 1024, generator=gen, device="cpu")
    jfn, _ = jflag.REGISTRY[recipe](16, 4)
    want = jfn(*[jnp.asarray(to_numpy(a)) for a in args])
    got = fn(*args)
    assert_outputs_equal(got, want)
    if recipe == "fk_join":  # every probe key has its build row
        assert int(got[3]) == 4096


def test_flagship_recipes_follow_the_generator():
    a = tflag.fk_join(64, 16, generator=torch.Generator().manual_seed(3),
                      device="cpu")[1]
    b = tflag.fk_join(64, 16, generator=torch.Generator().manual_seed(3),
                      device="cpu")[1]
    for x, y in zip(a, b):
        assert x.device.type == "cpu" and torch.equal(x.view(torch.int32),
                                                      y.view(torch.int32))
    with pytest.raises(ValueError, match="generator"):
        tflag.fk_join(64, 16, generator=torch.Generator(), device="meta")
