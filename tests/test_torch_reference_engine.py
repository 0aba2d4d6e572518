"""The port's reference engine (SortConfig(engine="reference")) against the
JAX package's, bit for bit.

The engine is the LSD pipeline in plain torch with CUB's tile and spine
layout: ``plan_passes`` plans the passes (the alternative smaller-radix
passes first), ``counting_pass_reference`` gives each row its destination
(the spine base of its digit and tile plus its stable rank in the tile)
and ``apply_permutation`` moves the limbs and payloads. Each piece runs on
the same numpy inputs on both sides. The public sorts through the engine
run at small sizes and with bit ranges that are not aligned to the digit
width; a stable sort has one output, so they are held to the JAX sort on
its default engine, one compile per dtype and bit range where JAX's
reference engine compiles once per radix too.
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu as rs
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.utils.convert import (config_from_jax,
                                                    from_numpy, to_numpy)

# the modules, not the functions the packages' ops/__init__ bind to "sort"
jsort = importlib.import_module("cuda.radixsort_tpu.ops.sort")
tsort = importlib.import_module("cuda.radixsort_tpu_torch.ops.sort")

N = 3000
KEY_DTYPES = [np.uint32, np.int32, np.float32, np.uint64, np.int64,
              np.float64, np.uint8, np.int16, np.float16, ml_dtypes.bfloat16]


def _raw(a):
    a = np.asarray(a)
    return a.view(f"uint{a.dtype.itemsize * 8}")


def _eq(got, want):
    np.testing.assert_array_equal(_raw(to_numpy(got)), _raw(want))


def make_keys(dtype, n=N, seed=0, distinct=None):
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    u = np.dtype(f"uint{dtype.itemsize * 8}")
    bits = rng.integers(0, 2**64, size=n, dtype=np.uint64).astype(u)
    if distinct is not None:
        bits = rng.choice(np.unique(bits)[:distinct], size=n)
    return bits.view(dtype)


def test_plan_passes_matches_jax():
    for radix_bits in range(1, 12):
        for begin in range(0, 40, 3):
            for end in range(begin, 66, 5):
                assert (tsort.plan_passes(begin, end, radix_bits)
                        == jsort.plan_passes(begin, end, radix_bits)), \
                    (begin, end, radix_bits)
    assert tsort.plan_passes(3, 29, 4) == [(3, 3), (6, 3), (9, 4), (13, 4),
                                           (17, 4), (21, 4), (25, 4)]


@pytest.mark.parametrize("tiles,bins,tile", [(1, 16, 64), (5, 256, 128),
                                             (7, 8, 100), (3, 2, 1)])
def test_spine_scan_matches_jax(tiles, bins, tile):
    rng = np.random.default_rng(tiles * bins)
    digits = rng.integers(0, bins, size=(tiles, tile)).astype(np.int32)
    hist = np.stack([np.bincount(d, minlength=bins) for d in digits])
    hist = hist.astype(np.int32)
    want = np.asarray(jsort.spine_scan(jnp.asarray(hist)))
    got = tsort.spine_scan(torch.from_numpy(hist))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bins,tile,skew", [(256, 512, False), (16, 100, True),
                                            (4, 1, False), (2, 64, True)])
def test_counting_pass_matches_jax(bins, tile, skew):
    rng = np.random.default_rng(bins + tile)
    n = tile * 6
    digits = rng.integers(0, bins, size=n).astype(np.int32)
    if skew:
        digits[rng.random(n) < 0.8] = bins - 1
    want = np.asarray(jax.jit(jsort.counting_pass_reference,
                              static_argnums=(1, 2))(jnp.asarray(digits),
                                                     bins, tile))
    got = tsort.counting_pass_reference(torch.from_numpy(digits), bins, tile)
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(got.tolist()) == list(range(n))
    if tile > 1:
        with pytest.raises(ValueError, match="tiles"):
            tsort.counting_pass_reference(torch.from_numpy(digits[:-1]),
                                          bins, tile)


JS = rs.SortConfig()  # JAX's default engine: the public sorts' reference


def _cfgs(radix_bits):
    jcfg = rs.SortConfig(engine="reference", radix_bits=radix_bits,
                         tile_rows=8)
    tcfg = config_from_jax(jcfg).replace(block_threads=32,
                                         items_per_thread=32)
    assert tcfg.engine == "reference" and tcfg.radix_bits == radix_bits
    assert tcfg.tile_elems == jcfg.tile_elems == 1024
    return jcfg, tcfg


# every key dtype, the order alternating (the twiddle's descending form is
# held for every dtype by tests/test_torch_sort.py)
@pytest.mark.parametrize("dtype,descending", [
    (d, i % 2 == 1) for i, d in enumerate(KEY_DTYPES)],
    ids=lambda v: np.dtype(v).name if not isinstance(v, bool) else str(v))
def test_sort_matches_jax_reference(dtype, descending):
    jcfg, tcfg = _cfgs(8)
    keys = make_keys(dtype, seed=3)
    want = rs.sort(jnp.asarray(keys), descending=descending, config=JS)
    _eq(rt.sort(from_numpy(keys, device="cpu"), descending=descending,
                config=tcfg), want)


# bit ranges off the digit boundaries of the radix, one across the limbs
@pytest.mark.parametrize("dtype,begin,end,radix_bits", [
    (np.uint32, 3, 29, 4), (np.float32, 3, 29, 5), (np.uint8, 0, 7, 3),
    (np.float16, 5, 13, 4), (np.int64, 27, 41, 4), (np.uint64, 31, 64, 6)],
    ids=lambda v: np.dtype(v).name if isinstance(v, type) else str(v))
def test_sort_bit_range_matches_jax_reference(dtype, begin, end, radix_bits):
    jcfg, tcfg = _cfgs(radix_bits)
    keys = make_keys(dtype, seed=begin + end)
    want = rs.sort(jnp.asarray(keys), begin_bit=begin, end_bit=end,
                   config=JS)
    _eq(rt.sort(from_numpy(keys, device="cpu"), begin_bit=begin,
                end_bit=end, config=tcfg), want)


@pytest.mark.parametrize("dtype,radix_bits,begin,end", [
    (np.uint32, 8, None, None), (np.uint32, 3, 3, 29),
    (np.int64, 8, None, None), (np.float32, 5, 3, 29)],
    ids=lambda v: np.dtype(v).name if isinstance(v, type) else str(v))
def test_sort_pairs_matches_jax_reference(dtype, radix_bits, begin, end):
    jcfg, tcfg = _cfgs(radix_bits)
    keys = make_keys(dtype, seed=radix_bits, distinct=50)  # ties: stability
    pay = (np.arange(N, dtype=np.int32),
           make_keys(np.float64, seed=7), np.arange(N) % 3 == 0)
    jk, jv = rs.sort_pairs(jnp.asarray(keys),
                           tuple(jnp.asarray(p) for p in pay),
                           begin_bit=begin, end_bit=end, config=JS)
    tk, tv = rt.sort_pairs(from_numpy(keys, device="cpu"),
                           tuple(from_numpy(p, device="cpu") for p in pay),
                           begin_bit=begin, end_bit=end, config=tcfg)
    _eq(tk, jk)
    for g, w in zip(tv, jv):
        _eq(g, w)


@pytest.mark.parametrize("descending", [False, True])
def test_argsort_matches_jax_reference(descending):
    jcfg, tcfg = _cfgs(4)
    keys = make_keys(np.int16, seed=11, distinct=30)
    for begin, end in ((None, None), (2, 11)):
        want = rs.argsort(jnp.asarray(keys), descending=descending,
                          begin_bit=begin, end_bit=end, config=JS)
        got = rt.argsort(from_numpy(keys, device="cpu"),
                         descending=descending, begin_bit=begin,
                         end_bit=end, config=tcfg)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_sort_struct_and_default_tile():
    # the port's default tile (8192 keys) against JAX's (64 rows x 128)
    jcfg = rs.SortConfig(engine="reference")
    tcfg = config_from_jax(jcfg)
    assert tcfg.tile_elems == jcfg.tile_elems
    a = make_keys(np.uint8, seed=1, distinct=5)
    b = make_keys(np.float32, seed=2, distinct=40)
    v = np.arange(N, dtype=np.int32)
    (ja, jb), jv = rs.sort_struct((jnp.asarray(a), jnp.asarray(b)),
                                  jnp.asarray(v), config=JS)
    (ta, tb), tv = rt.sort_struct((from_numpy(a, device="cpu"),
                                   from_numpy(b, device="cpu")),
                                  from_numpy(v, device="cpu"), config=tcfg)
    _eq(ta, ja)
    _eq(tb, jb)
    _eq(tv, jv)


def test_reference_engine_runs_only_where_named():
    assert rt.resolve().engine == "radix"
    assert rt.best_engine() == "radix"
    with pytest.raises(ValueError, match="radix_bits"):
        rt.SortConfig(engine="reference", radix_bits=17)
    with pytest.raises(ValueError, match="radix_bits"):
        rt.SortConfig(engine="radix", radix_bits=3)
    # the reference engine launches no kernel: its passes are plain torch
    keys = torch.randint(0, 2**31, (5000,), dtype=torch.int32)
    calls = []
    sort_limbs = tsort.kpipe.sort_limbs
    try:
        tsort.kpipe.sort_limbs = lambda *a, **k: calls.append(1)
        out = rt.sort(keys, config=rt.SortConfig(engine="reference"))
    finally:
        tsort.kpipe.sort_limbs = sort_limbs
    assert calls == []
    assert torch.equal(out, torch.sort(keys).values)
