"""The port's sort_large (ops/sort.py) against the JAX package, bit for bit.

sort_large is a keys-only sort of 32-bit keys in two phases: one stable
partition by the top msd_bits bits (the histogram and stage kernels; their
plain versions here), then the buckets sorted in batches. Its result must
be JAX's ``sort`` of the same keys on its default CPU engine. Phase B and
the capacity rounding are also held to JAX's own ``_hybrid_bucket_sort``
and ``_round_cap_fine`` on the same inputs. JAX's ``sort_large`` itself
partitions only in Pallas interpret mode on the CPU (about 15 s a call):
its one case is in tests/test_torch_sort_pallas.py, beside the other
interpret-mode case.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu as rs
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.kernels import histogram, stage
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

# the modules, not the functions the packages' ops/__init__ bind to "sort"
jsort = importlib.import_module("cuda.radixsort_tpu.ops.sort")
tsort = importlib.import_module("cuda.radixsort_tpu_torch.ops.sort")
DTYPES = (np.uint32, np.int32, np.float32)


def _raw(a):
    return np.asarray(a).view(np.uint32)


def make_keys(case: str, n: int, dtype, seed: int) -> np.ndarray:
    """u32 bit patterns of one of the key cases, viewed as dtype."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    if case == "one-bucket":  # every key under one top byte
        bits = (bits & np.uint32(0x00FFFFFF)) | np.uint32(0x5A000000)
    elif case == "equal":
        bits[:] = np.uint32(0x89ABCDEF)
    elif case == "max-keys":  # 0xFFFFFFFF keys, which look like the fills
        bits[rng.random(n) < 0.1] = np.uint32(0xFFFFFFFF)
    return bits.view(dtype)


@functools.cache
def jax_sorted(case: str, n: int, dtype_name: str, descending: bool):
    keys = make_keys(case, n, np.dtype(dtype_name), seed=n)
    return keys, _raw(rs.sort(jnp.asarray(keys), descending=descending))


def _check(case, n, dtype, descending, msd_bits):
    keys, want = jax_sorted(case, n, np.dtype(dtype).name, descending)
    got = rt.sort_large(from_numpy(keys, device="cpu"),
                        descending=descending, msd_bits=msd_bits)
    assert got.dtype == from_numpy(keys, device="cpu").dtype
    np.testing.assert_array_equal(_raw(to_numpy(got)), want)


@pytest.mark.parametrize("msd_bits", [2, 4, 8])
@pytest.mark.parametrize("n", [4096, 5000])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_sort_large_matches_jax_sort(dtype, descending, n, msd_bits):
    _check("random", n, dtype, descending, msd_bits)


@pytest.mark.parametrize("msd_bits", [2, 4, 8])
@pytest.mark.parametrize("case", ["one-bucket", "equal", "max-keys"])
def test_sort_large_skewed_keys(case, msd_bits):
    for dtype, descending in ((np.uint32, False), (np.float32, True)):
        _check(case, 5000, dtype, descending, msd_bits)


@pytest.mark.parametrize("msd_bits", [1, 3, 5])
def test_sort_large_unaligned_msd_bits(msd_bits):
    # widths other than 2, 4 and 8 partition through the masked-limb route
    _check("random", 5000, np.int32, False, msd_bits)


def test_phase_a_is_one_histogram_and_one_stage():
    keys = from_numpy(make_keys("random", 5000, np.uint32, 1), device="cpu")
    for msd_bits, width in ((2, 2), (4, 4), (8, 8)):
        calls = {"hist": 0, "stage": 0}
        hist_plain = histogram.limb_histograms
        stage_fn = stage.partition_stage

        def hist_spy(*a, **k):
            calls["hist"] += 1
            return hist_plain(*a, **k)

        def stage_spy(*a, **k):
            calls["stage"] += 1
            assert k["width"] == width
            return stage_fn(*a, **k)

        try:
            histogram.limb_histograms = hist_spy
            stage.partition_stage = stage_spy
            pb, bounds = tsort._hybrid_partition(
                keys, descending=False, msd_bits=msd_bits,
                config=rt.resolve())
        finally:
            histogram.limb_histograms = hist_plain
            stage.partition_stage = stage_fn
        assert calls == {"hist": 1, "stage": 1}
        top = (to_numpy(pb) >> np.uint32(32 - msd_bits)).astype(np.int64)
        assert np.all(np.diff(top) >= 0)
        want = np.concatenate([[0], np.cumsum(np.bincount(
            top, minlength=1 << msd_bits))])
        np.testing.assert_array_equal(to_numpy(bounds), want)


def test_delegates_to_sort():
    rng = np.random.default_rng(4)
    # fewer than 2^22 keys with no msd_bits, and keys that are not 32 bits
    for keys in (rng.integers(0, 2**32, size=3000, dtype=np.uint64)
                 .astype(np.uint32),
                 rng.integers(0, 2**63, size=3000, dtype=np.uint64),
                 rng.standard_normal(3000),
                 rng.integers(0, 2**16, size=3000).astype(np.uint16)):
        calls = []
        sort_fn = tsort.sort

        def sort_spy(*a, **k):
            calls.append(1)
            return sort_fn(*a, **k)

        try:
            tsort.sort = sort_spy
            got = tsort.sort_large(from_numpy(keys, device="cpu"),
                                   descending=True, msd_bits=None
                                   if keys.dtype == np.uint32 else 4)
        finally:
            tsort.sort = sort_fn
        assert calls == [1]
        want = np.asarray(rs.sort(jnp.asarray(keys), descending=True))
        np.testing.assert_array_equal(to_numpy(got).view(np.uint8),
                                      want.view(np.uint8))
    with pytest.raises(ValueError, match="msd_bits"):
        rt.sort_large(torch.zeros(8, dtype=torch.int32), msd_bits=17)


@pytest.mark.parametrize("group", [1, 2, 8])
@pytest.mark.parametrize("msd_bits", [3, 4])
def test_bucket_sort_matches_jax(msd_bits, group):
    # JAX's own partition output shape: the partitioned bits padded with
    # 0xFFFFFFFF to whole tiles, the last bucket holding the pads
    rng = np.random.default_rng(msd_bits * 10 + group)
    n, npad = 3000, 4096
    bits = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    bits = np.concatenate([bits, np.full(npad - n, 0xFFFFFFFF, np.uint32)])
    top = (bits >> np.uint32(32 - msd_bits)).astype(np.int64)
    pb = bits[np.argsort(top, kind="stable")]
    bounds = np.concatenate([[0], np.cumsum(np.bincount(
        top, minlength=1 << msd_bits))]).astype(np.int32)
    cap = jsort._round_cap_fine(int(np.diff(bounds).max()))
    want = np.asarray(jsort._hybrid_bucket_sort(
        jnp.asarray(pb), jnp.asarray(bounds), cap=cap, group=group))
    got = tsort._hybrid_bucket_sort(from_numpy(pb, device="cpu"),
                                    torch.from_numpy(bounds), cap=cap,
                                    group=group)
    np.testing.assert_array_equal(to_numpy(got), want)


def test_round_cap_fine_matches_jax():
    caps = list(range(0, 70000, 37)) + [2**k + d for k in range(8, 31)
                                        for d in (-1, 0, 1)]
    assert [tsort._round_cap_fine(c) for c in caps] == \
        [jsort._round_cap_fine(c) for c in caps]
