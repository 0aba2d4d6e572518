"""The port's CUB-shaped surface against the JAX package's, class by class.

Each case builds the same numpy inputs, calls the same entry point of
``cuda.radixsort_tpu.cub_compat`` (JAX arrays) and of
``cuda.radixsort_tpu_torch.cub_compat`` (CPU tensors, the kernels' plain
versions) and compares the results. Tolerance: sorts, permutations,
integer results and counts bit for bit (a 0-d count by value: JAX under x64
sums an int32 mask to int64, the port keeps int32); a float32 sum or scan
within F32_TOL = 1e-5 of the sum of |x| over its prefix, since the two add
in different orders (the port's scan folds left to right, XLA's cumsum and
sum do not). The rounding error of a sum of n float32 terms of random sign,
in any order, grows like sqrt(n) * eps * sum|x|: 7.6e-6 of sum|x| at the
4096 rows used here, under F32_TOL (the bound tests/test_torch_scan.py
holds the scan kernel to); min, max and the identities of empty segments
are exact.

The last test compares every public name of the five JAX modules this
slice ports with the port's.
"""

import contextlib
import inspect
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu.cub_compat as jcub
import cuda.radixsort_tpu_torch.cub_compat as tcub
from cuda.radixsort_tpu.ops import comparator_sort as jcs
from cuda.radixsort_tpu_torch.ops import comparator_sort as tcs
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

F32_TOL = 1e-5
J = types.SimpleNamespace(cub=jcub, arr=jnp.asarray, maximum=jnp.maximum,
                          minimum=jnp.minimum, less=jcs.less,
                          greater=jcs.greater)
T = types.SimpleNamespace(cub=tcub, arr=lambda x: from_numpy(x, device="cpu"),
                          maximum=torch.maximum, minimum=torch.minimum,
                          less=tcs.less, greater=tcs.greater)


def _np(x):
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, f32_scale=None):
    """Equal trees; 0-d integers by value; float32 within F32_TOL of
    ``f32_scale`` (an array broadcast against the values) when given."""
    if isinstance(want, jcub.DoubleBuffer):
        _same(got.current(), want.current(), f32_scale)
        _same(got.alternate(), want.alternate(), f32_scale)
        return
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k], f32_scale)
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, f32_scale)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.ndim == 0 and w.dtype.kind in "iu":
        assert int(g) == int(w)
        return
    assert g.dtype == w.dtype, (g.dtype, w.dtype)
    if f32_scale is not None and w.dtype.kind == "f":
        bound = np.broadcast_to(F32_TOL * np.asarray(f32_scale, np.float64),
                                w.shape)
        fin = np.isfinite(w)  # identities of empty segments: exact
        np.testing.assert_array_equal(g[~fin], w[~fin])
        np.testing.assert_array_less(
            np.abs(g[fin].astype(np.float64) - w[fin]), bound[fin] + 1e-30)
    else:
        np.testing.assert_array_equal(g, w)


def both(fn, f32_scale=None):
    """Run fn(package) for both packages and compare."""
    got = fn(T)
    _same(got, fn(J), f32_scale)
    return got


def _u32(rng, n, hi=2**32):
    return rng.integers(0, hi, size=n, dtype=np.uint64).astype(np.uint32)


SIZES = [1, 2, 3, 1000]


# ---------------------------------------------------------------------------
# DeviceRadixSort and DoubleBuffer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", [(0, None), (4, 20)], ids=["full", "4-20"])
def test_radix_sort(n, bits):
    rng = np.random.default_rng(n)
    k = _u32(rng, n)
    v = np.arange(n, dtype=np.int32)
    b, e = bits
    for name in ("SortKeys", "SortKeysDescending"):
        both(lambda p: getattr(p.cub.DeviceRadixSort, name)(
            p.arr(k), n, begin_bit=b, end_bit=e))
    for name in ("SortPairs", "SortPairsDescending"):
        both(lambda p: getattr(p.cub.DeviceRadixSort, name)(
            p.arr(k), p.arr(v), n, begin_bit=b, end_bit=e))


@pytest.mark.parametrize("dtype", [np.float32, np.int64, np.uint16])
def test_radix_sort_dtypes(dtype):
    rng = np.random.default_rng(1)
    k = rng.integers(0, 1000, 999).astype(dtype)
    v = rng.standard_normal(999).astype(np.float32)
    both(lambda p: p.cub.DeviceRadixSort.SortPairsDescending(p.arr(k),
                                                             p.arr(v)))


def test_radix_sort_decomposer():
    rng = np.random.default_rng(2)
    n = 777
    hi = rng.integers(0, 4, n).astype(np.int32)
    lo = rng.standard_normal(n).astype(np.float32)
    v = np.arange(n, dtype=np.int32)
    dec = lambda kv: (kv[0], kv[1])  # noqa: E731
    both(lambda p: p.cub.DeviceRadixSort.SortKeys(
        (p.arr(hi), p.arr(lo)), decomposer=dec))
    both(lambda p: p.cub.DeviceRadixSort.SortPairsDescending(
        (p.arr(hi), p.arr(lo)), p.arr(v), decomposer=dec))
    with pytest.raises(ValueError, match="full-width"):
        T.cub.DeviceRadixSort.SortKeys((T.arr(hi), T.arr(lo)), begin_bit=4,
                                       decomposer=dec)


@pytest.mark.parametrize("pairs", [False, True], ids=["keys", "pairs"])
def test_double_buffer(pairs):
    rng = np.random.default_rng(3)
    k = _u32(rng, 1000)
    v = rng.standard_normal(1000).astype(np.float32)

    def run(p):
        kb = p.cub.DoubleBuffer(p.arr(k))
        if not pairs:
            out = p.cub.DeviceRadixSort.SortKeys(kb)
            assert out is kb and kb.selector == 0
            return kb
        vb = p.cub.DoubleBuffer(p.arr(v))
        ok, ov = p.cub.DeviceRadixSort.SortPairs(kb, vb)
        assert ok is kb and ov is vb
        return kb, vb

    got = both(run)
    kb = got[0] if pairs else got
    np.testing.assert_array_equal(_np(kb.current()), np.sort(k))
    np.testing.assert_array_equal(_np(kb.alternate()), k)


# ---------------------------------------------------------------------------
# segmented sorts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ends", [False, True], ids=["begins", "begin_end"])
@pytest.mark.parametrize("cls", ["DeviceSegmentedRadixSort",
                                 "DeviceSegmentedSort"])
def test_segmented_sort(ends, cls):
    rng = np.random.default_rng(4)
    n, ns = 3000, 7
    k = _u32(rng, n, 100)
    v = np.arange(n, dtype=np.int32)
    offs = np.sort(rng.integers(0, n, ns - 1)).astype(np.int32)
    offs = np.concatenate([[0], offs, [n]]).astype(np.int32)
    names = (("SortKeys", "SortKeysDescending", "SortPairs",
              "SortPairsDescending") if cls == "DeviceSegmentedRadixSort"
             else ("StableSortKeys", "StableSortPairsDescending",
                   "SortPairs", "StableSortKeysDescending"))
    for name in names:
        def run(p):
            c = getattr(p.cub, cls)
            b = p.arr(offs[:-1] if ends else offs)
            e = p.arr(offs[1:]) if ends else None
            args = (p.arr(k), p.arr(v)) if "Pairs" in name else (p.arr(k),)
            return getattr(c, name)(*args, n, ns, b, e)

        both(run)


# ---------------------------------------------------------------------------
# select, partition, run-length encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_select(n):
    rng = np.random.default_rng(n + 5)
    x = rng.integers(0, 6, n).astype(np.int32)
    x.sort()
    v = rng.standard_normal(n).astype(np.float32)
    flags = rng.random(n) < 0.4
    both(lambda p: p.cub.DeviceSelect.Flagged(p.arr(x), p.arr(flags), n))
    both(lambda p: p.cub.DeviceSelect.If(p.arr(x), lambda a: a % 3 == 1, n))
    both(lambda p: p.cub.DeviceSelect.FlaggedIf(p.arr(x), p.arr(flags),
                                                lambda f: ~f, n))
    both(lambda p: p.cub.DeviceSelect.Unique(p.arr(x), n))
    both(lambda p: p.cub.DeviceSelect.UniqueByKey(p.arr(x), p.arr(v), n))
    both(lambda p: p.cub.DevicePartition.Flagged(p.arr(x), p.arr(flags)))
    both(lambda p: p.cub.DevicePartition.If(p.arr(x), lambda a: a > 2))
    both(lambda p: p.cub.DeviceRunLengthEncode.Encode(p.arr(x), n))
    both(lambda p: p.cub.DeviceRunLengthEncode.NonTrivialRuns(p.arr(x), n))


@pytest.mark.parametrize("n", SIZES)
def test_three_way_partition(n):
    rng = np.random.default_rng(n + 6)
    x = _u32(rng, n, 30).astype(np.int32)
    cols = {"k": x, "w": rng.standard_normal(n).astype(np.float32)}
    for fn in (lambda p: p.cub.DevicePartition.ThreeWay(
                   p.arr(x), lambda a: a % 3 == 0, lambda a: a < 10, n),
               lambda p: p.cub.DevicePartition.ThreeWay(
                   {c: p.arr(a) for c, a in cols.items()},
                   lambda d: d["w"] > 0.5, lambda d: d["k"] % 2 == 0)):
        got, want = fn(T), fn(J)
        _same(got[:3], want[:3])
        # the two counts: int32 in the port, int64 in JAX under x64
        assert _np(got[3]).dtype == np.int32
        np.testing.assert_array_equal(_np(got[3]), _np(want[3]))


# ---------------------------------------------------------------------------
# histograms, merges
# ---------------------------------------------------------------------------


def test_histograms():
    rng = np.random.default_rng(7)
    s = (rng.standard_normal(4000) * 3).astype(np.float32)
    levels = np.array([-4, -1, 0, 0.5, 2, 6], np.float32)
    both(lambda p: p.cub.DeviceHistogram.HistogramEven(p.arr(s), 11, -5.0,
                                                       5.0, 4000))
    both(lambda p: p.cub.DeviceHistogram.HistogramRange(p.arr(s), 6,
                                                        p.arr(levels)))
    px = rng.integers(0, 256, (1000, 4)).astype(np.int32)
    both(lambda p: p.cub.DeviceHistogram.MultiHistogramEven(
        p.arr(px), [257, 17, 9, 5], 0, 256, 1000, num_active_channels=3))
    both(lambda p: p.cub.DeviceHistogram.MultiHistogramEven(
        p.arr(px.reshape(-1)), 33, [0, 0, 0, 0], [256, 128, 256, 64],
        num_channels=4))
    lv = np.array([0, 10, 100, 200, 256], np.int32)
    both(lambda p: p.cub.DeviceHistogram.MultiHistogramRange(
        p.arr(px), [5, 5], [p.arr(lv), p.arr(lv)], num_active_channels=2))
    with pytest.raises(ValueError, match="num_channels"):
        T.cub.DeviceHistogram.MultiHistogramEven(T.arr(px.reshape(-1)), 5,
                                                 0, 256)


@pytest.mark.parametrize("desc", [False, True])
def test_merge(desc):
    rng = np.random.default_rng(8)
    a, b = np.sort(_u32(rng, 1500, 300)), np.sort(_u32(rng, 900, 300))
    if desc:
        a, b = a[::-1].copy(), b[::-1].copy()
    va = np.arange(1500, dtype=np.int32)
    vb = -np.arange(900, dtype=np.int32)
    both(lambda p: p.cub.DeviceMerge.MergeKeys(p.arr(a), p.arr(b), 1500, 900,
                                               descending=desc))
    both(lambda p: p.cub.DeviceMerge.MergePairs(
        p.arr(a), p.arr(va), p.arr(b), p.arr(vb), descending=desc))


# ---------------------------------------------------------------------------
# scans and reductions
# ---------------------------------------------------------------------------


def _values(dtype, rng, n):
    if dtype == np.float32:
        return (rng.standard_normal(n) * 100).astype(np.float32)
    if dtype == np.uint32:
        return _u32(rng, n)
    return rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(dtype)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32, np.int64])
def test_scans(n, dtype):
    rng = np.random.default_rng([n, np.dtype(dtype).num])
    x = _values(dtype, rng, n)
    prefix = np.cumsum(np.abs(x.astype(np.float64)))
    both(lambda p: p.cub.DeviceScan.InclusiveSum(p.arr(x), n), prefix)
    both(lambda p: p.cub.DeviceScan.ExclusiveSum(p.arr(x), n), prefix)
    if dtype == np.uint32:  # the user's ops: CPU torch has no uint32 max
        return
    both(lambda p: p.cub.DeviceScan.ExclusiveScan(p.arr(x), p.maximum, 5, n))
    both(lambda p: p.cub.DeviceScan.InclusiveScan(p.arr(x), p.minimum))
    both(lambda p: p.cub.DeviceScan.InclusiveScanInit(p.arr(x), p.maximum,
                                                      -7))


@pytest.mark.parametrize("n", SIZES)
def test_scans_by_key(n):
    rng = np.random.default_rng(n + 9)
    k = np.sort(rng.integers(0, max(1, n // 10), n)).astype(np.int32)
    v = rng.integers(-1000, 1000, n).astype(np.int32)
    both(lambda p: p.cub.DeviceScan.InclusiveSumByKey(p.arr(k), p.arr(v), n))
    both(lambda p: p.cub.DeviceScan.ExclusiveSumByKey(p.arr(k), p.arr(v), n))
    for op in ("min", "max", "prod"):
        both(lambda p: p.cub.DeviceScan.InclusiveScanByKey(p.arr(k),
                                                           p.arr(v), op))
    both(lambda p: p.cub.DeviceScan.ExclusiveScanByKey(
        p.arr(k), p.arr(v), "max", 3))
    both(lambda p: p.cub.DeviceScan.ExclusiveScanByKey(
        p.arr(k), p.arr(v), p.maximum, 3, identity=-2**31))
    both(lambda p: p.cub.DeviceScan.InclusiveSumByKey(
        p.arr(k), p.arr(v), equality_op=lambda a, b: (a // 3) == (b // 3)))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
def test_reduce(n, dtype):
    rng = np.random.default_rng([n, np.dtype(dtype).num, 1])
    x = _values(dtype, rng, n)
    x[rng.integers(0, n, 3)] = x[0]  # repeated extremes: first one wins
    total = np.abs(x.astype(np.float64)).sum()
    both(lambda p: p.cub.DeviceReduce.Sum(p.arr(x), n), total)
    for name in ("Min", "Max", "ArgMin", "ArgMax"):
        both(lambda p: getattr(p.cub.DeviceReduce, name)(p.arr(x), n))
    if dtype != np.uint32:  # the user's ops: CPU torch has no uint32 max
        both(lambda p: p.cub.DeviceReduce.Reduce(p.arr(x), p.maximum, x[0]))
        both(lambda p: p.cub.DeviceReduce.Reduce(
            p.arr(x), lambda a, b: a + b, 0), total)
        both(lambda p: p.cub.DeviceReduce.TransformReduce(
            p.arr(x), p.minimum, lambda a: a * 3, x[0]))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", [None, "max", "prod", "fn"])
def test_reduce_by_key(n, op):
    rng = np.random.default_rng(n + 10)
    k = np.sort(_u32(rng, n, max(2, n // 8)))
    v = rng.integers(-5, 5, n).astype(np.int32)
    both(lambda p: p.cub.DeviceReduce.ReduceByKey(
        p.arr(k), p.arr(v), p.minimum if op == "fn" else op, n))


@pytest.mark.parametrize("case", ["contiguous", "gaps_and_empty"])
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
def test_segmented_reduce(case, dtype):
    rng = np.random.default_rng(11)
    n = 2000
    x = _values(dtype, rng, n)
    if case == "contiguous":
        b = np.concatenate([[0], np.sort(rng.integers(0, n, 15)),
                            [n]]).astype(np.int32)
        e = None
    else:
        b = np.array([5, 100, 100, 700, 1500, 1999], np.int32)
        e = np.array([50, 100, 600, 650, 2000, 2000], np.int32)
    scale = np.full(len(b) - 1, np.abs(x.astype(np.float64)).sum())
    for name in ("Sum", "Min", "Max"):
        both(lambda p: getattr(p.cub.DeviceSegmentedReduce, name)(
            p.arr(x), None, p.arr(b), None if e is None else p.arr(e)),
             scale)


# ---------------------------------------------------------------------------
# adjacent difference, top-k, transform, merge sort, copies, for
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_adjacent_difference(n):
    rng = np.random.default_rng(n + 12)
    for x in (_u32(rng, n), _values(np.int32, rng, n)):
        for name in ("SubtractLeftCopy", "SubtractRightCopy", "SubtractLeft",
                     "SubtractRight"):
            both(lambda p: getattr(p.cub.DeviceAdjacentDifference, name)(
                p.arr(x), n))
    f = _values(np.float32, rng, n)
    both(lambda p: p.cub.DeviceAdjacentDifference.SubtractLeftCopy(
        p.arr(f), difference_op=lambda a, b: a * 2 - b))


@pytest.mark.parametrize("n, k", [(1, 1), (3, 2), (1000, 10), (4096, 1024)])
def test_top_k(n, k):
    rng = np.random.default_rng(n + 13)
    x = _u32(rng, n, 500)  # threshold ties: the smallest rows win
    v = np.arange(n, dtype=np.int32)
    for name in ("MaxKeys", "MinKeys"):
        both(lambda p: getattr(p.cub.DeviceTopK, name)(p.arr(x), k, n))
    for name in ("MaxPairs", "MinPairs"):
        both(lambda p: getattr(p.cub.DeviceTopK, name)(p.arr(x), p.arr(v),
                                                       k, n))


def test_transform():
    rng = np.random.default_rng(14)
    a, b = _values(np.int32, rng, 500), _values(np.int32, rng, 500)
    both(lambda p: p.cub.DeviceTransform.Transform((p.arr(a), p.arr(b)),
                                                   lambda x, y: x ^ y, 500))
    both(lambda p: p.cub.DeviceTransform.Transform(p.arr(a),
                                                   lambda x: x // 3))


def _by_score(a, b):  # score descending, then id ascending
    return (a["score"] > b["score"]) | ((a["score"] == b["score"])
                                        & (a["id"] < b["id"]))


@pytest.mark.parametrize("n", SIZES)
def test_merge_sort(n):
    rng = np.random.default_rng(n + 15)
    k = _u32(rng, n, 50)
    v = np.arange(n, dtype=np.int32)
    rec = {"score": rng.integers(0, 4, n).astype(np.float32),
           "id": rng.integers(0, 3, n).astype(np.int32)}
    ms = "DeviceMergeSort"
    for name in ("SortKeys", "StableSortKeys", "SortKeysCopy",
                 "StableSortKeysCopy"):
        both(lambda p: getattr(getattr(p.cub, ms), name)(p.arr(k), n))
        both(lambda p: getattr(getattr(p.cub, ms), name)(
            p.arr(k), n, p.greater))
        both(lambda p: getattr(getattr(p.cub, ms), name)(
            p.arr(k.astype(np.int32)), n, lambda a, b: (a % 7) < (b % 7)))
    for name in ("SortPairs", "StableSortPairs"):
        both(lambda p: getattr(getattr(p.cub, ms), name)(
            p.arr(k), p.arr(v), n, p.greater))
        both(lambda p: getattr(getattr(p.cub, ms), name)(
            {c: p.arr(a) for c, a in rec.items()}, p.arr(v), n, _by_score))


def test_batched_copy():
    rng = np.random.default_rng(16)
    src = _u32(rng, 100)
    dst = np.zeros(120, np.uint32)
    so, do, sz = [0, 10, 50, 90], [100, 0, 30, 5], [10, 0, 40, 10]
    for cls in ("DeviceCopy", "DeviceMemcpy"):
        both(lambda p: getattr(p.cub, cls).Batched(p.arr(src), p.arr(dst),
                                                   so, do, sz, 4))
        both(lambda p: getattr(p.cub, cls).Batched(p.arr(src), p.arr(dst),
                                                   [], [], []))
    with pytest.raises(ValueError, match="num_buffers"):
        T.cub.DeviceCopy.Batched(T.arr(src), T.arr(dst), so, do, sz, 3)


def test_device_for():
    rng = np.random.default_rng(17)
    x = _values(np.int32, rng, 300)
    got = T.cub.DeviceFor.Bulk(10, lambda i: i * i, device="cpu")
    _same(got, J.cub.DeviceFor.Bulk(10, lambda i: i * i))
    for name in ("ForEach", "ForEachCopy"):
        both(lambda p: getattr(p.cub.DeviceFor, name)(p.arr(x),
                                                      lambda a: a * 2 + 1))
    for name in ("ForEachN", "ForEachCopyN"):
        both(lambda p: getattr(p.cub.DeviceFor, name)(p.arr(x), 7,
                                                      lambda a: -a))
    got = T.cub.DeviceFor.ForEachInExtents((3, 4), lambda i, j: i * 10 + j,
                                           device="cpu")
    _same(got, J.cub.DeviceFor.ForEachInExtents((3, 4),
                                                lambda i, j: i * 10 + j))


# ---------------------------------------------------------------------------
# edges: empty inputs, num_items, streams
# ---------------------------------------------------------------------------


def test_empty_inputs():
    """n = 0 through the port (the CUB result: empty outputs, zero counts)."""
    e = T.arr(np.zeros(0, np.uint32))
    c = T.cub
    assert c.DeviceRadixSort.SortKeys(e, 0).shape == (0,)
    k, v = c.DeviceRadixSort.SortPairs(e, e, 0)
    assert k.shape == v.shape == (0,)
    out, n = c.DeviceSelect.If(e, lambda a: a == a)
    assert out.shape == (0,) and int(n) == 0
    assert c.DeviceScan.InclusiveSum(e).shape == (0,)
    assert c.DeviceScan.ExclusiveScan(e, torch.maximum, 3).shape == (0,)
    uk, agg, runs = c.DeviceReduce.ReduceByKey(e, e)
    assert uk.shape == agg.shape == (0,) and int(runs) == 0
    assert c.DevicePartition.ThreeWay(e, lambda a: a == a,
                                      lambda a: a == a)[0].shape == (0,)
    assert c.DeviceAdjacentDifference.SubtractLeftCopy(e).shape == (0,)


def _num_items_calls(x, n):
    c = T.cub
    return [
        lambda: c.DeviceRadixSort.SortKeys(x, n),
        lambda: c.DeviceRadixSort.SortKeysDescending(x, n),
        lambda: c.DeviceRadixSort.SortPairs(x, x, n),
        lambda: c.DeviceRadixSort.SortPairsDescending(x, x, n),
        lambda: c.DeviceSegmentedRadixSort.SortKeys(x, n, 1, T.arr(
            np.array([0, 8], np.int32))),
        lambda: c.DeviceSegmentedRadixSort.SortPairs(x, x, n, 1, T.arr(
            np.array([0, 8], np.int32))),
        lambda: c.DeviceSegmentedRadixSort.SortKeysDescending(
            x, n, 1, T.arr(np.array([0], np.int32)),
            T.arr(np.array([8], np.int32))),
        lambda: c.DeviceSegmentedRadixSort.SortPairsDescending(
            x, x, n, 1, T.arr(np.array([0, 8], np.int32))),
        lambda: c.DeviceSegmentedSort.SortPairs(x, x, n, 1, T.arr(
            np.array([0, 8], np.int32))),
        lambda: c.DeviceSelect.Flagged(x, x == x, n),
        lambda: c.DeviceSelect.If(x, lambda a: a == a, n),
        lambda: c.DeviceSelect.FlaggedIf(x, x, lambda f: f == f, n),
        lambda: c.DeviceSelect.Unique(x, n),
        lambda: c.DeviceSelect.UniqueByKey(x, x, n),
        lambda: c.DevicePartition.Flagged(x, x == x, n),
        lambda: c.DevicePartition.If(x, lambda a: a == a, n),
        lambda: c.DevicePartition.ThreeWay(x, lambda a: a == a,
                                           lambda a: a == a, n),
        lambda: c.DeviceRunLengthEncode.Encode(x, n),
        lambda: c.DeviceRunLengthEncode.NonTrivialRuns(x, n),
        lambda: c.DeviceHistogram.HistogramEven(x, 5, 0, 10, n),
        lambda: c.DeviceHistogram.HistogramRange(x, 2, x[:2], n),
        lambda: c.DeviceHistogram.MultiHistogramEven(x.reshape(8, 1), 5, 0,
                                                     10, n),
        lambda: c.DeviceHistogram.MultiHistogramRange(x.reshape(8, 1), 2,
                                                      [x[:2]], n),
        lambda: c.DeviceMerge.MergeKeys(x, x, n, 8),
        lambda: c.DeviceMerge.MergePairs(x, x, x, x, 8, n),
        lambda: c.DeviceScan.ExclusiveSum(x, n),
        lambda: c.DeviceScan.InclusiveSum(x, n),
        lambda: c.DeviceScan.ExclusiveScan(x, torch.maximum, 0, n),
        lambda: c.DeviceScan.InclusiveScan(x, torch.maximum, n),
        lambda: c.DeviceScan.InclusiveScanInit(x, torch.maximum, 0, n),
        lambda: c.DeviceScan.InclusiveSumByKey(x, x, n),
        lambda: c.DeviceScan.ExclusiveSumByKey(x, x, n),
        lambda: c.DeviceScan.InclusiveScanByKey(x, x, "max", n),
        lambda: c.DeviceScan.ExclusiveScanByKey(x, x, "max", 0, n),
        lambda: c.DeviceReduce.Sum(x, n),
        lambda: c.DeviceReduce.Min(x, n),
        lambda: c.DeviceReduce.Max(x, n),
        lambda: c.DeviceReduce.ArgMin(x, n),
        lambda: c.DeviceReduce.ArgMax(x, n),
        lambda: c.DeviceReduce.Reduce(x, torch.maximum, 0, n),
        lambda: c.DeviceReduce.TransformReduce(x, torch.maximum,
                                               lambda a: a, 0, n),
        lambda: c.DeviceReduce.ReduceByKey(x, x, None, n),
        lambda: c.DeviceAdjacentDifference.SubtractLeftCopy(x, n),
        lambda: c.DeviceAdjacentDifference.SubtractRightCopy(x, n),
        lambda: c.DeviceTopK.MaxKeys(x, 2, n),
        lambda: c.DeviceTopK.MinKeys(x, 2, n),
        lambda: c.DeviceTopK.MaxPairs(x, x, 2, n),
        lambda: c.DeviceTopK.MinPairs(x, x, 2, n),
        lambda: c.DeviceTransform.Transform(x, lambda a: a, n),
        lambda: c.DeviceMergeSort.SortKeys(x, n),
        lambda: c.DeviceMergeSort.StableSortKeys(x, n),
        lambda: c.DeviceMergeSort.SortPairs(x, x, n),
        lambda: c.DeviceMergeSort.StableSortPairs(x, x, n),
        lambda: c.DeviceFor.ForEach(x, lambda a: a, n),
    ]


@pytest.mark.parametrize("i", range(len(_num_items_calls(None, 0))))
def test_num_items_mismatch_raises(i):
    x = T.arr(np.arange(8, dtype=np.int32))
    with pytest.raises(ValueError, match="num_items"):
        _num_items_calls(x, 9)[i]()
    _num_items_calls(x, 8)[i]()  # the right count runs


def test_stream_argument_selects_the_stream(monkeypatch):
    # None and 0 run on the current stream
    assert isinstance(tcub._on_stream(None), contextlib.nullcontext)
    assert isinstance(tcub._on_stream(0), contextlib.nullcontext)
    seen = []

    @contextlib.contextmanager
    def fake(stream):
        seen.append(stream)
        yield

    monkeypatch.setattr(tcub, "_on_stream", fake)
    x = T.arr(np.arange(8, dtype=np.int32))
    tcub.DeviceRadixSort.SortKeys(x, 8, 0, None, "s1")
    tcub.DeviceScan.InclusiveSum(x, stream="s2")
    tcub.DeviceSegmentedReduce.Sum(x, 1, T.arr(np.array([0, 8])), None, "s3")
    tcub.DeviceFor.Bulk(3, lambda i: i, "s4", device="cpu")
    assert seen == ["s1", "s2", "s3", "s4"]


# ---------------------------------------------------------------------------
# public names of every JAX module this slice ports
# ---------------------------------------------------------------------------

# names of the JAX modules the port leaves out, each with its reason
NOT_PORTED = {}
_MODULES = ["cub_compat", "thrust_compat", "ops.comparator_sort",
            "ops.external", "utils.native"]


def _public(mod) -> dict:
    return {name: obj for name, obj in vars(mod).items()
            if not name.startswith("_") and not inspect.ismodule(obj)
            and name not in ("annotations", "Any", "Callable")}


@pytest.mark.parametrize("name", _MODULES)
def test_public_names_match_the_jax_module(name):
    import importlib

    jmod = importlib.import_module(f"cuda.radixsort_tpu.{name}")
    tmod = importlib.import_module(f"cuda.radixsort_tpu_torch.{name}")
    theirs, mine = _public(jmod), _public(tmod)
    missing = sorted(set(theirs) - set(mine) - set(NOT_PORTED))
    assert not missing, f"{name}: not in the port: {missing}"
    for attr, obj in theirs.items():
        if inspect.isclass(obj) and attr in mine:
            gone = sorted(a for a in vars(obj) if not a.startswith("_")
                          and not hasattr(mine[attr], a))
            assert not gone, f"{name}.{attr}: not in the port: {gone}"
