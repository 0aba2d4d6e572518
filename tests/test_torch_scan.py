"""The port's segmented scans vs the JAX package.

The scan kernel's plain version is held against the JAX Pallas kernel in
interpret mode; the scan ops (exclusive, init, callable ops, scan_by_key)
against the JAX package's default CPU engine. Tolerance: integer results
and min/max bit for bit; a float32 sum within 1e-5 of the running sum of
|x| over its segment, since the two associate the additions differently.
The CUDA kernel itself is held against the same plain version on the card
by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cuda.radixsort_tpu.kernels.scan import segmented_scan_pallas
from cuda.radixsort_tpu.ops import scan as jscan
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.kernels import scan as kscan
from cuda.radixsort_tpu_torch.ops import scan as tscan
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

N = 5003  # one ragged JAX tile of 8192 rows; two port tiles of 4096
F32_TOL = 1e-5


def _values(dtype, rng, n=N, nan=False):
    if dtype == np.float32:
        v = rng.standard_normal(n).astype(np.float32) * 100
        if nan:
            v[rng.choice(n, 5, replace=False)] = np.nan
        return v
    if dtype == np.uint32:
        return rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    return rng.integers(-2**31, 2**31, size=n, dtype=np.int64).astype(np.int32)


def _segment_abs_sum(v, flags):
    """Running sum of |x| within each segment, in float64."""
    out = np.empty(len(v))
    acc = 0.0
    for i, (x, f) in enumerate(zip(np.abs(v.astype(np.float64)), flags)):
        acc = x if (f or i == 0) else acc + x
        out[i] = acc
    return out


def assert_scan_equal(got, want, values, flags, op):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    if got.dtype == np.float32 and op == "sum":
        bound = F32_TOL * _segment_abs_sum(values, flags)
        np.testing.assert_array_less(np.abs(got.astype(np.float64) - want),
                                     bound + 1e-30)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32],
                         ids=["int32", "uint32", "float32"])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_plain_matches_pallas_interpret(op, dtype):
    rng = np.random.default_rng([len(op), np.dtype(dtype).num])
    v = _values(dtype, rng, nan=(op != "sum"))
    flags = rng.random(N) < 0.02
    flags[4096] = True  # a head exactly at the port's tile boundary
    want = segmented_scan_pallas(jnp.asarray(v), jnp.asarray(flags), op,
                                 interpret=True)
    got = kscan.segmented_scan_plain(from_numpy(v, device="cpu"), from_numpy(flags, device="cpu"), op)
    assert_scan_equal(to_numpy(got), want, v, flags, op)


@pytest.mark.parametrize("case", ["one_segment", "every_row", "uint8_flags"])
def test_plain_edge_cases(case):
    rng = np.random.default_rng(5)
    v = _values(np.int32, rng)
    flags = {"one_segment": np.zeros(N, bool),
             "every_row": np.ones(N, bool),
             "uint8_flags": rng.random(N) < 0.1}[case]
    tf = from_numpy(flags, device="cpu")
    if case == "uint8_flags":
        tf = tf.to(torch.uint8) * 7  # any non-zero byte is a head
    for op in ("sum", "max"):
        want = jscan.segmented_scan(jnp.asarray(v), jnp.asarray(flags), op)
        got = kscan.segmented_scan_plain(from_numpy(v, device="cpu"), tf, op)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_plain_rejects_bad_input():
    v = torch.zeros(8, dtype=torch.int32)
    f = torch.zeros(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        kscan.segmented_scan(v, f, "prod")
    with pytest.raises(TypeError):
        kscan.segmented_scan(v.to(torch.int64), f, "sum")
    with pytest.raises(TypeError):
        kscan.segmented_scan(v, f.to(torch.int32), "sum")
    with pytest.raises(ValueError):
        kscan.segmented_scan(v, f[:4], "sum")
    assert kscan.segmented_scan(v[:0], f[:0]).shape == (0,)


# (dtype, op, exclusive, init): the routes of ops/scan.py: the kernel
# (named op over i32/u32/f32), the running-sum difference (other integer
# sums) and the flagged doubling (prod, callables, other dtypes)
SCAN_CASES = [
    (np.int32, "sum", True, 5),
    (np.uint32, "min", False, None),
    (np.uint32, "max", True, None),
    (np.float32, "max", True, None),
    (np.float32, "sum", False, 0.5),
    (np.int64, "sum", True, -3),
    (np.int64, "min", False, None),
    (np.int32, "prod", True, None),
    (np.float64, "sum", False, None),
]


@pytest.mark.parametrize("dtype,op,exclusive,init", SCAN_CASES, ids=lambda c: (
    np.dtype(c).name if isinstance(c, type) else str(c)))
def test_segmented_scan_matches_jax(dtype, op, exclusive, init):
    rng = np.random.default_rng(17)
    if dtype in (np.int32, np.uint32, np.float32):
        v = _values(dtype, rng)
    elif dtype == np.int64:
        v = rng.integers(-2**62, 2**62, size=N, dtype=np.int64)
    else:
        v = rng.standard_normal(N)
    if op == "prod":
        v = rng.integers(-3, 4, size=N).astype(dtype)
    flags = rng.random(N) < 0.05
    want = jscan.segmented_scan(jnp.asarray(v), jnp.asarray(flags), op,
                                exclusive=exclusive, init=init)
    got = rt.segmented_scan(from_numpy(v, device="cpu"), from_numpy(flags, device="cpu"), op,
                            exclusive=exclusive, init=init)
    assert_scan_equal(to_numpy(got), want, v, flags, op)


def test_callable_op_and_scan_by_key():
    rng = np.random.default_rng(23)
    k1 = rng.integers(0, 4, size=N).astype(np.uint32)
    k2 = rng.integers(0, 3, size=N).astype(np.int32)
    v = rng.integers(0, 1000, size=N).astype(np.int32)

    def jop(a, b):
        return jnp.bitwise_xor(a, b)

    def top(a, b):
        return torch.bitwise_xor(a, b)

    want = jscan.scan_by_key((jnp.asarray(k1), jnp.asarray(k2)),
                             jnp.asarray(v), jop, identity=0, exclusive=True)
    got = rt.scan_by_key((from_numpy(k1, device="cpu"), from_numpy(k2, device="cpu")), from_numpy(v, device="cpu"),
                         top, identity=0, exclusive=True)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    # a custom equality: keys equal when they share their low bit
    want = jscan.scan_by_key(jnp.asarray(k1), jnp.asarray(v), "max",
                             equality_op=lambda a, b: (a & 1) == (b & 1))
    got = rt.scan_by_key(from_numpy(k1, device="cpu"), from_numpy(v, device="cpu"), "max",
                         equality_op=lambda a, b: (a.view(torch.int32) & 1)
                         == (b.view(torch.int32) & 1))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    with pytest.raises(ValueError, match="identity"):
        rt.segmented_scan(from_numpy(v, device="cpu"), from_numpy(v > 0, device="cpu"), top,
                          exclusive=True)


def test_plain_scan_and_reduce_with():
    rng = np.random.default_rng(29)
    v = rng.integers(-1000, 1000, size=N).astype(np.int32)
    for op in ("sum", "min", "max"):
        want = jscan.plain_scan_fast(jnp.asarray(v), op)
        np.testing.assert_array_equal(
            to_numpy(tscan.plain_scan_fast(from_numpy(v, device="cpu"), op)),
            np.asarray(want))
    v64 = v.astype(np.int64)
    np.testing.assert_array_equal(
        to_numpy(tscan.plain_scan_fast(from_numpy(v64, device="cpu"), "max")),
        np.asarray(jscan.plain_scan_fast(jnp.asarray(v64), "max")))
    want = jscan.plain_scan(jnp.asarray(v), "sum", exclusive=True, init=7)
    got = tscan.plain_scan(from_numpy(v, device="cpu"), "sum", exclusive=True, init=7)
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    for op, init in (("sum", None), ("max", 5000), ("min", None)):
        want = jscan.reduce_with(jnp.asarray(v), op, init)
        got = tscan.reduce_with(from_numpy(v, device="cpu"), op, init)
        assert got.dim() == 0 and int(got) == int(want)
    u = rng.integers(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    want = jscan.reduce_with(jnp.asarray(u), "max")
    assert int(to_numpy(tscan.reduce_with(from_numpy(u, device="cpu"), "max"))) == int(want)


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32],
                         ids=["int32", "uint32", "float32"])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_null_flags_is_all_zero_flags(op, dtype):
    # head_flags=None: the kernel reads no flags; the plain path scans as
    # with all-zero flags (row 0 a head), and so does the entry point here
    rng = np.random.default_rng([len(op), np.dtype(dtype).num, 7])
    v = from_numpy(_values(dtype, rng, nan=(op != "sum")), device="cpu")
    want = kscan.segmented_scan_plain(v, torch.zeros(N, dtype=torch.bool), op)
    for got in (kscan.segmented_scan_plain(v, None, op),
                kscan.segmented_scan(v, None, op)):
        np.testing.assert_array_equal(to_numpy(got), to_numpy(want))
    if dtype == np.int32:
        np.testing.assert_array_equal(
            to_numpy(tscan.plain_scan_fast(v, op)),
            np.asarray(jscan.plain_scan_fast(jnp.asarray(to_numpy(v)), op)))
    with pytest.raises(ValueError):
        kscan.segmented_scan(v.reshape(-1, 1), None, op)


def _kernel_carry(t, words, window, look_max):
    """The carry-in of tile t as csrc/scan.cu's lookback computes it.
    words[u] is ("inc", value) for a tile whose status is INCLUSIVE (a tile
    holding a head, or one whose own lookback is done) and ("agg", value)
    otherwise. Lane i of a window reads tile top - i; aggregates passed go to
    look[depth + i]; at look_max the warp waits on its last window, modelled
    here by that window's newest tile turning INCLUSIVE. The fold is strictly
    left to right from the INCLUSIVE value found."""
    top, depth = t - 1, 0
    look = [np.float32(0)] * (look_max + window)
    while True:
        win = [words[top - i] if top - i >= 0 else None for i in range(window)]
        stops = [i for i, w in enumerate(win) if w is not None and w[0] == "inc"]
        if stops:
            at = stops[0]
            for i in range(at):
                look[depth + i] = win[i][1]
            c = win[at][1]
            for i in range(depth + at - 1, -1, -1):
                c = np.float32(c + look[i])
            return c
        if depth + window <= look_max:
            for i in range(window):
                look[depth + i] = win[i][1]
            depth += window
            top -= window
        else:
            words[top] = ("inc", words[top][2])


def _left_fold(xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = np.float32(acc + x)
    return acc


@settings(max_examples=200, deadline=None)
@given(data=st.data(), geometry=st.sampled_from([(4, 8), (8, 16), (32, 256)]))
def test_lookback_carry_is_the_left_fold_from_the_last_head(data, geometry):
    # float32 tile aggregates, head tiles and tiles whose lookback is done:
    # the carry-in has the same bits whatever INCLUSIVE tile the lookback
    # stops at, the left fold of the aggregates from the last head tile
    window, look_max = geometry
    n = data.draw(st.integers(2, 3 * look_max))
    f32 = st.floats(-1e6, 1e6, width=32, allow_nan=False)
    agg = [np.float32(x) for x in data.draw(st.lists(f32, min_size=n,
                                                      max_size=n))]
    rare = data.draw(st.sampled_from([2, 16, 1 << 30]))  # 1 / head rate
    heads = [True] + [r == 0 for r in data.draw(st.lists(
        st.integers(0, rare - 1), min_size=n - 1, max_size=n - 1))]
    done = data.draw(st.lists(st.booleans(), min_size=n, max_size=n))
    last_head, inc = 0, []
    for j in range(n):
        last_head = j if heads[j] else last_head
        inc.append(_left_fold(agg[last_head:j + 1]))
    # ("agg", value, the value it publishes once its lookback is done)
    status = [("inc", inc[j]) if heads[j] or done[j]
              else ("agg", agg[j], inc[j]) for j in range(n)]
    for t in range(1, n):
        got = _kernel_carry(t, status[:t], window, look_max)
        h = max(j for j in range(t) if heads[j])
        want = _left_fold(agg[h:t])
        assert np.float32(got).view(np.uint32) == want.view(np.uint32), t
