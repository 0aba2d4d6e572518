"""The port's sort slice vs the JAX package, end to end, bit-exact.

The JAX side runs its default CPU configuration, a stable lax.sort, which
any stable sort reproduces bit for bit; the port runs its radix pipeline
through the kernels' plain versions. Floats compare on raw bits, so -0.0
and NaN compare exactly. N is not a multiple of any tile size."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu as rs
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.utils.convert import (config_from_jax,
                                                    from_numpy, to_numpy,
                                                    tree_from_numpy)

N = 3001
KEY_DTYPES = [np.uint32, np.int32, np.float32, np.uint64, np.int64,
              np.float64, np.uint8, np.int16, np.float16, ml_dtypes.bfloat16]


def _raw(a):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return a
    return a.view(f"uint{a.dtype.itemsize * 8}")


def _eq(got, want):
    np.testing.assert_array_equal(_raw(to_numpy(got)), _raw(want))


def make_keys(dtype, n=N, seed=0, distinct=None):
    """Random keys; floats from random bit patterns (NaNs, denormals
    included) plus explicit +-0.0, +-inf, +-NaN. ``distinct`` limits the
    number of distinct values, to exercise stability."""
    dtype = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    width = dtype.itemsize * 8
    u = np.dtype(f"uint{width}")
    bits = rng.integers(0, 2**63, size=n, dtype=np.uint64)
    if width == 64:
        bits = bits | (rng.integers(0, 2, size=n, dtype=np.uint64)
                       << np.uint64(63))
    bits = bits.astype(u)
    if distinct is not None:
        bits = rng.choice(np.unique(bits)[:distinct], size=n)
    keys = bits.view(dtype).copy()
    if dtype.kind == "f" and n >= 8:
        keys[:6] = np.array([0.0, -0.0, np.inf, -np.inf, np.nan,
                             -np.nan], dtype=np.float64).astype(dtype)
        rng.shuffle(keys)
    return keys


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", KEY_DTYPES, ids=lambda d: np.dtype(d).name)
def test_sort_matches_jax(dtype, descending):
    keys = make_keys(dtype, seed=3)
    want = np.asarray(rs.sort(jnp.asarray(keys), descending=descending))
    _eq(rt.sort(from_numpy(keys, device="cpu"), descending=descending), want)


@pytest.mark.parametrize("pay_dtype", [np.uint32, np.int32, np.float32,
                                       np.bool_, np.int8, np.int64,
                                       np.float64])
def test_sort_pairs_payloads(pay_dtype):
    rng = np.random.default_rng(7)
    keys = make_keys(np.uint32, seed=5, distinct=40)  # many ties
    pay = make_keys(pay_dtype, seed=11) if pay_dtype != np.bool_ else (
        rng.random(N) < 0.5)
    idx = np.arange(N, dtype=np.int32)  # proves stability
    jk, (jp, ji) = rs.sort_pairs(jnp.asarray(keys),
                                 (jnp.asarray(pay), jnp.asarray(idx)))
    tk, (tp, ti) = rt.sort_pairs(from_numpy(keys, device="cpu"),
                                 (from_numpy(pay, device="cpu"), from_numpy(idx, device="cpu")))
    _eq(tk, np.asarray(jk))
    _eq(tp, np.asarray(jp))
    _eq(ti, np.asarray(ji))
    assert tp.dtype == from_numpy(pay, device="cpu").dtype


@pytest.mark.parametrize("key_dtype,descending", [
    (np.uint64, False), (np.int64, True), (np.float64, False),
    (np.float16, True), (ml_dtypes.bfloat16, False)])
def test_sort_pairs_wide_and_narrow_keys(key_dtype, descending):
    keys = make_keys(key_dtype, seed=13, distinct=100)
    vals = {"f64": make_keys(np.float64, seed=2), "u32": make_keys(np.uint32)}
    jk, jv = rs.sort_pairs(jnp.asarray(keys),
                           {k: jnp.asarray(v) for k, v in vals.items()},
                           descending=descending)
    tk, tv = rt.sort_pairs(from_numpy(keys, device="cpu"), tree_from_numpy(vals, device="cpu"),
                           descending=descending)
    _eq(tk, np.asarray(jk))
    for name in vals:
        _eq(tv[name], np.asarray(jv[name]))


@pytest.mark.parametrize("dtype,begin,end", [
    (np.uint32, 0, 8), (np.int32, 0, 16), (np.uint32, 3, 13),
    (np.uint64, 28, 36), (np.float64, 0, 40)])
def test_bit_ranges(dtype, begin, end):
    keys = make_keys(dtype, seed=17)
    idx = np.arange(N, dtype=np.uint32)
    jk, ji = rs.sort_pairs(jnp.asarray(keys), jnp.asarray(idx),
                           begin_bit=begin, end_bit=end)
    tk, ti = rt.sort_pairs(from_numpy(keys, device="cpu"), from_numpy(idx, device="cpu"),
                           begin_bit=begin, end_bit=end)
    _eq(tk, np.asarray(jk))
    _eq(ti, np.asarray(ji))
    _eq(rt.sort(from_numpy(keys, device="cpu"), begin_bit=begin, end_bit=end),
        np.asarray(rs.sort(jnp.asarray(keys), begin_bit=begin, end_bit=end)))


@pytest.mark.parametrize("dtype,descending,end", [
    (np.uint32, False, None), (np.float32, True, None), (np.int8, False, None),
    (np.uint64, False, 40)])
def test_argsort(dtype, descending, end):
    keys = make_keys(dtype, seed=19, distinct=300)
    want = np.asarray(rs.argsort(jnp.asarray(keys), descending=descending,
                                 end_bit=end))
    got = rt.argsort(from_numpy(keys, device="cpu"), descending=descending, end_bit=end)
    assert got.dtype == torch.int32
    _eq(got, want)


def test_unstable_pairs_multiset_within_key():
    keys = make_keys(np.uint32, seed=23, distinct=20)
    pay = make_keys(np.uint32, seed=29)
    jk, jp = rs.sort_pairs(jnp.asarray(keys), jnp.asarray(pay), stable=False)
    tk, tp = rt.sort_pairs(from_numpy(keys, device="cpu"), from_numpy(pay, device="cpu"), stable=False)
    tk, tp, jk, jp = to_numpy(tk), to_numpy(tp), np.asarray(jk), np.asarray(jp)
    np.testing.assert_array_equal(tk, jk)
    # equal as a multiset within each key: sort payloads inside key runs
    np.testing.assert_array_equal(tp[np.lexsort((tp, tk))],
                                  jp[np.lexsort((jp, jk))])


@pytest.mark.parametrize("n", [0, 1, 2])
def test_tiny_inputs(n):
    keys = make_keys(np.int32, n=n, seed=31)
    pay = np.arange(n, dtype=np.int64)
    _eq(rt.sort(from_numpy(keys, device="cpu")), np.asarray(rs.sort(jnp.asarray(keys))))
    tk, tp = rt.sort_pairs(from_numpy(keys, device="cpu"), from_numpy(pay, device="cpu"))
    jk, jp = rs.sort_pairs(jnp.asarray(keys), jnp.asarray(pay))
    _eq(tk, np.asarray(jk))
    _eq(tp, np.asarray(jp))


def test_constant_keys_skip_every_pass():
    from cuda.radixsort_tpu_torch.kernels import stage

    keys = np.full(N, 0xDEADBEEF, dtype=np.uint32)
    pay = make_keys(np.float32, seed=37)
    pay_t = from_numpy(pay, device="cpu")
    calls = []
    orig = stage.partition_stage_plain
    stage.partition_stage_plain = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        tk, tp = rt.sort_pairs(from_numpy(keys, device="cpu"), pay_t)
    finally:
        stage.partition_stage_plain = orig
    assert calls == []  # every digit puts all keys in one bucket
    _eq(tk, keys)
    _eq(tp, pay)
    assert tp.data_ptr() != pay_t.data_ptr()  # a new tensor, not the input


def test_unique_leading_payload_is_the_stable_result():
    # the join's (position tag, value) companions: a unique u32 tag first
    keys = make_keys(np.uint32, seed=71, distinct=30)
    tag = np.arange(N, dtype=np.uint32) | np.uint32(1 << 31) * (
        np.arange(N) % 7 == 0)
    vals = make_keys(np.int32, seed=73)
    jk, (jt, jv) = rs.sort_pairs(jnp.asarray(keys),
                                 (jnp.asarray(tag), jnp.asarray(vals)),
                                 unique_leading_payload=True)
    tk, (tt, tv) = rt.sort_pairs(from_numpy(keys, device="cpu"),
                                 (from_numpy(tag, device="cpu"), from_numpy(vals, device="cpu")),
                                 unique_leading_payload=True)
    for g, w in ((tk, jk), (tt, jt), (tv, jv)):
        _eq(g, np.asarray(w))
    _, (st, _) = rt.sort_pairs(from_numpy(keys, device="cpu"),
                               (from_numpy(tag, device="cpu"), from_numpy(vals, device="cpu")))
    _eq(tt, to_numpy(st))


def test_sort_struct_matches_jax():
    a = make_keys(np.int32, seed=41, distinct=7)
    b = make_keys(np.float64, seed=43, distinct=50)
    c = make_keys(np.uint8, seed=47)
    vals = [make_keys(np.int64, seed=53), make_keys(np.float16, seed=59)]
    (ja, jb, jc), jv = rs.sort_struct(
        [jnp.asarray(x) for x in (a, b, c)], [jnp.asarray(v) for v in vals],
        descending=True)
    (ta, tb, tc), tv = rt.sort_struct([from_numpy(x, device="cpu") for x in (a, b, c)],
                                      tree_from_numpy(vals, device="cpu"), descending=True)
    for g, w in zip((ta, tb, tc, *tv), (ja, jb, jc, *jv)):
        _eq(g, np.asarray(w))
    assert isinstance(tv, list)
    keys_only = rt.sort_struct([from_numpy(a, device="cpu"), from_numpy(c, device="cpu")])
    ja2, jc2 = rs.sort_struct([jnp.asarray(a), jnp.asarray(c)])
    _eq(keys_only[0], np.asarray(ja2))
    _eq(keys_only[1], np.asarray(jc2))


@pytest.mark.parametrize("radix_bits", [2, 4, 8])
def test_digit_widths(radix_bits):
    keys = make_keys(np.uint64, seed=61, distinct=500)
    idx = np.arange(N, dtype=np.int32)
    jk, ji = rs.sort_pairs(jnp.asarray(keys), jnp.asarray(idx),
                           begin_bit=5, end_bit=59)
    cfg = rt.SortConfig(radix_bits=radix_bits)
    tk, ti = rt.sort_pairs(from_numpy(keys, device="cpu"), from_numpy(idx, device="cpu"), begin_bit=5,
                           end_bit=59, config=cfg)
    _eq(tk, np.asarray(jk))
    _eq(ti, np.asarray(ji))


def test_config():
    assert rt.resolve(rt.SortConfig()).engine == "radix"
    assert rt.preset((9, 0)).radix_bits == 8
    assert rt.preset((9, 0)).tile_elems == 256 * 32
    with pytest.raises(ValueError):
        rt.preset((8, 0))
    net = rt.SortConfig(engine="bitonic")
    assert rt.resolve(net).engine == "bitonic"
    got = rt.sort(torch.tensor([3, -1, 2, -7], dtype=torch.int32), config=net)
    assert got.tolist() == [-7, -1, 2, 3]
    with pytest.raises(ValueError):
        rt.SortConfig(radix_bits=5)
    with pytest.raises(ValueError):
        rt.SortConfig(block_threads=1024)
    assert config_from_jax(rs.SortConfig(engine="pallas", radix_bits=3)) == \
        rt.SortConfig(radix_bits=2, engine="radix")
    assert config_from_jax(rs.SortConfig()).engine == "auto"
    assert config_from_jax(rs.SortConfig(engine="bitonic")).engine == "bitonic"


def test_rejects_mismatched_values():
    keys = from_numpy(make_keys(np.uint32, n=10), device="cpu")
    with pytest.raises(ValueError):
        rt.sort_pairs(keys, torch.zeros(9))
    with pytest.raises(ValueError):
        rt.sort(keys.reshape(2, 5))
    with pytest.raises(ValueError):
        rt.sort(keys, begin_bit=4, end_bit=40)
    # 2^31 rows are a device sort; one more is not (no memory is touched)
    huge = torch.zeros(1, dtype=torch.uint8).expand((1 << 31) + 1)
    with pytest.raises(ValueError, match="int32-indexed"):
        rt.sort(huge)


@pytest.mark.parametrize("begin,end,descending", [
    (0, 64, False), (5, 59, True), (28, 36, False), (0, 40, True),
    (32, 64, True)])
def test_u64_pipeline_one_histogram_per_sort(begin, end, descending,
                                             monkeypatch):
    # the LSD loop counts every limb's stages in one histogram call before
    # the first pass (one launch and one host read on the card), whatever
    # the bit range; the result is the JAX package's, bit for bit
    from cuda.radixsort_tpu_torch.kernels import histogram as hist_lib

    calls = []
    real = hist_lib.limb_histograms

    def counted(limbs, limb_bits, width, **kw):
        calls.append([tuple(b) for b in limb_bits])
        return real(limbs, limb_bits, width, **kw)

    monkeypatch.setattr(hist_lib, "limb_histograms", counted)
    monkeypatch.setattr(hist_lib, "digit_histograms", None)  # not on the path
    keys = make_keys(np.uint64, seed=begin + end, distinct=700)
    idx = np.arange(N, dtype=np.uint32)
    jk, ji = rs.sort_pairs(jnp.asarray(keys), jnp.asarray(idx),
                           begin_bit=begin, end_bit=end, descending=descending)
    tk, ti = rt.sort_pairs(from_numpy(keys, device="cpu"), from_numpy(idx, device="cpu"), begin_bit=begin,
                           end_bit=end, descending=descending)
    _eq(tk, np.asarray(jk))
    _eq(ti, np.asarray(ji))
    assert len(calls) == 1 and len(calls[0]) == 2, calls


def test_device_row_limit_matches_the_reference():
    # 2^31 rows sort on the device (one digit can count 2^31: the kernels
    # count and place in u32); one more is out-of-core work, as in JAX
    from cuda.radixsort_tpu.ops.sort import _check_device_n as jcheck
    from cuda.radixsort_tpu_torch.ops.sort import _check_device_n

    for n in (2**31 - 1, 2**31):
        _check_device_n(n)
        jcheck(n)
    for check in (_check_device_n, jcheck):
        with pytest.raises(ValueError, match="int32-indexed"):
            check(2**31 + 1)


def test_u32_counts_and_bases_of_a_full_digit():
    # a digit that counts 2^31 keys: its int32 bits read back as 2^31, and
    # the bases after it are 2^31 (u32 bits in the int32 tensor)
    from cuda.radixsort_tpu_torch.kernels import histogram as khist

    hist = torch.zeros((1, 4), dtype=torch.int32)
    hist[0, 1] = -(1 << 31)  # the u32 count 2^31
    assert khist.counts64(hist).tolist() == [[0, 1 << 31, 0, 0]]
    bases = khist.stage_bases(hist)
    assert (bases.to(torch.int64) & 0xFFFFFFFF).tolist() == [
        [0, 0, 1 << 31, 1 << 31]]
