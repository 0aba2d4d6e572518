"""Port twiddle vs the JAX twiddle: every key dtype, both orders, special
values (+-0.0, +-inf, +-NaN, denormals, integer extremes). Bit-exact."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

from cuda.radixsort_tpu import twiddle as jtw
from cuda.radixsort_tpu_torch import twiddle as ttw
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

# float dtype -> (exponent bits, mantissa bits)
_FLOAT_LAYOUT = {
    np.dtype(np.float16): (5, 10),
    np.dtype(ml_dtypes.bfloat16): (8, 7),
    np.dtype(np.float32): (8, 23),
    np.dtype(np.float64): (11, 52),
}
DTYPES = [np.uint8, np.uint16, np.uint32, np.uint64, np.int8, np.int16,
          np.int32, np.int64, np.float16, ml_dtypes.bfloat16, np.float32,
          np.float64]


def _ubits(dtype):
    return np.dtype(f"uint{np.dtype(dtype).itemsize * 8}")


def _raw(a):
    """Raw unsigned bits of a numpy array (compare floats on bits)."""
    return np.asarray(a).view(_ubits(a.dtype))


def keys_with_specials(dtype, n=4000, seed=0):
    dtype = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    u = _ubits(dtype)
    width = dtype.itemsize * 8
    rand = rng.integers(0, 2**63, size=n, dtype=np.uint64)
    rand = (rand & np.uint64((1 << width) - 1 if width < 64 else 2**64 - 1))
    bits = rand.astype(u)
    if dtype in _FLOAT_LAYOUT:
        e, m = _FLOAT_LAYOUT[dtype]
        sign = 1 << (width - 1)
        inf = ((1 << e) - 1) << m
        special = [0, sign, inf, sign | inf, inf | 1, sign | inf | 1,
                   inf | (1 << (m - 1)), sign | inf | (1 << (m - 1)),
                   1, sign | 1, (1 << m) - 1, sign | ((1 << m) - 1),
                   inf - 1, sign | (inf - 1)]
        sp = np.array(special, dtype=np.uint64).astype(u)
        out = np.concatenate([bits, sp, sp]).view(dtype)
    else:
        info = np.iinfo(dtype)
        sp = np.array([info.min, info.max, 0, 1, info.min + 1, info.max - 1]
                      + ([-1] if info.min < 0 else []), dtype=dtype)
        out = np.concatenate([bits.view(dtype), sp, sp])
    rng.shuffle(out)
    return out


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_twiddle_matches_jax(dtype, descending):
    keys = keys_with_specials(dtype)
    want_bits = np.asarray(jtw.twiddle_in(jnp.asarray(keys), descending))
    got = ttw.twiddle_in(from_numpy(keys, device="cpu"), descending)
    assert got.dtype == ttw.unsigned_dtype(from_numpy(keys, device="cpu").dtype)
    got_bits = to_numpy(got)
    np.testing.assert_array_equal(_raw(got_bits), _raw(want_bits))

    want_back = np.asarray(jtw.twiddle_out(jnp.asarray(want_bits), keys.dtype,
                                           descending))
    got_back = to_numpy(ttw.twiddle_out(got, from_numpy(keys, device="cpu").dtype,
                                        descending))
    assert got_back.dtype == keys.dtype
    np.testing.assert_array_equal(_raw(got_back), _raw(want_back))


def test_twiddle_widths_and_errors():
    import torch

    assert ttw.bit_width(torch.bfloat16) == 16
    assert ttw.bit_width(torch.float64) == 64
    assert ttw.unsigned_dtype(torch.int8) == torch.uint8
    with pytest.raises(TypeError):
        ttw.unsigned_dtype(torch.bool)


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.uint64, np.int32,
                                   np.float32])
def test_greater_compares_as_numbers(dtype):
    """twiddle.greater(t, x) == numpy's t > x for every dtype, thresholds
    inside and outside the dtype's range and between integers."""
    info = (np.iinfo(dtype) if np.dtype(dtype).kind in "iu"
            else np.finfo(dtype))
    rng = np.random.default_rng(np.dtype(dtype).itemsize)
    x = np.concatenate([[info.min, info.max, 0, 1],
                        rng.integers(0, 2**15, 60)]).astype(dtype)
    t = from_numpy(x, device="cpu")
    edge = ((int(info.max) - 1, int(info.max))
            if np.dtype(dtype).kind in "iu" else (1e30,))
    for th in (-1, 0, 5, 5.5, 2**15) + edge + (
            (2**70,) if np.dtype(dtype).kind == "u" else ()):
        got = to_numpy(ttw.greater(t, th))
        want = np.array([int(v) > th if np.dtype(dtype).kind in "iu"
                         else float(v) > th for v in x])
        np.testing.assert_array_equal(got, want, err_msg=str(th))
