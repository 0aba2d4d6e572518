"""Port all-digit histogram vs the JAX kernel (interpret mode), bit-exact.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel is
held against the same plain version on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda.radixsort_tpu.kernels import histogram as jhist
from cuda.radixsort_tpu_torch.kernels import histogram as thist
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

N = 8192  # 64 rows of 128 lanes for the JAX kernel


def _keys(case, seed):
    rng = np.random.default_rng(seed)
    if case == "constant":
        return np.full(N, 0xABCD1234, dtype=np.uint32)
    return rng.integers(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("case,width,n_stages", [
    ("random", 4, 8),
    ("random", 2, 16),
    ("constant", 4, 8),
])
def test_histogram_matches_jax_interpret(case, width, n_stages):
    keys = _keys(case, seed=width * 10 + n_stages)
    want = np.asarray(jhist.digit_histograms(
        jnp.asarray(keys).reshape(-1, 128), n_stages=n_stages, width=width,
        interpret=True))
    got = to_numpy(thist.digit_histograms_plain(
        from_numpy(keys, device="cpu"), n_stages=n_stages, width=width))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # on a CPU tensor the wrapper is the plain version
    np.testing.assert_array_equal(
        to_numpy(thist.digit_histograms(from_numpy(keys, device="cpu"), n_stages=n_stages,
                                        width=width)), want)
    np.testing.assert_array_equal(
        to_numpy(thist.stage_bases(torch.from_numpy(want.copy()))),
        np.asarray(jhist.stage_bases(jnp.asarray(want))))


@pytest.mark.parametrize("n", [0, 1, 1000, 4099])
def test_histogram_width8_vs_numpy(n):
    # the JAX kernel holds at most 128 bins, so width 8 is held to numpy
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    got = to_numpy(thist.digit_histograms(from_numpy(keys, device="cpu"), n_stages=4,
                                          width=8))
    for s in range(4):
        want = np.bincount((keys >> np.uint32(8 * s)) & np.uint32(255),
                           minlength=256)
        np.testing.assert_array_equal(got[s], want, err_msg=f"stage {s}")


def test_histogram_rejects_bad_input():
    keys = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(TypeError):
        thist.digit_histograms(keys, n_stages=4, width=8)
    u = keys.view(torch.uint32)
    with pytest.raises(ValueError):
        thist.digit_histograms(u, n_stages=5, width=8)  # 40 bits > 32
    with pytest.raises(ValueError):
        thist.digit_histograms(u, n_stages=4, width=3)
    with pytest.raises(ValueError):
        thist.digit_histograms(u.reshape(16, 16).t(), n_stages=4, width=8)


# (width, limb_bits): width-aligned ranges count the limb as it is, other
# ranges the limb masked to [begin, end), as the JAX pipeline does; an empty
# range has no histogram
LIMB_CASES = [
    (4, [(0, 32), (0, 32)]),
    (4, [(0, 27), (5, 32)]),
    (2, [(3, 13)]),
    (2, [(0, 32), (28, 32), (7, 7)]),
    (4, [(12, 20), (0, 0)]),
]


@pytest.mark.parametrize("width,limb_bits", LIMB_CASES)
def test_limb_histograms_match_jax_interpret(width, limb_bits):
    rng = np.random.default_rng([width, len(limb_bits), limb_bits[0][1]])
    limbs = [rng.integers(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
             for _ in limb_bits]
    want = []
    for limb, (begin, end) in zip(limbs, limb_bits):
        if begin >= end:
            continue
        key = limb
        if begin % width or end % width:
            key = limb & np.uint32(((1 << end) - 1) & ~((1 << begin) - 1))
        want.append(np.asarray(jhist.digit_histograms(
            jnp.asarray(key).reshape(-1, 128), n_stages=-(-end // width),
            width=width, interpret=True)))
    want = np.concatenate(want)
    tlimbs = [from_numpy(x, device="cpu") for x in limbs]
    got = to_numpy(thist.limb_histograms_plain(tlimbs, limb_bits, width))
    np.testing.assert_array_equal(got, want)
    # on CPU tensors the entry point is the plain version
    np.testing.assert_array_equal(
        to_numpy(thist.limb_histograms(tlimbs, limb_bits, width)), want)


@pytest.mark.parametrize("n", [1, 3, 17, 1000])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_limb_histograms_of_views(n, offset):
    # views at element offsets 1-3 (unaligned data pointers on the card)
    rng = np.random.default_rng([n, offset])
    full = rng.integers(0, 2**32, size=(2, n + offset),
                        dtype=np.uint64).astype(np.uint32)
    limbs = [from_numpy(row, device="cpu")[offset:] for row in full]
    got = to_numpy(thist.limb_histograms(limbs, [(0, 32), (4, 30)], 8))
    hi, lo = full[0, offset:], full[1, offset:] & np.uint32(0x3FFFFFF0)
    for s in range(4):
        for row, key in ((s, hi), (4 + s, lo)):
            want = np.bincount((key >> np.uint32(8 * s)) & np.uint32(255),
                               minlength=256)
            np.testing.assert_array_equal(got[row], want, err_msg=f"row {row}")


def test_limb_stages_and_empty_ranges():
    assert thist.limb_stages([(0, 32), (3, 13), (8, 8), (0, 30)], 4) == [
        (0xFFFFFFFF, 8), (0x1FF8, 4), (0, 0), (0x3FFFFFFF, 8)]
    keys = from_numpy(np.arange(10, dtype=np.uint32), device="cpu")
    out = thist.limb_histograms([keys], [(5, 5)], 8)
    assert out.shape == (0, 256) and out.dtype == torch.int32
    with pytest.raises(ValueError):
        thist.limb_histograms([keys], [(0, 32), (0, 32)], 8)
    with pytest.raises(ValueError):
        thist.limb_histograms([keys, keys[:5]], [(0, 32), (0, 32)], 8)
    with pytest.raises(ValueError):
        thist.limb_histograms([keys], [(0, 33)], 8)
    with pytest.raises(ValueError):
        thist.limb_histograms([keys], [(0, 32)], 3)


@pytest.mark.parametrize("width,n_stages", [(2, 16), (2, 13), (4, 8), (4, 7),
                                            (8, 4), (8, 3), (2, 1)])
def test_stage_histograms_are_sums_of_byte_histograms(width, n_stages):
    # the kernel counts each key's bytes and its last block writes stage s,
    # bin b as the sum of the byte bins v of the byte holding bits
    # [width*s, width*s + width) whose bits there are b (csrc/histogram.cu);
    # the same loops here give the plain histograms
    rng = np.random.default_rng([width, n_stages])
    keys = rng.integers(0, 2**32, size=N, dtype=np.uint64).astype(np.uint32)
    n_bytes = -(-n_stages * width // 8)
    byte_bins = [np.bincount((keys >> np.uint32(8 * s)) & np.uint32(255),
                             minlength=256) for s in range(n_bytes)]
    nb = 1 << width
    got = np.zeros((n_stages, nb), dtype=np.int64)
    for j in range(n_stages * nb):
        bit, b = (j >> width) * width, j & (nb - 1)
        lo, row = bit & 7, byte_bins[bit >> 3]
        got[j >> width, b] = sum(row[(hi << (lo + width)) | (b << lo) | v]
                                 for hi in range(256 >> (lo + width))
                                 for v in range(1 << lo))
    want = to_numpy(thist.digit_histograms_plain(
        from_numpy(keys, device="cpu"), n_stages=n_stages, width=width))
    np.testing.assert_array_equal(got, want)
