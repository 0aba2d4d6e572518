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
        from_numpy(keys), n_stages=n_stages, width=width))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # on a CPU tensor the wrapper is the plain version
    np.testing.assert_array_equal(
        to_numpy(thist.digit_histograms(from_numpy(keys), n_stages=n_stages,
                                        width=width)), want)
    np.testing.assert_array_equal(
        to_numpy(thist.stage_bases(torch.from_numpy(want.copy()))),
        np.asarray(jhist.stage_bases(jnp.asarray(want))))


@pytest.mark.parametrize("n", [0, 1, 1000, 4099])
def test_histogram_width8_vs_numpy(n):
    # the JAX kernel holds at most 128 bins, so width 8 is held to numpy
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    got = to_numpy(thist.digit_histograms(from_numpy(keys), n_stages=4,
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
