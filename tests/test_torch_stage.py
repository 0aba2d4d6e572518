"""Port counting pass vs the JAX stage kernel (interpret mode), bit-exact.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernels are
held against the same plain version on the card by chip_smoke.py. Each JAX
interpret call costs several seconds, so only four are made here."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda.radixsort_tpu.kernels import stage as jstage
from cuda.radixsort_tpu_torch.kernels import stage as tstage
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

N = 8192  # 64 rows of 128 lanes: one JAX tile at rows=64


def _gbase(keys, shift, width):
    d = (keys >> np.uint32(shift)) & np.uint32((1 << width) - 1)
    hist = np.bincount(d, minlength=1 << width)
    return (np.cumsum(hist) - hist).astype(np.int32)


def _keys(case, rng, n=N):
    if case == "constant":
        return np.full(n, 0x7777_0005, dtype=np.uint32)
    if case == "empty_buckets":
        return (rng.integers(0, 2, size=n, dtype=np.uint32) * 8)
    return rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _oracle(planes, shift, width):
    d = (planes[0] >> np.uint32(shift)) & np.uint32((1 << width) - 1)
    order = np.argsort(d, kind="stable")
    return [p[order] for p in planes]


@pytest.mark.parametrize("case,width,shift,n_planes", [
    ("random", 4, 0, 1),
    ("random", 4, 28, 3),
    ("constant", 2, 0, 1),
    ("empty_buckets", 2, 2, 1),
])
def test_stage_matches_jax_interpret(case, width, shift, n_planes):
    rng = np.random.default_rng(shift * 7 + width + n_planes)
    keys = _keys(case, rng)
    planes = [keys] + [rng.integers(0, 2**32, size=N, dtype=np.uint64)
                       .astype(np.uint32) for _ in range(n_planes - 1)]
    gbase = _gbase(keys, shift, width)
    want = jstage.partition_stage(
        [jnp.asarray(p).reshape(-1, 128) for p in planes], jnp.asarray(gbase),
        shift=shift, width=width, rows=64, interpret=True)
    want = [np.asarray(w).reshape(-1) for w in want]
    got = tstage.partition_stage([from_numpy(p) for p in planes],
                                 from_numpy(gbase), shift=shift, width=width)
    assert len(got) == n_planes
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g), w)


@pytest.mark.parametrize("n,shift,n_planes,case", [
    (8192, 0, 1, "random"),
    (5003, 24, 3, "random"),
    (4097, 8, 10, "random"),   # more planes than one kernel launch takes
    (3000, 16, 2, "constant"),
    (1, 0, 2, "random"),
    (0, 0, 1, "random"),
])
def test_stage_width8_vs_numpy(n, shift, n_planes, case):
    # the JAX stage kernel takes widths 2 and 4 only
    rng = np.random.default_rng(n + shift)
    keys = _keys(case, rng, n)
    planes = [keys] + [rng.integers(0, 2**32, size=n, dtype=np.uint64)
                       .astype(np.uint32) for _ in range(n_planes - 1)]
    out = [torch.empty(n, dtype=torch.uint32) for _ in planes]
    got = tstage.partition_stage([from_numpy(p) for p in planes],
                                 from_numpy(_gbase(keys, shift, 8)),
                                 shift=shift, width=8, out=out)
    assert all(g is o for g, o in zip(got, out))
    for g, w in zip(got, _oracle(planes, shift, 8)):
        np.testing.assert_array_equal(to_numpy(g), w)


def test_stage_rejects_bad_input():
    keys = torch.arange(64, dtype=torch.int32).view(torch.uint32)
    gb = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(TypeError):
        tstage.partition_stage([keys.view(torch.int32)], gb, shift=0, width=8)
    with pytest.raises(ValueError):
        tstage.partition_stage([keys], gb, shift=28, width=8)  # past bit 32
    with pytest.raises(ValueError):
        tstage.partition_stage([keys], gb[:16], shift=0, width=8)
    with pytest.raises(ValueError):
        tstage.partition_stage([keys], gb, shift=0, width=8, out=[keys])
    with pytest.raises(ValueError):
        tstage.partition_stage([keys, keys[:32]], gb, shift=0, width=8)
