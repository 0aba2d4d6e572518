"""The port's sort vs the JAX package's own radix engine (Pallas kernels in
interpret mode), bit-exact. One case: the interpret-mode pipeline costs
tens of seconds on the CPU."""

import jax.numpy as jnp
import numpy as np

import cuda.radixsort_tpu as rs
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.utils.convert import (config_from_jax,
                                                    from_numpy, to_numpy)


def test_sort_bit_range_matches_jax_pallas_engine():
    n = 5000  # not a multiple of either package's tile
    rng = np.random.default_rng(71)
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    # many ties on the sorted bits [0, 16) whose upper bits differ: the
    # order of the untouched upper bits shows that the sort is stable
    keys[rng.random(n) < 0.3] &= np.uint32(0xFFFF_00FF)
    jcfg = rs.SortConfig(engine="pallas", interpret=True, stage_rows=8,
                         radix_bits=2)
    want = rs.sort(jnp.asarray(keys), end_bit=16, config=jcfg)
    got = rt.sort(from_numpy(keys, device="cpu"), end_bit=16, config=config_from_jax(jcfg))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
