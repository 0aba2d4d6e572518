"""The port's sort vs the JAX package's own radix engine (Pallas kernels in
interpret mode), bit-exact: one case of ``sort`` and one of ``sort_large``,
whose partition runs on the Pallas kernels only; each interpret-mode call
costs 15-25 s on the CPU."""

import importlib

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


def test_sort_large_matches_jax_pallas_interpret():
    jsort = importlib.import_module("cuda.radixsort_tpu.ops.sort")
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    cfg = rs.SortConfig(engine="pallas", interpret=True)
    want = jsort.sort_large(jnp.asarray(keys), descending=True, msd_bits=4,
                            config=cfg)
    got = rt.sort_large(from_numpy(keys, device="cpu"), descending=True,
                        msd_bits=4)
    np.testing.assert_array_equal(to_numpy(got).view(np.uint32),
                                  np.asarray(want).view(np.uint32))
