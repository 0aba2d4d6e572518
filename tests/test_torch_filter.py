"""The port's compaction (selection vectors, filter_columns) vs the JAX
package's default CPU engine, bit for bit, tail rows included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu as rs
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch.ops.filter import compaction_config
from cuda.radixsort_tpu_torch.utils.convert import (from_numpy, to_numpy,
                                                    tree_from_numpy)

N = 3001


def _raw(a):
    a = np.asarray(a)
    return a if a.dtype == np.bool_ else a.view(f"uint{a.dtype.itemsize * 8}")


@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_selection_vector_matches_jax(density):
    rng = np.random.default_rng(int(density * 10))
    mask = rng.random(N) < density
    jsel, jcount = rs.selection_vector(jnp.asarray(mask))
    tsel, tcount = rt.selection_vector(from_numpy(mask, device="cpu"))
    assert tsel.dtype == torch.int32 and tcount.dtype == torch.int32
    assert tcount.dim() == 0 and int(tcount) == int(jcount)
    np.testing.assert_array_equal(to_numpy(tsel), np.asarray(jsel))


def test_filter_columns_matches_jax():
    rng = np.random.default_rng(3)
    mask = rng.random(N) < 0.4
    cols = {"u64": rng.integers(0, 2**64, size=N, dtype=np.uint64),
            "f32": rng.standard_normal(N).astype(np.float32),
            "pair": (rng.integers(-9, 9, size=N).astype(np.int8),
                     rng.random(N) < 0.5)}
    jout, jcount = rs.filter_columns(
        jnp.asarray(mask), {"u64": jnp.asarray(cols["u64"]),
                            "f32": jnp.asarray(cols["f32"]),
                            "pair": tuple(jnp.asarray(c)
                                          for c in cols["pair"])})
    tout, tcount = rt.filter_columns(from_numpy(mask, device="cpu"), tree_from_numpy(cols, device="cpu"))
    assert int(tcount) == int(jcount) == mask.sum()
    for g, w in [(tout["u64"], jout["u64"]), (tout["f32"], jout["f32"]),
                 (tout["pair"][0], jout["pair"][0]),
                 (tout["pair"][1], jout["pair"][1])]:
        np.testing.assert_array_equal(_raw(to_numpy(g)), _raw(w))
    assert isinstance(tout["pair"], tuple)
    # a single tensor column, and a uint8 mask
    u = cols["u64"].astype(np.uint32)
    jo, _ = rs.filter_columns(jnp.asarray(mask), jnp.asarray(u))
    to, tc = rt.filter_columns(from_numpy(mask, device="cpu").to(torch.uint8), from_numpy(u, device="cpu"))
    np.testing.assert_array_equal(to_numpy(to), np.asarray(jo))
    assert int(tc) == mask.sum()


def test_compaction_takes_one_two_bit_pass():
    from cuda.radixsort_tpu_torch.kernels import stage

    cfg = compaction_config()
    assert cfg.radix_bits == 2 and cfg.engine == "radix"
    assert compaction_config(rt.SortConfig(radix_bits=8,
                                           items_per_thread=8)).items_per_thread == 8
    assert config_lib.for_partition(rt.SortConfig(engine="bitonic"),
                                    bits=8).engine == "radix"
    assert config_lib.for_partition(rt.SortConfig(), bits=3).radix_bits == 8
    calls = []
    orig = stage.partition_stage_plain
    stage.partition_stage_plain = lambda *a, **k: calls.append(k) or orig(*a, **k)
    try:
        mask = torch.arange(100) % 3 == 0
        out, count = rt.filter_columns(mask, torch.arange(100, dtype=torch.int32))
    finally:
        stage.partition_stage_plain = orig
    assert [(k["shift"], k["width"]) for k in calls] == [(0, 2)]
    assert int(count) == 34
    assert out[:34].tolist() == list(range(0, 100, 3))


def test_empty_and_tiny():
    for n in (0, 1):
        mask = np.ones(n, bool)
        sel, count = rt.selection_vector(from_numpy(mask, device="cpu"))
        assert sel.shape == (n,) and int(count) == n
