"""The port's segmented sort vs the JAX package, bit for bit, on both
engines: the network ('bitonic': the (segment, key) 2-plane sort, or the
segment-limb pair sort) and the radix pipeline. A segmented sort is
stable, so its output is one array whichever engine computes it: both
port engines are held to JAX's stable lax.sort engine, which compiles in
a second where JAX's network in interpret mode takes tens."""

import jax.numpy as jnp
import numpy as np
import pytest

import cuda.radixsort_tpu as rs
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.utils.convert import (config_from_jax,
                                                    from_numpy,
                                                    tree_from_numpy)
from test_torch_sort import _eq, make_keys

N = 1000
# segments of 0, 1 and many rows, the last one reaching the end
OFFSETS = np.array([0, 0, 1, 17, 17, 300, 301, 640, 999, N], dtype=np.int32)
# the port's engine -> its config; JAX's stable lax.sort engine is the
# reference of both (config_from_jax maps it to 'auto', the radix pipeline)
JCFG = rs.SortConfig(engine="xla")
ENGINES = {"bitonic": rt.SortConfig(engine="bitonic"),
           "radix": config_from_jax(JCFG)}


def _run(engine, keys, values=None, **kw):
    jcfg = JCFG
    tcfg = ENGINES[engine]
    jv = None if values is None else (
        tuple(jnp.asarray(v) for v in values) if isinstance(values, tuple)
        else jnp.asarray(values))
    want = rs.segmented_sort.__wrapped__(jnp.asarray(keys),
                                         jnp.asarray(OFFSETS), jv,
                                         config=jcfg, **kw)
    got = rt.segmented_sort(from_numpy(keys, device="cpu"), from_numpy(OFFSETS, device="cpu"),
                            None if values is None else tree_from_numpy(values, device="cpu"),
                            config=tcfg, **kw)
    return got, want


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("dtype,descending", [
    (np.uint32, False), (np.float32, True), (np.int8, False),
    (np.uint64, True)])
def test_keys_only(engine, dtype, descending):
    keys = make_keys(dtype, n=N, seed=3, distinct=100)
    got, want = _run(engine, keys, descending=descending)
    _eq(got, np.asarray(want))


@pytest.mark.parametrize("engine", list(ENGINES))
def test_with_values_is_stable(engine):
    keys = make_keys(np.int32, n=N, seed=5, distinct=20)
    idx = np.arange(N, dtype=np.uint32)
    (gk, gv), (wk, wv) = _run(engine, keys, idx)
    _eq(gk, np.asarray(wk))
    _eq(gv, np.asarray(wv))
    # stable within each segment: the oracle is numpy's stable argsort
    seg = np.searchsorted(OFFSETS[1:-1], np.arange(N), side="right")
    order = np.lexsort((keys, seg))
    _eq(gv, idx[order])


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("begin,end,bound", [(0, 12, None), (4, 20, 16)])
def test_bit_ranges_and_segment_bound(engine, begin, end, bound):
    keys = make_keys(np.uint32, n=N, seed=7)
    vals = (make_keys(np.float32, n=N, seed=9), np.arange(N, dtype=np.int64))
    (gk, gv), (wk, wv) = _run(engine, keys, vals, begin_bit=begin,
                              end_bit=end, num_segments_bound=bound)
    _eq(gk, np.asarray(wk))
    for g, w in zip(gv, wv):
        _eq(g, np.asarray(w))


def test_empty_input():
    e = from_numpy(np.array([], dtype=np.uint32), device="cpu")
    off = from_numpy(np.array([0, 0], dtype=np.int32), device="cpu")
    assert rt.segmented_sort(e, off).numel() == 0
    k, v = rt.segmented_sort(e, off, [e], config=rt.SortConfig(
        engine="bitonic"))
    assert k.numel() == 0 and isinstance(v, list) and v[0].numel() == 0
