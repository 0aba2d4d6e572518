"""The port's distributed selection (parallel/dselect.py) against the JAX
package's.

One gloo world of 4 CPU ranks (tests/torch_world.py, a 120 s limit) runs every
case once; each test runs the JAX function on a 4-device sub-mesh of the
suite's 8 CPU devices with the same seeded numpy input. Keys, indices,
counts and group counts match bit for bit on every rank; the quantile
columns (f32 linear interpolation) to within 1 ulp of f32 (rtol 2^-23):
the same two f32 products and one sum, which a fused multiply-add may
round once instead of twice.
"""

import numpy as np
import pytest

from cuda.radixsort_tpu_torch.parallel import dsort as tdsort
from cuda.radixsort_tpu_torch.parallel import dselect as tdselect
import torch_world as W
from cuda.radixsort_tpu_torch.utils.convert import (blocks, from_numpy,
                                                    to_numpy)

NDEV = 4
U32 = np.uint32
QTOL = 2.0 ** -23


def _rng(seed):
    return np.random.default_rng(seed)


def _u32(n, seed, hi):
    return _rng(seed).integers(0, hi, size=n, dtype=np.uint64).astype(U32)


def _floats_zeros():
    x = _rng(3).normal(size=5003).astype(np.float32)
    x[::97] = -0.0
    return x


# id -> (keys, k, largest)
KTH = {
    "u32-k0": (lambda: _u32(NDEV * 1024, 1, 5000), 0, False),
    "u32-k777": (lambda: _u32(NDEV * 1024 + 13, 2, 5000), 777, False),
    "u32-k4095": (lambda: _u32(4096, 3, 5000), 4095, False),
    "i32-largest": (lambda: _rng(4).integers(-(2**31), 2**31, size=6000)
                    .astype(np.int32), 5, True),
    "f32": (_floats_zeros, 2501, False),
}

# id -> (keys, k, largest)
TOPK = {
    "u32-100": (lambda: _u32(NDEV * 1024, 5, 2**32), 100, True),
    "u32-ragged-17": (lambda: _u32(NDEV * 1000 + 3, 6, 2**32), 17, True),
    "ties": (lambda: _u32(4096, 7, 4), 50, True),
    "smallest": (lambda: _u32(5555, 8, 2**32), 33, False),
    "k-exceeds-shard": (lambda: _u32(800, 9, 1000), 300, True),
    "signed-ties": (lambda: _rng(10).integers(-3, 3, size=3001)
                    .astype(np.int32), 40, False),
}

# id -> keys
DISTINCT = {
    "u32": lambda: _u32(NDEV * 512, 11, 37),
    "u32-ragged": lambda: _u32(NDEV * 512 + 5, 12, 37),
    "one-value": lambda: np.full(4096, 42, U32),
    "signed": lambda: _rng(13).integers(-50, 50, size=3000).astype(np.int32),
}


def _quant_u32(n, ng, seed):
    return (_u32(n, seed, ng) * 3 + 1, _u32(n, seed + 1, 100000))


# id -> ((keys, values), qs, max_groups)
QUANTILES = {
    "ng7": (lambda: _quant_u32(NDEV * 1024, 7, 20), (0.0, 0.5, 1.0), 16),
    "ng1": (lambda: _quant_u32(6007, 1, 22), (0.0, 0.5, 1.0), 16),
    "ng13": (lambda: _quant_u32(4096, 13, 24), (0.0, 0.5, 1.0), 16),
    "f32-signed": (lambda: (_rng(26).integers(-4, 4, size=5000)
                            .astype(np.int32),
                            _rng(27).normal(size=5000).astype(np.float32)),
                   (0.25, 0.75), 8),
    "extreme-key": (lambda: (np.where(_rng(28).random(4096) < 0.3,
                                      U32(0xFFFFFFFF), U32(5)).astype(U32),
                             _u32(4096, 29, 100)), (0.5,), 4),
    "overflow-groups": (lambda: (_u32(6000, 30, 12) * 7 + 2,
                                 _u32(6000, 31, 100000)), (0.5,), 8),
}

# id -> (keys, cap)
COUNT_CAPPED = {
    "few": (lambda: _u32(NDEV * 300 + 1, 40, 20), 64),
    "many": (lambda: _u32(NDEV * 300, 41, 1000), 64),
    "at-cap": (lambda: np.arange(NDEV * 16, dtype=U32) % 16, 16),
}


# ---------------------------------------------------------------------------
# the ranks' side
# ---------------------------------------------------------------------------


def _ranks(rank, world):
    mesh = tdsort.make_mesh(world, device="cpu")

    def shard(x):
        return from_numpy(W.shard_of(x, rank, world), "cpu")

    out = {}
    for key, (make, k, largest) in KTH.items():
        x = make()
        out["kth", key] = to_numpy(tdselect.kth_value_distributed(
            shard(x), k, mesh=mesh, largest=largest, n=len(x)))
    for key, (make, k, largest) in TOPK.items():
        x = make()
        v, i = tdselect.top_k_distributed(shard(x), k, mesh=mesh,
                                          largest=largest, n=len(x))
        out["topk", key] = (to_numpy(v), to_numpy(i))
    for key, make in DISTINCT.items():
        x = make()
        u, c = tdselect.distinct_distributed(shard(x), mesh=mesh, n=len(x))
        out["distinct", key] = (to_numpy(u), to_numpy(c))
    for key, (make, qs, g) in QUANTILES.items():
        k, v = make()
        gk, qc, cnt = tdselect.groupby_quantile_distributed(
            shard(k), shard(v), qs, mesh=mesh, max_groups=g, n=len(k))
        out["quantiles", key] = (to_numpy(gk), [to_numpy(c) for c in qc],
                                 to_numpy(cnt))
    for key, (make, cap) in COUNT_CAPPED.items():
        x = make()
        out["count", key] = to_numpy(tdselect.distinct_count_capped(
            shard(x), cap=cap, mesh=mesh, n=len(x)))
    return out


@pytest.fixture(scope="module")
def ranks():
    return W.run_world(f"{__file__}:_ranks", NDEV, timeout=120)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jmesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:NDEV]), ("x",))


def _jdselect():
    from cuda.radixsort_tpu.parallel import dselect

    return dselect


@pytest.mark.parametrize("key", list(KTH))
def test_kth_value_distributed_matches_jax(ranks, jmesh, key):
    import jax.numpy as jnp

    make, k, largest = KTH[key]
    x = make()
    want = np.asarray(_jdselect().kth_value_distributed(
        jnp.asarray(x), k, mesh=jmesh, largest=largest))
    for r in range(NDEV):
        got = ranks[r]["kth", key]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.reshape(1).view(np.uint8),
                                      want.reshape(1).view(np.uint8))
    s = np.sort(x)
    assert got == (s[::-1] if largest else s)[k]


@pytest.mark.parametrize("key", list(TOPK))
def test_top_k_distributed_matches_jax(ranks, jmesh, key):
    import jax.numpy as jnp

    make, k, largest = TOPK[key]
    x = make()
    wv, wi = _jdselect().top_k_distributed(jnp.asarray(x), k, mesh=jmesh,
                                           largest=largest)
    for r in range(NDEV):
        gv, gi = ranks[r]["topk", key]
        np.testing.assert_array_equal(gv, np.asarray(wv))
        np.testing.assert_array_equal(gi, np.asarray(wi))
        assert gi.dtype == np.int32
    np.testing.assert_array_equal(x[gi], gv)


def test_top_k_distributed_ties_match_single_gpu(ranks):
    from cuda.radixsort_tpu_torch.ops.select import top_k

    x = TOPK["ties"][0]()
    lv, li = top_k(from_numpy(x, "cpu"), 50, largest=True)
    gv, gi = ranks[0]["topk", "ties"]
    np.testing.assert_array_equal(gv, to_numpy(lv))
    np.testing.assert_array_equal(gi, to_numpy(li))


@pytest.mark.parametrize("key", list(DISTINCT))
def test_distinct_distributed_matches_jax(ranks, jmesh, key):
    import jax.numpy as jnp

    x = DISTINCT[key]()
    wu, wc = _jdselect().distinct_distributed(jnp.asarray(x), mesh=jmesh)
    wb, wc = blocks(wu, NDEV), np.asarray(wc)
    got = []
    for r in range(NDEV):
        gu, gc = ranks[r]["distinct", key]
        np.testing.assert_array_equal(gc, wc)
        assert gu.shape == wb[r].shape
        np.testing.assert_array_equal(gu[:gc[r]], wb[r][:wc[r]])
        got.append(gu[:gc[r]])
    np.testing.assert_array_equal(np.concatenate(got), np.unique(x))


@pytest.mark.parametrize("key", list(QUANTILES))
def test_groupby_quantile_distributed_matches_jax(ranks, jmesh, key):
    import jax.numpy as jnp

    make, qs, g = QUANTILES[key]
    k, v = make()
    wk, wq, wn = _jdselect().groupby_quantile_distributed(
        jnp.asarray(k), jnp.asarray(v), qs=qs, mesh=jmesh, max_groups=g)
    for r in range(NDEV):
        gk, gq, gn = ranks[r]["quantiles", key]
        np.testing.assert_array_equal(gn, np.asarray(wn))
        np.testing.assert_array_equal(gk, np.asarray(wk))
        for a, b in zip(gq, wq):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_allclose(a, np.asarray(b), rtol=QTOL, atol=0)
    if key == "overflow-groups":
        assert int(gn) > g  # truncation is reported


@pytest.mark.parametrize("key", list(COUNT_CAPPED))
def test_distinct_count_capped_matches_jax(ranks, jmesh, key):
    import jax.numpy as jnp

    make, cap = COUNT_CAPPED[key]
    x = make()
    want = np.asarray(_jdselect().distinct_count_capped(
        jnp.asarray(x), cap=cap, mesh=jmesh))
    for r in range(NDEV):
        np.testing.assert_array_equal(ranks[r]["count", key], want)
    u = len(np.unique(x))
    assert int(want) == (u if u <= cap else cap + 1)
