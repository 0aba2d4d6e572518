"""The port's distributed scan-by-key (parallel/dscan.py) against the JAX
package's.

One gloo world of 4 CPU ranks (tests/torch_world.py, a 120 s limit) runs every
case once; each test runs the JAX function on a 4-device sub-mesh (or a
2x2 mesh over the ("host", "chip") tuple axis) with the same seeded numpy
input. Rank d's block, or the whole gathered result where n does not
divide the mesh, equals the JAX result bit for bit (integers) or within
rtol 1e-5 (the f32 sums: the port's scan kernel and XLA add in another
order).
"""

import numpy as np
import pytest
import torch

from cuda.radixsort_tpu_torch.parallel import dscan as tdscan
from cuda.radixsort_tpu_torch.parallel import dsort as tdsort
import torch_world as W
from cuda.radixsort_tpu_torch.utils.convert import (blocks, from_numpy,
                                                    to_numpy)

NDEV = 4
U32 = np.uint32


def _rng(seed):
    return np.random.default_rng(seed)


def _spanning():
    n = NDEV * 256
    keys = np.zeros(n, U32)
    keys[:256] = 1
    keys[256:3 * 256 + 100] = 7  # one run over shards 1 and 2 into 3
    keys[3 * 256 + 100:] = 9
    return keys, _rng(2).integers(0, 5, size=n).astype(np.int32)


def _kv(n, nkeys, seed, lo=0, hi=7, dtype=np.int32):
    return (_rng(seed).integers(0, nkeys, size=n).astype(U32),
            _rng(seed + 1).integers(lo, hi, size=n).astype(dtype))


# id -> ((keys, values), keyword arguments; "maximum": a callable op)
SCANS = {
    "sum": (lambda: _kv(NDEV * 1024, 30, 1, -9, 9), {}),
    "span": (_spanning, {}),
    "span-exclusive": (_spanning, {"exclusive": True}),
    "one-run": (lambda: (np.full(NDEV * 128, 42, U32),
                         _rng(3).integers(0, 3, size=NDEV * 128)
                         .astype(np.int32)), {}),
    "aligned": (lambda: (np.repeat(np.arange(NDEV, dtype=U32), 64),
                         _rng(4).integers(0, 5, size=NDEV * 64)
                         .astype(np.int32)), {}),
    "aligned-exclusive": (lambda: (np.repeat(np.arange(NDEV, dtype=U32), 64),
                                   _rng(4).integers(0, 5, size=NDEV * 64)
                                   .astype(np.int32)), {"exclusive": True}),
    "min": (lambda: _kv(NDEV * 512, 12, 5, -100, 100), {"op": "min"}),
    "max": (lambda: _kv(NDEV * 512, 12, 6, -100, 100), {"op": "max"}),
    "prod": (lambda: _kv(NDEV * 512, 12, 7, 1, 3, np.int64), {"op": "prod"}),
    "exclusive-init": (lambda: _kv(NDEV * 300, 9, 8),
                       {"exclusive": True, "init": 11}),
    "ragged": (lambda: _kv(NDEV * 200 + 13, 6, 9), {}),
    "ragged-exclusive": (lambda: _kv(NDEV * 200 + 13, 6, 9),
                         {"exclusive": True}),
    "callable": (lambda: _kv(NDEV * 256, 10, 10, 0, 50),
                 {"op": "maximum", "identity": np.iinfo(np.int32).min}),
    "float": (lambda: (_rng(11).integers(0, 20, size=NDEV * 512).astype(U32),
                       _rng(12).random(NDEV * 512).astype(np.float32)), {}),
}
TUPLE_AXIS = (lambda: _kv(NDEV * 256, 10, 13, 0, 9))


def _port_kw(kw):
    kw = dict(kw)
    if kw.get("op") == "maximum":
        kw["op"] = torch.maximum
    return kw


def _ranks(rank, world):
    mesh = tdsort.make_mesh(world, device="cpu")
    mesh2 = tdsort.make_mesh_2d(2, world // 2, device="cpu")

    def shard(x):
        return from_numpy(W.shard_of(x, rank, world), "cpu")

    out = {}
    for key, (make, kw) in SCANS.items():
        k, v = make()
        out[key] = to_numpy(tdscan.scan_by_key_distributed(
            shard(k), shard(v), mesh=mesh, n=len(k), **_port_kw(kw)))
    k, v = TUPLE_AXIS()
    out["tuple-axis"] = to_numpy(tdscan.scan_by_key_distributed(
        shard(k), shard(v), mesh=mesh2, axis_name=("host", "chip"),
        n=len(k)))
    return out


@pytest.fixture(scope="module")
def ranks():
    return W.run_world(f"{__file__}:_ranks", NDEV, timeout=120)


def _check(ranks, key, want, n, float_tol=False):
    want = np.asarray(want)
    ragged = n % NDEV != 0
    wb = [want] * NDEV if ragged else blocks(want, NDEV)
    for r in range(NDEV):
        got = ranks[r][key]
        assert got.dtype == wb[r].dtype and got.shape == wb[r].shape
        if float_tol:
            np.testing.assert_allclose(got, wb[r], rtol=1e-5)
        else:
            np.testing.assert_array_equal(got, wb[r])


@pytest.mark.parametrize("key", list(SCANS))
def test_scan_by_key_distributed_matches_jax(ranks, key):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from cuda.radixsort_tpu.ops.scan import scan_by_key
    from cuda.radixsort_tpu.parallel.dscan import scan_by_key_distributed

    make, kw = SCANS[key]
    k, v = make()
    jkw = dict(kw)
    if jkw.get("op") == "maximum":
        jkw["op"] = jnp.maximum
    mesh = Mesh(np.array(jax.devices()[:NDEV]), ("x",))
    want = scan_by_key_distributed(jnp.asarray(k), jnp.asarray(v), mesh=mesh,
                                   **jkw)
    _check(ranks, key, want, len(k), float_tol=(key == "float"))
    # and the single-device scan over the whole array
    single = scan_by_key(jnp.asarray(k), jnp.asarray(v), jkw.get("op", "sum"),
                         exclusive=jkw.get("exclusive", False),
                         init=jkw.get("init"), identity=jkw.get("identity"))
    _check(ranks, key, single, len(k), float_tol=(key == "float"))


def test_scan_by_key_distributed_tuple_axis(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from cuda.radixsort_tpu.parallel.dscan import scan_by_key_distributed

    k, v = TUPLE_AXIS()
    m2 = Mesh(np.array(jax.devices()[:NDEV]).reshape(2, 2), ("host", "chip"))
    want = scan_by_key_distributed(jnp.asarray(k), jnp.asarray(v), mesh=m2,
                                   axis_name=("host", "chip"))
    _check(ranks, "tuple-axis", want, len(k))
    np.testing.assert_array_equal(
        np.concatenate([ranks[r]["one-run"] for r in range(NDEV)]),
        np.cumsum(SCANS["one-run"][0]()[1]))
