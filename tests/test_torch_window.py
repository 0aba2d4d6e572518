"""The port's window functions vs the JAX package's default CPU engine:
every output row (the tail past the count included) and the count.
Integer columns, ranks, shifts and min/max bit for bit; float running sums
within F32_TOL (the segmented scan may associate differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu as rs
from cuda.radixsort_tpu.ops.window import window_table as j_window_table
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.ops.window import window_table as t_window_table
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

N = 2500
F32_TOL = 1e-5
ALL_FNS = (("rn", None, "row_number"), ("rk", None, "rank"),
           ("dr", None, "dense_rank"), ("cs", "i", "cumsum"),
           ("cmin", "f", "cummin"), ("cmax", "u", "cummax"),
           ("lg", "f", "lag"), ("ld", "i", "lead"), ("cs64", "l", "cumsum"),
           ("csf", "f", "cumsum"), ("lg16", "h", "lag"))


def _raw(a):
    a = np.asarray(a)
    return a if a.dtype == np.bool_ else a.view(f"uint{a.dtype.itemsize * 8}")


def assert_same(got, want, exact=True):
    g, w = to_numpy(got), np.asarray(want)
    if w.ndim == 0:
        assert g.dtype == np.int32 and g.ndim == 0 and int(g) == int(w)
        return
    assert g.dtype == w.dtype and g.shape == w.shape
    if exact:
        np.testing.assert_array_equal(_raw(g), _raw(w))
    else:
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)


def _data(rng, n=N, part_dtype=np.int32, order_dtype=np.float32):
    part = rng.integers(0, 37, size=n).astype(part_dtype)
    order = rng.integers(-50, 50, size=n).astype(order_dtype)  # ties
    vals = {
        "i": rng.integers(-2**31, 2**31, size=n,
                          dtype=np.int64).astype(np.int32),
        "f": (rng.standard_normal(n) * 10).astype(np.float32),
        "u": rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32),
        "l": rng.integers(-2**40, 2**40, size=n, dtype=np.int64),
        "h": rng.standard_normal(n).astype(np.float16),
    }
    return part, order, vals


def _compare(got, want):
    for g, w in zip(got[:2], want[:2]):
        assert_same(g, w)
    assert set(got[2]) == set(want[2])
    for k in want[2]:
        assert_same(got[2][k], want[2][k])
    assert set(got[3]) == set(want[3])
    for name in want[3]:
        assert_same(got[3][name], want[3][name], exact=name != "csf")
    assert_same(got[4], want[4])


@pytest.mark.parametrize("descending", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("keys", [(np.int32, np.float32),
                                  (np.uint32, np.int64),
                                  (np.int64, np.uint16)],
                         ids=["i32-f32", "u32-i64", "i64-u16"])
def test_window_matches_jax(descending, masked, keys):
    rng = np.random.default_rng(descending + 2 * masked)
    part, order, vals = _data(rng, part_dtype=keys[0], order_dtype=keys[1])
    valid = rng.random(N) < 0.75 if masked else None
    # JAX always gets a mask (every row valid is the same window as none),
    # so one JAX program serves the masked and unmasked cases
    want = rs.window(jnp.asarray(part), jnp.asarray(order),
                     {k: jnp.asarray(v) for k, v in vals.items()}, ALL_FNS,
                     valid=jnp.asarray(np.ones(N, bool) if valid is None
                                       else valid),
                     descending=descending)
    got = rt.window(from_numpy(part, device="cpu"), from_numpy(order, device="cpu"),
                    {k: from_numpy(v, device="cpu") for k, v in vals.items()}, ALL_FNS,
                    valid=None if valid is None else from_numpy(valid, device="cpu"),
                    descending=descending)
    _compare(got, want)


@pytest.mark.parametrize("spec", [
    (("run", "o", "cumsum"), ("r", None, "rank")),
    (("pp", "p", "lag"), ("on", "o", "lead"), ("x", "v", "cummax"))],
    ids=["order-source", "partition-source"])
def test_window_table_sources_may_name_the_keys(spec):
    rng = np.random.default_rng(len(spec))
    cols = {"p": rng.integers(0, 9, size=N).astype(np.int32),
            "o": rng.integers(0, 300, size=N).astype(np.int32),
            "v": rng.integers(-99, 99, size=N).astype(np.int32)}
    valid = rng.random(N) < 0.9
    want, wc = j_window_table({k: jnp.asarray(v) for k, v in cols.items()},
                              "p", "o", spec, valid=jnp.asarray(valid))
    got, gc = t_window_table({k: from_numpy(v, device="cpu") for k, v in cols.items()},
                             "p", "o", spec, valid=from_numpy(valid, device="cpu"))
    assert set(got) == set(want)
    for k in want:
        assert_same(got[k], want[k])
    assert_same(gc, wc)
    with pytest.raises(ValueError, match="collides"):
        t_window_table({k: from_numpy(v, device="cpu") for k, v in cols.items()}, "p", "o",
                       (("v", None, "rank"),))


def test_window_errors_and_empty():
    e = torch.zeros(0, dtype=torch.int32)
    sp, so, sv, wc, cnt = rt.window(e, e, {"v": e}, (("r", None, "rank"),
                                                      ("c", "v", "cumsum")))
    assert int(cnt) == 0 and wc["r"].shape == (0,)
    assert wc["c"].dtype == torch.int32
    x = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        rt.window(x, x, {}, (("r", None, "median"),))
    with pytest.raises(ValueError):
        rt.window(x, x, {}, (("r", "v", "rank"),))
    with pytest.raises(ValueError):
        rt.window(x, x, {}, (("c", "v", "cumsum"),))
    with pytest.raises(ValueError, match="scan_engine"):
        rt.window(x, x, {}, (("r", None, "rank"),), scan_engine="cub")
    for engine in ("auto", "xla", "pallas"):
        rt.window(x, x, {}, (("r", None, "rank"),), scan_engine=engine)
