"""The scans' ``engine=`` keyword (ops/scan.py) against the JAX package's
on the same numpy inputs.

'auto' runs the port's routes as they are; 'pallas' the segmented-scan
kernel (its plain version on these CPU tensors) against JAX's Pallas kernel
in interpret mode; 'xla' the routes that are not the kernel against JAX's
cumsum and doubling. Tolerance: sums over integers and every min/max bit
for bit; a float32 sum within 1e-5 of the running sum of |x| over its
segment (tests/test_torch_scan.py's bound).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu as rs
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu.ops import scan as jscan
from cuda.radixsort_tpu_torch.kernels import scan as kscan
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

N = 2500
F32_TOL = 1e-5
ENGINES = ("auto", "pallas", "xla")
KERNEL_OPS = [(op, dt) for op in ("sum", "min", "max")
              for dt in (np.int32, np.uint32, np.float32)]


def _inputs(dtype, seed):
    rng = np.random.default_rng(seed)
    keys = np.repeat(rng.integers(0, 40, size=N // 5), 5)[:N]
    keys = np.sort(rng.integers(0, 300, size=N)).astype(np.int32) ^ keys
    if dtype == np.float32:
        vals = (rng.standard_normal(N) * 100).astype(np.float32)
    elif dtype == np.uint32:
        vals = rng.integers(0, 2**32, size=N, dtype=np.uint64).astype(dtype)
    else:
        vals = rng.integers(-2**31, 2**31, size=N, dtype=np.int64).astype(dtype)
    return keys.astype(np.int32), vals


def _heads(keys):
    return np.concatenate([[True], keys[1:] != keys[:-1]])


def _assert_scan(got, want, vals, heads, op):
    got, want = to_numpy(got), np.asarray(want)
    assert got.dtype == want.dtype
    if got.dtype == np.float32 and op == "sum":
        acc, bound = 0.0, np.empty(len(vals))
        for i, (x, h) in enumerate(zip(np.abs(vals.astype(np.float64)),
                                       heads)):
            acc = x if h else acc + x
            bound[i] = acc
        np.testing.assert_array_less(
            np.abs(got.astype(np.float64) - want), F32_TOL * bound + 1e-30)
    else:
        np.testing.assert_array_equal(got, want)


@functools.cache
def _jax_scan_by_key(jax_engine, op, dtype_name, seed):
    """JAX's scan_by_key under the engine its "auto" resolves to here
    (``_pick_engine``: "xla" on the CPU), so "auto" and "xla" share one
    compile; returns (keys, values, result) as numpy arrays."""
    keys, vals = _inputs(np.dtype(dtype_name).type, seed)
    out = rs.scan_by_key(jnp.asarray(keys), jnp.asarray(vals), op,
                         engine=jax_engine)
    return keys, vals, np.asarray(out)


class _KernelSpy:
    """Counts the calls of the scan kernel's wrapper."""

    def __enter__(self):
        self.calls, self._fn = 0, kscan.segmented_scan

        def spy(*a, **k):
            self.calls += 1
            return self._fn(*a, **k)

        kscan.segmented_scan = spy
        return self

    def __exit__(self, *exc):
        kscan.segmented_scan = self._fn


@pytest.mark.parametrize("op,dtype", KERNEL_OPS,
                         ids=[f"{o}-{np.dtype(d).name}" for o, d in KERNEL_OPS])
@pytest.mark.parametrize("engine", ENGINES)
def test_scan_by_key_engine_matches_jax(engine, op, dtype):
    jax_engine = jscan._pick_engine(engine, op, jnp.dtype(dtype), N)
    keys, vals, want = _jax_scan_by_key(jax_engine, op, np.dtype(dtype).name,
                                        len(op) + np.dtype(dtype).num)
    with _KernelSpy() as spy:
        got = rt.scan_by_key(from_numpy(keys, device="cpu"),
                             from_numpy(vals, device="cpu"), op,
                             engine=engine)
    assert spy.calls == (0 if engine == "xla" else 1)
    _assert_scan(got, want, vals, _heads(keys), op)


@pytest.mark.parametrize("engine", ENGINES)
def test_segmented_scan_engine_exclusive_init(engine):
    keys, vals = _inputs(np.int32, seed=5)
    heads = _heads(keys)
    kw = dict(exclusive=True, init=7, engine=engine)
    want = jax.jit(functools.partial(jscan.segmented_scan, op="max", **kw))(
        jnp.asarray(vals), jnp.asarray(heads))
    got = rt.segmented_scan(from_numpy(vals, device="cpu"),
                            torch.from_numpy(heads), "max", **kw)
    _assert_scan(got, want, vals, heads, "max")


@pytest.mark.parametrize("engine", ["auto", "xla"])
@pytest.mark.parametrize("case", ["prod", "int64-sum", "int16-max",
                                  "callable"])
def test_engines_outside_the_kernel_match_jax(engine, case):
    keys, vals = _inputs(np.int32, seed=9)
    op, kw = {"prod": ("prod", {}), "int64-sum": ("sum", {}),
              "int16-max": ("max", {}),
              "callable": ("callable", {"identity": 0})}[case]
    if case == "prod":
        vals = (vals % 3).astype(np.int32)
    elif case == "int64-sum":
        vals = vals.astype(np.int64) << 20
    elif case == "int16-max":
        vals = vals.astype(np.int16)
    jop = jnp.bitwise_or if op == "callable" else op
    top = torch.bitwise_or if op == "callable" else op
    want = rs.scan_by_key(jnp.asarray(keys), jnp.asarray(vals), jop,
                          engine=engine, **kw)
    with _KernelSpy() as spy:
        got = rt.scan_by_key(from_numpy(keys, device="cpu"),
                             from_numpy(vals, device="cpu"), top,
                             engine=engine, **kw)
    assert spy.calls == 0
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_pallas_engine_refuses_what_the_kernel_does_not_cover():
    keys, vals = _inputs(np.int32, seed=3)
    jk, jv = jnp.asarray(keys), jnp.asarray(vals)
    tk, tv = from_numpy(keys, device="cpu"), from_numpy(vals, device="cpu")
    for op in ("prod", jnp.bitwise_or):
        with pytest.raises(ValueError, match="op must be one of") as jerr:
            rs.scan_by_key(jk, jv, op, identity=0, engine="pallas")
        top = op if isinstance(op, str) else torch.bitwise_or
        with pytest.raises(ValueError, match="op must be one of") as terr:
            rt.scan_by_key(tk, tv, top, identity=0, engine="pallas")
        assert str(terr.value) == str(jerr.value)
    # the kernel's dtypes are int32, uint32 and float32
    with pytest.raises(TypeError, match="values must be one of"):
        rt.scan_by_key(tk, tv.to(torch.int64), "sum", engine="pallas")
    with pytest.raises(ValueError, match="engine must be one of"):
        rt.segmented_scan(tv, torch.zeros(N, dtype=torch.bool), "sum",
                          engine="cub")
