"""The port's config and twiddle names against the JAX package's:
``resolve(config, **overrides)``, ``best_engine``, ``default_backend`` and
``twiddle.is_supported``."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu as rs
import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu import config as jconfig
from cuda.radixsort_tpu import twiddle as jtwiddle
from cuda.radixsort_tpu_torch import config as tconfig
from cuda.radixsort_tpu_torch import twiddle as ttwiddle
from cuda.radixsort_tpu_torch.utils.convert import config_from_jax

# overrides either package takes; radix_bits 3 and 5 clamp to the port's
# stage widths on every engine but the reference
OVERRIDES = [{}, {"radix_bits": 4}, {"radix_bits": 2}, {"radix_bits": 3},
             {"engine": "bitonic"}, {"engine": "reference"},
             {"engine": "reference", "radix_bits": 5},
             {"engine": "auto", "radix_bits": 8}, {"engine": "xla"},
             {"engine": "pallas", "radix_bits": 4}]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=str)
def test_resolve_overrides_match_jax(overrides):
    jres = jconfig.resolve(**overrides)
    port_overrides = dict(overrides)
    if "engine" in port_overrides:
        port_overrides["engine"] = config_from_jax(jres).engine
    if port_overrides.get("engine") == "auto":
        del port_overrides["engine"]
    if "radix_bits" in port_overrides:
        port_overrides["radix_bits"] = config_from_jax(jres).radix_bits
    got = rt.resolve(**port_overrides)
    assert got == tconfig.resolve(config_from_jax(jres))
    assert got.engine != "auto"


def test_resolve_applies_overrides_to_a_config():
    base = rt.SortConfig(radix_bits=4, engine="bitonic")
    assert rt.resolve(base) is base
    assert rt.resolve(base, radix_bits=2) == base.replace(radix_bits=2)
    assert rt.resolve(base, engine="auto").engine == "radix"
    assert rt.resolve(rt.SortConfig(engine="auto"), radix_bits=8).engine == \
        "radix"
    with pytest.raises(TypeError):
        rt.resolve(base, tile_rows=8)  # the TPU geometry is not a field
    with pytest.raises(ValueError, match="radix_bits"):
        rt.resolve(radix_bits=3)


def test_best_engine_and_default_backend():
    assert rt.best_engine() == "radix"
    assert rt.best_engine("cuda") == rt.best_engine("cpu") == "radix"
    assert rt.best_engine is tconfig.best_engine
    want = "cuda" if torch.cuda.is_available() else "cpu"
    assert tconfig.default_backend() == want
    # JAX's counterparts on this machine
    assert jconfig.default_backend() == "cpu"
    assert rs.best_engine() == "xla"


_TORCH_OF = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.uint16,
             np.dtype(np.uint32): torch.uint32,
             np.dtype(np.uint64): torch.uint64, np.dtype(np.int8): torch.int8,
             np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
             np.dtype(np.int64): torch.int64,
             np.dtype(np.float16): torch.float16,
             np.dtype(ml_dtypes.bfloat16): torch.bfloat16,
             np.dtype(np.float32): torch.float32,
             np.dtype(np.float64): torch.float64,
             np.dtype(np.bool_): torch.bool,
             np.dtype(np.complex64): torch.complex64,
             np.dtype(np.complex128): torch.complex128}


@pytest.mark.parametrize("np_dtype", list(_TORCH_OF), ids=str)
def test_is_supported_matches_jax(np_dtype):
    assert ttwiddle.is_supported(_TORCH_OF[np_dtype]) == \
        jtwiddle.is_supported(jnp.dtype(np_dtype))


def test_is_supported_over_every_torch_dtype():
    dtypes = {getattr(torch, n) for n in dir(torch)
              if isinstance(getattr(torch, n), torch.dtype)}
    supported = {d for d in dtypes if ttwiddle.is_supported(d)}
    assert len(supported) == 12
    for d in supported:  # each one round-trips through the twiddle
        x = torch.zeros(4, dtype=d)
        assert torch.equal(ttwiddle.signed_view(ttwiddle.twiddle_out(
            ttwiddle.twiddle_in(x), d)), ttwiddle.signed_view(x))
