"""The port's measurement module (utils/profiling.py) on the CPU.

What a CPU run can check: the roofline arithmetic with a stated rate, the
network's bytes model against the schedule the kernels run
(kernels/bitonic.py::plan_passes), that a trace holds the operators'
ranges, and that every timer refuses to run without a card (no host-clock
fallback). The timers' numbers come only from a card (chip_smoke.py).
"""

import json
import os

import numpy as np
import pytest
import torch

import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch.kernels import bitonic
from cuda.radixsort_tpu_torch.utils import profiling


def test_speed_of_light_with_a_rate():
    r = profiling.speed_of_light(3.35e12, 1.0, hbm_bytes_per_s=3.35e12)
    assert abs(r["fraction_of_sol"] - 1.0) < 1e-12
    r = profiling.speed_of_light(8 * 2**24, 1e-4, hbm_bytes_per_s=2e12)
    assert r["achieved_bytes_per_s"] == pytest.approx(8 * 2**24 / 1e-4)
    assert r["hbm_bytes_per_s"] == 2e12
    assert r["fraction_of_sol"] == pytest.approx(8 * 2**24 / 1e-4 / 2e12)
    assert set(r) == {"achieved_bytes_per_s", "hbm_bytes_per_s",
                      "fraction_of_sol"}


def test_speed_of_light_has_no_default_rate():
    assert profiling.HBM_BYTES_PER_S == {"NVIDIA H100 80GB HBM3": 3.35e12}
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        profiling.speed_of_light(1e9, 1.0)


@pytest.mark.parametrize("n_planes", [1, 2, 3, 4])
def test_bitonic_passes_follow_the_kernels_schedule(n_planes):
    for logn in (1, 5, 10, 13, 14, 15, 20, 24, 28):
        ops = bitonic.plan_passes(logn, 1, n_planes)
        assert profiling.bitonic_passes(logn, n_planes) == len(ops)
    # one tile pass up to the tile; then a tile pass and
    # ceil((k - log_t) / c) cross passes per level k
    lt, c = bitonic.tile_log_rows(n_planes), bitonic.cross_strides(n_planes)
    want = 1 + sum(1 + -(-(k - lt) // c) for k in range(lt + 1, 25))
    assert profiling.bitonic_passes(24, n_planes) == want


def test_bitonic_sort_bytes():
    assert profiling.bitonic_passes(24, 1) == 25  # 11 tile + 14 cross
    assert profiling.bitonic_sort_bytes(1 << 24) == 25 * 8 * (1 << 24)
    # padded to a power of two, and to at least 2^10 rows
    assert (profiling.bitonic_sort_bytes(3 << 22, 3)
            == profiling.bitonic_passes(24, 3) * 8 * 3 * (1 << 24))
    assert (profiling.bitonic_sort_bytes(5, 2)
            == profiling.bitonic_passes(10, 2) * 8 * 2 * 1024)


def _names(path):
    with open(os.path.join(path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name") for e in events]


def test_trace_holds_the_operators_ranges(tmp_path):
    keys = torch.from_numpy(np.random.default_rng(0).integers(
        0, 2**31, 5000).astype(np.int32))
    with profiling.trace(str(tmp_path / "t")) as log_dir:
        rt.sort(keys)
        rt.sort_pairs(keys, keys)
        q = rt.Query(rt.Table({"k": keys})).where(lambda t: t["k"] > 7)
        q.run()
    assert log_dir == str(tmp_path / "t")
    names = _names(log_dir)
    for name in ("sort", "sort_pairs", "Query.run", "_exec_where",
                 "filter_columns"):
        assert name in names, name


def test_traced_keeps_signature_and_docstring():
    import inspect

    assert rt.sort_pairs.__doc__.startswith("Key-value sort.")
    params = inspect.signature(rt.sort_pairs).parameters
    assert list(params)[:2] == ["keys", "values"]
    assert params["stable"].default is True
    assert rt.Query.run.__qualname__ == "Query.run"


def test_timers_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x = torch.arange(8)
    for call in (lambda: profiling.timed_calls(lambda a: a * 2, (x,), m=2),
                 lambda: profiling.timed_chain(lambda a: a + 1, x, k=2),
                 lambda: profiling.cuda_time_ms(lambda: x * 2),
                 lambda: profiling.device_time_ms(lambda: x * 2)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
