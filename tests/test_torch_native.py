"""The port's binding of the host runtime (csrc/hostutils.cpp) against the
JAX package's binding of the same source.

Both modules build the same C++ file with g++ (the port under
build/radixsort_tpu_torch/, the JAX package under csrc/build/), so every
entry point must give the same bits on the same input. The native k-way
merge is also held against its plain version (a numpy stable argsort of the
concatenated runs), ties and payloads included. All comparisons are exact.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from cuda.radixsort_tpu.utils import native as jnative
from cuda.radixsort_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000, 100_003])
@pytest.mark.parametrize("seed", [0, 7])
def test_random_u32_same_bits(n, seed):
    np.testing.assert_array_equal(native.random_u32(n, seed=seed),
                                  jnative.random_u32(n, seed=seed))


@pytest.mark.parametrize("hot_fraction", [0.0, 0.5, 0.9])
def test_skewed_u32_same_bits(hot_fraction):
    got = native.skewed_u32(50_001, seed=3, hot_key=99,
                            hot_fraction=hot_fraction)
    want = jnative.skewed_u32(50_001, seed=3, hot_key=99,
                              hot_fraction=hot_fraction)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 4097])
def test_u32_oracles(n):
    keys = native.random_u32(n, seed=n) % 1000  # ties show stability
    vals = np.arange(n, dtype=np.int32)
    np.testing.assert_array_equal(native.lsd_sort_u32(keys),
                                  jnative.lsd_sort_u32(keys))
    gk, gv = native.lsd_sort_pairs_u32(keys, vals)
    wk, wv = jnative.lsd_sort_pairs_u32(keys, vals)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)
    assert gv.dtype == wv.dtype == np.int32
    srt = np.sort(keys)
    assert native.verify_sorted_u32(srt) == jnative.verify_sorted_u32(srt)
    assert native.verify_sorted_u32(keys) == jnative.verify_sorted_u32(keys)
    assert native.compare_u32(keys, srt) == jnative.compare_u32(keys, srt)
    for shift in (0, 4, 28):
        np.testing.assert_array_equal(native.histogram16(keys, shift),
                                      jnative.histogram16(keys, shift))


@pytest.mark.parametrize("n", [0, 1, 3, 4097])
def test_u64_oracles(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**64, size=n, dtype=np.uint64) % np.uint64(2**40)
    vals = np.arange(n, dtype=np.uint32)
    np.testing.assert_array_equal(native.lsd_sort_u64(keys),
                                  jnative.lsd_sort_u64(keys))
    gk, gv = native.lsd_sort_pairs_u64(keys, vals)
    wk, wv = jnative.lsd_sort_pairs_u64(keys, vals)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)
    srt = np.sort(keys)
    assert native.verify_sorted_u64(keys) == jnative.verify_sorted_u64(keys)
    assert native.verify_sorted_u64(srt) == -1
    assert native.compare_u64(keys, srt) == jnative.compare_u64(keys, srt)


def _runs(rng, lengths, hi):
    return [np.sort(rng.integers(0, hi, size=m, dtype=np.uint64)
                    .astype(np.uint32)) for m in lengths]


@pytest.mark.parametrize("lengths", [[], [0], [5], [0, 3, 0], [1, 1, 1],
                                     [1000, 17, 4096, 1], [70_000, 70_001]],
                         ids=lambda x: "-".join(map(str, x)) or "none")
@pytest.mark.parametrize("hi", [4, 2**32], ids=["ties", "full"])
def test_kway_merge_equals_plain(lengths, hi):
    rng = np.random.default_rng(len(lengths) + hi % 7)
    runs = _runs(rng, lengths, hi)
    pays = [rng.integers(0, 2**32, size=r.shape[0], dtype=np.uint64)
            .astype(np.uint32) for r in runs]
    np.testing.assert_array_equal(native.kway_merge_u32(runs),
                                  native.kway_merge_u32_plain(runs))
    gk, gv = native.kway_merge_u32(runs, pays)
    wk, wv = native.kway_merge_u32_plain(runs, pays)
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gv, wv)  # ties keep run order
    if runs:
        jk, jv = jnative.kway_merge_u32(runs, pays)
        np.testing.assert_array_equal(gk, jk)
        np.testing.assert_array_equal(gv, jv)


def test_kway_merge_writes_through_out():
    rng = np.random.default_rng(11)
    runs = _runs(rng, [300, 200, 1], 50)
    pays = [np.arange(r.shape[0], dtype=np.float32) for r in runs]
    out = np.empty(501, np.uint32)
    vout = np.empty(501, np.uint32)
    k, v = native.kway_merge_u32(runs, pays, out=out, vout=vout)
    assert k is out and v is vout
    wk, wv = native.kway_merge_u32_plain(runs, pays)
    np.testing.assert_array_equal(out, wk)
    np.testing.assert_array_equal(vout, wv)


@pytest.mark.parametrize("case", ["vruns_count", "vrun_length", "out_dtype",
                                  "vout_length"])
def test_kway_merge_rejects_bad_arguments(case):
    runs = [np.arange(4, dtype=np.uint32), np.arange(3, dtype=np.uint32)]
    kw = {"vruns_count": dict(vruns=[np.zeros(4, np.uint32)]),
          "vrun_length": dict(vruns=[np.zeros(4, np.uint32),
                                     np.zeros(2, np.uint32)]),
          "out_dtype": dict(out=np.empty(7, np.int64)),
          "vout_length": dict(vruns=[np.zeros(4, np.uint32),
                                     np.zeros(3, np.uint32)],
                              vout=np.empty(6, np.uint32))}[case]
    for fn in (native.kway_merge_u32, native.kway_merge_u32_plain):
        with pytest.raises(ValueError):
            fn(runs, **kw)


def test_compare_rejects_unequal_lengths():
    with pytest.raises(ValueError):
        native.compare_u32(np.zeros(3, np.uint32), np.zeros(4, np.uint32))


def test_builds_into_the_ports_directory():
    so = native.library_path()
    assert native.lib() is not None and os.path.exists(so)
    assert os.path.dirname(so) == os.path.join(REPO, "build",
                                               "radixsort_tpu_torch")


def test_failed_build_raises(tmp_path):
    """No fallback: a g++ that fails makes lib() raise RuntimeError, in a
    fresh process whose PATH holds only a failing g++."""
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'g++: broken' >&2\nexit 1\n")
    fake.chmod(0o755)
    code = ("import cuda.radixsort_tpu_torch.utils.native as n, tempfile; "
            "n.BUILD_DIR = tempfile.mkdtemp(); "
            "n.random_u32(4)")
    env = dict(os.environ, PATH=str(tmp_path), PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "RuntimeError: g++ failed" in proc.stderr
    assert "g++: broken" in proc.stderr
