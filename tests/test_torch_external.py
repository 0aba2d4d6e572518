"""The port's external (out-of-core) sorts and join against the JAX package.

The same numpy inputs go through ``cuda.radixsort_tpu.ops.external`` and
``cuda.radixsort_tpu_torch.ops.external`` (its device side on the CPU here,
through the kernels' plain versions), with ``chunk`` well below n so that
several runs are sorted and merged on the host, and with n <= chunk (one
run, no merge). Sorts, payloads, counts and checksums must match bit for
bit, and the stable pair sort must equal numpy's stable argsort.
"""

import os

import numpy as np
import pytest

from cuda.radixsort_tpu.ops import external as jext
from cuda.radixsort_tpu_torch.ops import external as text

CPU = dict(device="cpu")


def _keys(n, seed, hi=2**32):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, size=n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n, chunk", [(0, 8), (1, 8), (2, 8), (3, 8),
                                      (1000, 1000), (4097, 700), (777, 1)])
def test_sort_external(n, chunk):
    keys = _keys(n, n)
    got = text.sort_external(keys, chunk=chunk, **CPU)
    assert got.dtype == np.uint32 and got.shape == (n,)
    np.testing.assert_array_equal(got, np.sort(keys))
    if n > 0:
        np.testing.assert_array_equal(got, jext.sort_external(keys,
                                                              chunk=chunk))


@pytest.mark.parametrize("n, chunk", [(0, 8), (1, 8), (3, 8), (1000, 4096),
                                      (4096, 600)])
@pytest.mark.parametrize("vdtype", [np.int32, np.float32])
def test_sort_external_pairs_stable(n, chunk, vdtype):
    keys = _keys(n, n + 1, hi=50)  # heavy ties: stability shows
    vals = np.arange(n).astype(vdtype)
    gk, gv = text.sort_external_pairs(keys, vals, chunk=chunk, **CPU)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gv, vals[order])
    assert gv.dtype == vdtype
    if n > 0:
        wk, wv = jext.sort_external_pairs(keys, vals, chunk=chunk)
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gv, wv)


def test_timings_split_the_parts():
    keys = _keys(3000, 5)
    t = {}
    text.sort_external(keys, chunk=1000, timings=t, **CPU)
    assert set(t) == {"h2d", "device", "d2h", "merge"}
    assert all(v >= 0 for v in t.values()) and t["merge"] > 0


@pytest.mark.parametrize("n, chunk", [(0, 16), (5, 16), (3001, 16),
                                      (3001, 1000)])
def test_sort_external_file(tmp_path, n, chunk):
    keys = _keys(n, 9)
    src = tmp_path / "in.u32"
    keys.tofile(src)
    runs = tmp_path / "runs"
    runs.mkdir()
    out = tmp_path / "out.u32"
    assert text.sort_external_file(str(src), str(out), chunk=chunk,
                                   tmpdir=str(runs), **CPU) == n
    got = np.fromfile(out, dtype=np.uint32)
    np.testing.assert_array_equal(got, np.sort(keys))
    assert os.listdir(runs) == []  # run files and their directory removed
    if n > 0:
        jout = tmp_path / "jout.u32"
        jext.sort_external_file(str(src), str(jout), chunk=chunk)
        np.testing.assert_array_equal(got, np.fromfile(jout, np.uint32))


@pytest.mark.parametrize("n, chunk", [(0, 16), (7, 16), (2500, 600)])
def test_sort_external_pairs_file(tmp_path, n, chunk):
    keys = _keys(n, 12, hi=20)
    vals = np.arange(n, dtype=np.uint32)
    paths = [str(tmp_path / f) for f in ("k", "v", "ok", "ov")]
    keys.tofile(paths[0])
    vals.tofile(paths[1])
    runs = tmp_path / "runs"
    runs.mkdir()
    assert text.sort_external_pairs_file(*paths, chunk=chunk,
                                         tmpdir=str(runs), **CPU) == n
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.fromfile(paths[2], np.uint32),
                                  keys[order])
    np.testing.assert_array_equal(np.fromfile(paths[3], np.uint32),
                                  vals[order])
    assert os.listdir(runs) == []
    if n > 0:
        jpaths = paths[:2] + [str(tmp_path / "jk"), str(tmp_path / "jv")]
        jext.sort_external_pairs_file(*jpaths, chunk=chunk)
        for mine, theirs in zip(paths[2:], jpaths[2:]):
            np.testing.assert_array_equal(np.fromfile(mine, np.uint32),
                                          np.fromfile(theirs, np.uint32))


def test_file_run_files_removed_on_failure(tmp_path, monkeypatch):
    keys = _keys(100, 1)
    src = tmp_path / "in.u32"
    keys.tofile(src)
    runs = tmp_path / "runs"
    runs.mkdir()

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(text.native, "kway_merge_u32", broken)
    with pytest.raises(OSError, match="disk full"):
        text.sort_external_file(str(src), str(tmp_path / "o"), chunk=30,
                                tmpdir=str(runs), **CPU)
    assert os.listdir(runs) == []


def _join_inputs(nb, nprobe, seed):
    rng = np.random.default_rng(seed)
    bk = rng.permutation(np.arange(1, 3 * nb, 3, dtype=np.uint32))[:nb]
    bv = rng.integers(-2**31, 2**31, size=nb, dtype=np.int64).astype(np.int32)
    pk = rng.integers(0, 3 * nb, size=nprobe, dtype=np.uint32)
    return bk, bv, pk


@pytest.mark.parametrize("nb, nprobe, chunk", [(64, 4096, 1000),
                                               (200, 1500, 4096),
                                               (50, 0, 128), (1, 3, 2)])
def test_join_external_materialized(nb, nprobe, chunk):
    bk, bv, pk = _join_inputs(nb, nprobe, nb + nprobe)
    gk, gv, gi, gc = text.join_external(bk, bv, pk, chunk=chunk, **CPU)
    wk, wv, wi, wc = jext.join_external(bk, bv, pk, chunk=chunk)
    assert gc == wc == int(np.isin(pk, bk).sum())
    for g, w in ((gk, wk), (gv, wv), (gi, wi)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # every output row is a real match
    lookup = dict(zip(bk.tolist(), bv.tolist()))
    assert all(pk[i] == k and lookup[k] == v
               for k, v, i in zip(gk.tolist(), gv.tolist(), gi.tolist()))


@pytest.mark.parametrize("nb, nprobe, chunk", [(64, 4096, 1000),
                                               (200, 1500, 4096)])
def test_join_external_count_and_checksum(nb, nprobe, chunk):
    bk, bv, pk = _join_inputs(nb, nprobe, 3)
    got = text.join_external(bk, bv, pk, chunk=chunk, materialize=False,
                             **CPU)
    want = jext.join_external(bk, bv, pk, chunk=chunk, materialize=False)
    assert got[0] == want[0]
    assert np.uint32(got[1]) == np.uint32(want[1])


@pytest.mark.parametrize("case", ["keys_dtype", "pair_keys", "payload_size",
                                  "payload_length", "chunk", "join_keys"])
def test_rejects_bad_inputs(case):
    k = _keys(10, 0)
    with pytest.raises((TypeError, ValueError)):
        {"keys_dtype": lambda: text.sort_external(k.astype(np.int64), **CPU),
         "pair_keys": lambda: text.sort_external_pairs(
             k.view(np.int32), k, **CPU),
         "payload_size": lambda: text.sort_external_pairs(
             k, k.astype(np.int64), **CPU),
         "payload_length": lambda: text.sort_external_pairs(k, k[:5], **CPU),
         "chunk": lambda: text.sort_external(k, chunk=0, **CPU),
         "join_keys": lambda: text.join_external(
             k.astype(np.int32), k, k, **CPU)}[case]()


def test_file_size_must_be_u32_multiple(tmp_path):
    src = tmp_path / "bad"
    src.write_bytes(b"12345")
    with pytest.raises(ValueError, match="u32"):
        text.sort_external_file(str(src), str(tmp_path / "o"), **CPU)
