"""8-byte columns on the radix route, on the CPU (the kernels' plain
versions).

A 64-bit key or an 8-byte payload crosses the LSD loop in place: the sort
API hands ``kernels/pipeline.py::sort_limbs`` the two halves of the
caller's words (or of the twiddled bits) as stride-2 views, the first pass
reads them, the last pass writes the result's own 8-byte columns, and the
result is those columns. These tests hold the views to the caller's
storage, the results to the reference engine bit for bit, the kernels'
plain versions to the same answers on views as on contiguous planes, and
``ops/sort.py::STAGED_BYTES`` to the copies the route still makes.
"""

import importlib

import pytest
import torch

import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.config import SortConfig
from cuda.radixsort_tpu_torch.kernels import histogram as hist
from cuda.radixsort_tpu_torch.kernels import pipeline as kpipe
from cuda.radixsort_tpu_torch.kernels import stage

tsort = importlib.import_module("cuda.radixsort_tpu_torch.ops.sort")

N = 2500
REFERENCE = SortConfig(engine="reference")


def _words(n: int, dtype: torch.dtype, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    w = torch.randint(-2**31, 2**31, (n * dtype.itemsize // 4,),
                      dtype=torch.int64, generator=g).to(torch.int32)
    return w.view(dtype)


def _same(a: torch.Tensor, b: torch.Tensor) -> None:
    """Equal bits (NaN payloads included), dtype and shape."""
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(twiddle.signed_view(a), twiddle.signed_view(b))


def _spy(monkeypatch) -> list:
    """Record the limbs and payloads the sort API hands the LSD loop."""
    seen = []
    real = kpipe.sort_limbs

    def spy(limbs, limb_bits, payloads, cfg):
        seen.append((list(limbs), list(payloads)))
        return real(limbs, limb_bits, payloads, cfg)

    monkeypatch.setattr(kpipe, "sort_limbs", spy)
    return seen


@pytest.mark.parametrize("value_dtype", [torch.uint32, torch.int64,
                                         torch.float64, torch.uint64])
def test_the_loop_reads_the_callers_words(value_dtype, monkeypatch):
    keys = _words(N, torch.uint64, 1)
    values = _words(N, value_dtype, 2)
    seen = _spy(monkeypatch)
    out_keys, out_values = rt.sort_pairs(keys, values)
    (limbs, payloads), = seen
    hi, lo = limbs
    assert lo.stride() == hi.stride() == (2,)
    assert lo.data_ptr() == keys.data_ptr()
    assert hi.data_ptr() == keys.data_ptr() + 4
    if value_dtype.itemsize == 8:
        plo, phi = payloads
        assert plo.stride() == (2,) and plo.data_ptr() == values.data_ptr()
        assert phi.data_ptr() == values.data_ptr() + 4
    else:
        assert payloads[0].data_ptr() == values.data_ptr()
    # the result is the loop's own columns, not the inputs
    assert out_keys.data_ptr() != keys.data_ptr()
    assert out_values.data_ptr() != values.data_ptr()
    assert out_keys.is_contiguous() and out_values.is_contiguous()


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16, torch.uint32,
                                   torch.uint64, torch.int64, torch.float64])
def test_twiddle_in_copies_only_what_it_changes(dtype):
    keys = _words(N, dtype if dtype.itemsize >= 4 else torch.int32, 3)
    keys = keys.view(dtype) if dtype.itemsize >= 4 else keys.to(dtype)
    bits = twiddle.twiddle_in(keys)
    unsigned = twiddle.unsigned_dtype(dtype) == dtype
    assert (bits.data_ptr() == keys.data_ptr()) == unsigned
    assert twiddle.twiddle_in(keys, descending=True).data_ptr() != \
        keys.data_ptr()
    # twiddle_out copies unless its caller owns the bits
    assert twiddle.twiddle_out(bits, dtype).data_ptr() != bits.data_ptr()
    assert (twiddle.twiddle_out(bits, dtype, copy=False).data_ptr()
            == bits.data_ptr()) == unsigned


def _keys(dtype: torch.dtype, case: str, seed: int) -> torch.Tensor:
    k = _words(N, torch.int64, seed)
    if case == "all_equal":  # every pass skipped
        k = torch.full((N,), 0x0123456789ABCDEF, dtype=torch.int64)
    elif case == "three_bytes":  # three passes run (an odd count)
        k = k & 0xFFFFFF
    elif case == "ties":
        k = k & 0x0F000000000000FF
    if dtype == torch.float64:
        f = k.view(torch.float64).clone()
        f[f.isnan()] = 1.5
        f[:7] = torch.tensor([-0.0, 0.0, float("inf"), -float("inf"),
                              float("nan"), -2.0, 3.0], dtype=torch.float64)
        return f
    return k.view(dtype)


@pytest.mark.parametrize("dtype", [torch.uint64, torch.int64, torch.float64])
@pytest.mark.parametrize("case", ["random", "all_equal", "three_bytes",
                                  "ties"])
@pytest.mark.parametrize("descending", [False, True])
def test_pairs_match_the_reference_engine(dtype, case, descending):
    keys = _keys(dtype, case, seed=4)
    values = {"idx": torch.arange(N, dtype=torch.int32),
              "wide": _words(N, torch.float64, 5),
              "narrow": _words(N, torch.int32, 6).to(torch.int16)}
    got_k, got_v = rt.sort_pairs(keys, values, descending=descending)
    want_k, want_v = rt.sort_pairs(keys, values, descending=descending,
                                   config=REFERENCE)
    _same(got_k, want_k)
    for name in values:
        _same(got_v[name], want_v[name])
    assert got_k.data_ptr() != keys.data_ptr()
    assert got_v["wide"].data_ptr() != values["wide"].data_ptr()


@pytest.mark.parametrize("dtype", [torch.uint64, torch.int64, torch.float64])
@pytest.mark.parametrize("begin,end", [(0, 40), (20, 50), (31, 33), (33, 64),
                                       (3, 29), (36, 60)])
def test_bit_ranges_match_the_reference_engine(dtype, begin, end):
    keys = _keys(dtype, "random", seed=begin + end)
    idx = torch.arange(N, dtype=torch.int32)
    got = rt.sort_pairs(keys, idx, begin_bit=begin, end_bit=end)
    want = rt.sort_pairs(keys, idx, begin_bit=begin, end_bit=end,
                         config=REFERENCE)
    _same(got[0], want[0])
    _same(got[1], want[1])
    _same(rt.sort(keys, begin_bit=begin, end_bit=end, descending=True),
          rt.sort(keys, begin_bit=begin, end_bit=end, descending=True,
                  config=REFERENCE))


@pytest.mark.parametrize("case", ["random", "all_equal", "three_bytes"])
def test_keys_only_and_struct_sorts_keep_the_layout(case):
    keys = _keys(torch.uint64, case, seed=7)
    out = rt.sort(keys)
    _same(out, rt.sort(keys, config=REFERENCE))
    assert out.data_ptr() != keys.data_ptr() and out.is_contiguous()
    second = _words(N, torch.int64, 8) & 3
    got = rt.sort_struct([second, keys], torch.arange(N, dtype=torch.int32))
    want = rt.sort_struct([second, keys], torch.arange(N, dtype=torch.int32),
                          config=REFERENCE)
    for g, w in zip(got[0] + (got[1],), want[0] + (want[1],)):
        _same(g, w)
    # one column given twice: its halves pair with their neighbours
    twice = rt.sort_struct([keys, keys])
    _same(twice[0], out)
    _same(twice[1], out)


@pytest.mark.parametrize("n_passes", [0, 1, 2, 3])
def test_sort_limbs_writes_the_result_last(n_passes):
    # with k executed passes the first reads the inputs and the last writes
    # the fresh result columns, whatever the parity of k
    keys = (_words(N, torch.int64, 9) & ((1 << (8 * n_passes)) - 1)
            if n_passes else torch.zeros(N, dtype=torch.int64))
    pay = _words(N, torch.int64, 10)
    lo, hi = hist.halves(keys)
    plo, phi = hist.halves(pay)
    cfg = SortConfig()
    (ohi, olo), (oplo, ophi) = kpipe.sort_limbs([hi, lo], [(0, 32), (0, 32)],
                                                [plo, phi], cfg)
    assert hist.is_pair(olo, ohi) and hist.is_pair(oplo, ophi)
    got = hist.column_of(olo)
    assert got.data_ptr() != keys.data_ptr()
    order = torch.sort(keys, stable=True).indices
    assert torch.equal(got, keys[order])
    assert torch.equal(hist.column_of(oplo), pay[order])


def _stage_inputs(n: int, seed: int):
    col = _words(n, torch.int64, seed)
    lo, hi = hist.halves(col)
    pay = _words(n, torch.uint32, seed + 1)
    gbase = hist.stage_bases(hist.digit_histograms_plain(
        lo.contiguous(), n_stages=4, width=8))
    return lo, hi, pay, gbase


@pytest.mark.parametrize("key", ["lo", "hi"])
@pytest.mark.parametrize("n", [1, 7, 300])
def test_stage_plain_takes_the_halves_of_a_column(key, n):
    lo, hi, pay, _ = _stage_inputs(n, 11)
    planes = [lo, hi, pay] if key == "lo" else [hi, pay, lo]
    flat = [p.contiguous() for p in planes]
    k = planes[0].contiguous()
    gbase = hist.stage_bases(hist.digit_histograms_plain(
        k, n_stages=4, width=8))[1].contiguous()
    got = stage.partition_stage(planes, gbase, shift=8, width=8)
    want = stage.partition_stage_plain(flat, gbase, shift=8, width=8)
    for g, w, p in zip(got, want, planes):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert g.stride() == p.stride()
    assert hist.is_pair(*((got[0], got[1]) if key == "lo"
                          else (got[2], got[0])))


def test_stage_refuses_a_half_without_its_other_half():
    lo, hi, pay, gbase = _stage_inputs(64, 12)
    gbase = gbase[0].contiguous()
    with pytest.raises(ValueError):
        stage.partition_stage([lo, pay], gbase, shift=0, width=8)
    with pytest.raises(ValueError):  # outputs in another layout
        stage.partition_stage([lo, hi], gbase, shift=0, width=8,
                              out=[torch.empty_like(lo.contiguous()),
                                   torch.empty_like(hi.contiguous())])
    with pytest.raises(ValueError):  # a stride-3 view
        stage.partition_stage([_words(192, torch.uint32, 1)[::3]], gbase,
                              shift=0, width=8)


@pytest.mark.parametrize("limb_bits", [[(0, 32), (0, 32)], [(0, 27), (5, 32)],
                                       [(0, 16), (32, 32)],
                                       [(0, 0), (3, 29)]])
@pytest.mark.parametrize("width", [8, 4, 2])
def test_limb_histograms_plain_take_the_halves_of_a_column(limb_bits, width):
    col = _words(999, torch.int64, 13)
    lo, hi = hist.halves(col)
    got = hist.limb_histograms_plain([hi, lo], limb_bits, width)
    want = hist.limb_histograms_plain([hi.contiguous(), lo.contiguous()],
                                      limb_bits, width)
    assert torch.equal(got, want)
    # the halves must be neighbouring limbs
    other = _words(999, torch.uint32, 14)
    with pytest.raises(ValueError):
        hist.limb_histograms_plain([hi, other, lo], limb_bits[:1] + [(0, 32)]
                                   + limb_bits[1:], width)


# (call, key dtype, payload dtype, descending): STAGED_BYTES per row
STAGED = [
    ("sort_pairs", torch.uint64, torch.uint32, False, 0),
    ("sort_pairs", torch.uint64, torch.float64, False, 0),
    ("sort", torch.uint32, None, False, 0),
    ("sort", torch.int64, None, False, 32),    # twiddle in and out
    ("sort", torch.float64, None, False, 32),
    ("sort", torch.uint64, None, True, 32),    # complement in and out
    ("sort", torch.int64, None, True, 64),     # both, each way
    ("sort", torch.int32, None, False, 16),
    ("sort", torch.uint16, None, False, 12),   # widen 2 -> 4, narrow back
    ("sort_pairs", torch.uint32, torch.int16, False, 12),
]


@pytest.mark.parametrize("call,key_dtype,value_dtype,descending,per_row",
                         STAGED)
def test_staged_bytes_count_the_routes_copies(call, key_dtype, value_dtype,
                                              descending, per_row):
    keys = (_words(N, key_dtype, 15) if key_dtype.itemsize >= 4
            else _words(N, torch.int32, 15).to(key_dtype))
    before = tsort.STAGED_BYTES
    if call == "sort":
        rt.sort(keys, descending=descending)
    else:
        values = (_words(N, value_dtype, 16) if value_dtype.itemsize >= 4
                  else _words(N, torch.int32, 16).to(value_dtype))
        rt.sort_pairs(keys, values, descending=descending)
    assert tsort.STAGED_BYTES - before == per_row * N
    # the reference engine is not the radix route: nothing counted
    before = tsort.STAGED_BYTES
    rt.sort(keys, descending=descending, config=REFERENCE)
    assert tsort.STAGED_BYTES == before


@pytest.mark.parametrize("threads", [32, 128, 256, 512])
@pytest.mark.parametrize("items", stage.config_lib.STAGE_ITEMS)
def test_paired_tiles_fit_shared_memory(threads, items):
    # a pass with an 8-byte column exchanges 8-byte slots: 4 B a row more
    cfg = SortConfig(block_threads=threads, items_per_thread=items)
    for width in (2, 4, 8):
        plain = stage.stage_smem_bytes(cfg, width)
        paired = stage.stage_smem_bytes(cfg, width, paired=True)
        assert paired - plain == 4 * cfg.tile_elems
        assert paired <= stage.config_lib.SMEM_BYTES
    preset = stage.config_lib.preset()
    if (threads, items) == (preset.block_threads, preset.items_per_thread):
        # two blocks of the preset still fit an SM
        assert 2 * stage.stage_smem_bytes(preset, 8, paired=True) <= \
            stage.config_lib.SMEM_BYTES
