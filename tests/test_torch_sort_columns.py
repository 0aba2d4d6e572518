"""8-byte columns on the radix route, on the CPU (the kernels' plain
versions).

A 64-bit key or an 8-byte payload crosses the LSD loop as one column: the
sort API hands ``kernels/pipeline.py::sort_limbs`` the caller's column (or
the twiddled bits), the first pass reads it, the last pass writes the
result's own 8-byte column, and the result is that column. These tests hold
the loop's inputs to the caller's storage, the results to the reference
engine bit for bit, the kernels' plain versions on a column to the same
answers as on its contiguous u32 words, and ``ops/sort.py::STAGED_BYTES``
to the copies the route still makes.
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
    ((key,), (payload,)), = seen
    assert key.element_size() == 8 and key.is_contiguous()
    assert key.data_ptr() == keys.data_ptr()
    assert payload.data_ptr() == values.data_ptr()
    assert payload.element_size() == value_dtype.itemsize
    if value_dtype.itemsize == 8:
        assert payload.dtype == value_dtype
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
    # one column given as two keys: two columns of the same memory
    twice = rt.sort_struct([keys, keys])
    _same(twice[0], out)
    _same(twice[1], out)


@pytest.mark.parametrize("n_passes", [0, 1, 2, 3])
def test_sort_limbs_writes_the_result_last(n_passes, monkeypatch):
    # with k executed passes the first reads the inputs and the last writes
    # the fresh result columns, whatever the parity of k
    keys = (_words(N, torch.int64, 9) & ((1 << (8 * n_passes)) - 1)
            if n_passes else torch.zeros(N, dtype=torch.int64))
    pay = _words(N, torch.int64, 10)
    calls = []
    real = stage.partition_stage

    def spy(columns, gbase, **kw):
        calls.append(([c.data_ptr() for c in columns],
                      [o.data_ptr() for o in kw["out"]]))
        return real(columns, gbase, **kw)

    monkeypatch.setattr(stage, "partition_stage", spy)
    (got,), (got_pay,) = kpipe.sort_limbs([keys], [(0, 64)], [pay],
                                          SortConfig())
    assert got.dtype == keys.dtype and got_pay.dtype == pay.dtype
    assert got.data_ptr() != keys.data_ptr()
    assert len(calls) == n_passes
    if n_passes:
        assert calls[0][0] == [keys.data_ptr(), pay.data_ptr()]
        assert calls[-1][1] == [got.data_ptr(), got_pay.data_ptr()]
    order = torch.sort(keys, stable=True).indices
    assert torch.equal(got, keys[order])
    assert torch.equal(got_pay, pay[order])


@pytest.mark.parametrize("width", [8, 4, 2])
def test_a_range_across_bit_32_matches_the_reference_engine(width):
    # bits [20, 50) of one 64-bit column: masked passes in both words
    keys = _words(N, torch.int64, 17)
    pay = _words(N, torch.uint32, 18)
    cfg = SortConfig(radix_bits=width)
    got = kpipe.sort_limbs([keys], [(20, 50)], [pay], cfg)
    want = tsort._sort_limbs_reference([keys], [(20, 50)], [pay],
                                       cfg.replace(engine="reference"))
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        _same(g, w)


def _halves(col: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi): contiguous copies of the u32 words of an 8-byte column."""
    words = col.view(torch.int32).reshape(-1, 2)
    return (words[:, 0].contiguous().view(torch.uint32),
            words[:, 1].contiguous().view(torch.uint32))


def _gbase(key: torch.Tensor, shift: int, width: int) -> torch.Tensor:
    counts = torch.bincount(hist.digits(key, shift, width),
                            minlength=1 << width)
    return (torch.cumsum(counts, 0) - counts).to(torch.int32)


@pytest.mark.parametrize("shift", [8, 40])
@pytest.mark.parametrize("n", [1, 7, 300])
def test_stage_plain_takes_the_halves_of_a_column(shift, n):
    # an 8-byte key column at a digit in its low or high word, beside a u32
    # and an 8-byte payload, against the same pass on contiguous u32 words
    col = _words(n, torch.int64, 11)
    pay = _words(n, torch.uint32, 12)
    wide = _words(n, torch.float64, 13)
    lo, hi = _halves(col)
    wlo, whi = _halves(wide)
    gbase = _gbase(col, shift, 8)
    got = stage.partition_stage([col, pay, wide], gbase, shift=shift, width=8)
    key = hi if shift >= 32 else lo
    want = stage.partition_stage_plain([key, lo, hi, pay, wlo, whi], gbase,
                                       shift=shift % 32, width=8)
    assert [g.dtype for g in got] == [col.dtype, pay.dtype, wide.dtype]
    assert all(torch.equal(a, b) for a, b in zip(_halves(got[0]), want[1:3]))
    assert torch.equal(got[1], want[3])
    assert all(torch.equal(a, b) for a, b in zip(_halves(got[2]), want[4:]))


def test_stage_refuses_a_half_without_its_other_half():
    col = _words(64, torch.int64, 12)
    lo = col.view(torch.int32).reshape(-1, 2)[:, 0].view(torch.uint32)
    gbase = _gbase(col, 0, 8)
    with pytest.raises(ValueError):  # a stride-2 half: not contiguous
        stage.partition_stage([lo], gbase, shift=0, width=8)
    with pytest.raises(TypeError):  # a 2-byte column
        stage.partition_stage([col, col.to(torch.int16)], gbase, shift=0,
                              width=8)
    with pytest.raises(ValueError):  # past bit 64
        stage.partition_stage([col], gbase, shift=60, width=8)
    with pytest.raises(ValueError):  # past bit 32 of a u32 key
        stage.partition_stage([lo.contiguous(), col], gbase, shift=32,
                              width=8)
    with pytest.raises(ValueError):  # outputs of another dtype
        stage.partition_stage([col], gbase, shift=0, width=8,
                              out=[torch.empty(64, dtype=torch.float32)])


@pytest.mark.parametrize("bits", [(0, 64), (5, 59), (0, 16), (32, 64)])
@pytest.mark.parametrize("width", [8, 4, 2])
def test_limb_histograms_plain_take_the_halves_of_a_column(bits, width):
    col = _words(999, torch.int64, 13)
    lo, hi = _halves(col)
    got = hist.limb_histograms_plain([col], [bits], width)
    want = hist.limb_histograms_plain([hi, lo], hist.word_ranges(col, *bits),
                                      width)
    assert torch.equal(got, want)
    # stage_rows finds every stage of the column's hull
    rows = hist.stage_rows([col], [bits], width)
    mask = ((1 << bits[1]) - 1) & ~((1 << bits[0]) - 1)
    key = col & (mask - (1 << 64) if mask >> 63 else mask)
    for shift in range(bits[0] // width * width, -(-bits[1] // width) * width,
                       width):
        assert torch.equal(got[rows[0, shift]].to(torch.int64), torch.bincount(
            hist.digits(key, shift, width), minlength=1 << width))


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
    # the reference engine takes the same columns: the same copies counted
    before = tsort.STAGED_BYTES
    if call == "sort":
        rt.sort(keys, descending=descending, config=REFERENCE)
    else:
        rt.sort_pairs(keys, values, descending=descending, config=REFERENCE)
    assert tsort.STAGED_BYTES - before == per_row * N


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
