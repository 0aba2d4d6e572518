"""Port counting pass vs the JAX stage kernel (interpret mode), bit-exact.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernels are
held against the same plain version on the card by chip_smoke.py. Each JAX
interpret call costs several seconds (one compile per planes x width x
shift x shape): every call here is one of two (``_jax_stage``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda.radixsort_tpu.kernels import stage as jstage
from cuda.radixsort_tpu_torch.kernels import stage as tstage
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

N = 8192
# every JAX call runs on JAX_N keys: 96 rows of 128 lanes, three tiles at
# rows=32, so all calls of one width share one interpret compile
JAX_N = 3 * 32 * 128


def _gbase(keys, shift, width):
    d = (keys >> np.uint32(shift)) & np.uint32((1 << width) - 1)
    hist = np.bincount(d, minlength=1 << width)
    return (np.cumsum(hist) - hist).astype(np.int32)


def _keys(case, rng, n=N):
    if case == "constant":
        return np.full(n, 0x7777_0005, dtype=np.uint32)
    if case == "empty_buckets":
        return (rng.integers(0, 2, size=n, dtype=np.uint32) * 8)
    return rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _rotr(k, s):
    s = np.uint32(s % 32)
    return (k >> s) | (k << np.uint32((32 - s) % 32)) if s else k


def _jax_stage(planes, shift, width, rows=32):
    """The JAX stage kernel's output planes (interpret mode). Its compile
    is paid once per planes x width x shift x shape, so every call here is
    one of width 2 or 4 at shift 0 over two planes of JAX_N keys: the keys,
    padded with keys of the top digit (they land after every real key) and
    rotated right by ``shift`` (the same digit at bit 0, so the same
    stable permutation), and their row index, whose first n outputs gather
    every payload plane."""
    n = planes[0].size
    top = np.uint32(((1 << width) - 1) << shift)
    keys = _rotr(np.concatenate([planes[0], np.full(JAX_N - n, top, np.uint32)]),
                 shift)
    idx = np.arange(JAX_N, dtype=np.uint32)
    out = jstage.partition_stage(
        [jnp.asarray(p).reshape(-1, 128) for p in (keys, idx)],
        jnp.asarray(_gbase(keys, 0, width)), shift=0, width=width, rows=rows,
        interpret=True)
    k, i = (np.asarray(o).reshape(-1)[:n] for o in out)
    return [_rotr(k, 32 - shift)] + [p[i] for p in planes[1:]]


def _oracle(planes, shift, width):
    d = (planes[0] >> np.uint32(shift)) & np.uint32((1 << width) - 1)
    order = np.argsort(d, kind="stable")
    return [p[order] for p in planes]


@pytest.mark.parametrize("case,width,shift,n_planes", [
    ("random", 4, 0, 1),
    ("random", 4, 28, 3),
    ("constant", 2, 0, 1),
    ("empty_buckets", 2, 2, 1),
])
def test_stage_matches_jax_interpret(case, width, shift, n_planes):
    rng = np.random.default_rng(shift * 7 + width + n_planes)
    keys = _keys(case, rng)
    planes = [keys] + [rng.integers(0, 2**32, size=N, dtype=np.uint64)
                       .astype(np.uint32) for _ in range(n_planes - 1)]
    want = _jax_stage(planes, shift, width)
    got = tstage.partition_stage([from_numpy(p, device="cpu") for p in planes],
                                 from_numpy(_gbase(keys, shift, width), device="cpu"),
                                 shift=shift, width=width)
    assert len(got) == n_planes
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g), w)


@pytest.mark.parametrize("n,shift,n_planes,case", [
    (8192, 0, 1, "random"),
    (5003, 24, 3, "random"),
    (4097, 8, 10, "random"),   # more planes than one kernel launch takes
    (3000, 16, 2, "constant"),
    (1, 0, 2, "random"),
    (0, 0, 1, "random"),
])
def test_stage_width8_vs_numpy(n, shift, n_planes, case):
    # the JAX stage kernel takes widths 2 and 4 only
    rng = np.random.default_rng(n + shift)
    keys = _keys(case, rng, n)
    planes = [keys] + [rng.integers(0, 2**32, size=n, dtype=np.uint64)
                       .astype(np.uint32) for _ in range(n_planes - 1)]
    out = [torch.empty(n, dtype=torch.uint32) for _ in planes]
    got = tstage.partition_stage([from_numpy(p, device="cpu") for p in planes],
                                 from_numpy(_gbase(keys, shift, 8), device="cpu"),
                                 shift=shift, width=8, out=out)
    assert all(g is o for g, o in zip(got, out))
    for g, w in zip(got, _oracle(planes, shift, 8)):
        np.testing.assert_array_equal(to_numpy(g), w)


def test_stage_rejects_bad_input():
    keys = torch.arange(64, dtype=torch.int32).view(torch.uint32)
    gb = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(TypeError):
        tstage.partition_stage([keys.view(torch.int32)], gb, shift=0, width=8)
    with pytest.raises(ValueError):
        tstage.partition_stage([keys], gb, shift=28, width=8)  # past bit 32
    with pytest.raises(ValueError):
        tstage.partition_stage([keys], gb[:16], shift=0, width=8)
    with pytest.raises(ValueError):
        tstage.partition_stage([keys], gb, shift=0, width=8, out=[keys])
    with pytest.raises(ValueError):
        tstage.partition_stage([keys, keys[:32]], gb, shift=0, width=8)


TILE = tstage.config_lib.preset().tile_elems  # the card's stage tile


@pytest.mark.parametrize("n,n_planes,width,shift", [
    (TILE - 1, 1, 4, 0),
    (TILE, 2, 4, 12),
    (TILE + 1, 3, 2, 30),
    (TILE + 1, 10, 2, 8),   # more planes than one kernel launch takes
])
def test_stage_tile_edges_match_jax(n, n_planes, width, shift):
    rng = np.random.default_rng(n + n_planes)
    planes = [rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
              for _ in range(n_planes)]
    got = tstage.partition_stage([from_numpy(p, device="cpu") for p in planes],
                                 from_numpy(_gbase(planes[0], shift, width), device="cpu"),
                                 shift=shift, width=width)
    for g, w in zip(got, _jax_stage(planes, shift, width)):
        np.testing.assert_array_equal(to_numpy(g), w)


@pytest.mark.parametrize("n,width", [(1, 8), (TILE, 8), (TILE + 1, 4),
                                     (1 << 28, 8)])
def test_stage_scratch_sizes(n, width):
    # one tile claim counter and one lookback word per (tile, digit)
    cfg = tstage.config_lib.preset()
    n_tiles, words = tstage.stage_scratch(n, cfg, width)
    assert n_tiles == -(-n // cfg.tile_elems)
    assert (n_tiles - 1) * cfg.tile_elems < n <= n_tiles * cfg.tile_elems
    assert words == 1 + n_tiles * (1 << width)
    if n == 1 << 28:  # config 2's pass: at most 128 MiB of status words
        assert words * 8 <= (1 << 27) + 8


@pytest.mark.parametrize("threads", [32, 128, 256, 512])
@pytest.mark.parametrize("items", tstage.config_lib.STAGE_ITEMS)
def test_stage_tiles_fit_shared_memory(threads, items):
    cfg = tstage.config_lib.SortConfig(block_threads=threads,
                                       items_per_thread=items)
    for width in (2, 4, 8):
        smem = tstage.stage_smem_bytes(cfg, width)
        assert 5 * cfg.tile_elems < smem <= tstage.config_lib.SMEM_BYTES


@pytest.mark.parametrize("n", [1 << 24, 1 << 28])
def test_stage_status_words_cost_a_quarter_byte_a_row(n):
    # the preset's lookback words (8 B per digit per tile) bound the keys
    # cell's peak: at most 0.25 B a row over its 12 B of columns
    cfg = tstage.config_lib.preset()
    assert cfg.tile_elems == 8192
    _, words = tstage.stage_scratch(n, cfg, cfg.radix_bits)
    assert words * 8 / n <= 0.25 + 8 / n


# csrc/stage.cu's shared-memory layout, region by region in its order:
# global offsets (int64 a digit), the block scan (32 int64), the tile's
# values (4 B a key, 8 B paired), the warps' per-digit counts (int), the
# digits' counts and starts (int), the tile index (4 int), the digits (u8)
def _layout_bytes(threads, items, width, paired):
    nb, tile = 1 << width, threads * items
    return sum([nb * 8, 32 * 8, tile * (8 if paired else 4),
                (threads // 32) * nb * 4, nb * 4, nb * 4, 4 * 4, tile])


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("width", [2, 4, 8])
@pytest.mark.parametrize("threads,items", [(256, 32), (512, 16), (32, 4)])
def test_stage_smem_bytes_is_the_layouts_sum(threads, items, width, paired):
    cfg = tstage.config_lib.SortConfig(block_threads=threads,
                                       items_per_thread=items)
    assert (tstage.stage_smem_bytes(cfg, width, paired=paired)
            == _layout_bytes(threads, items, width, paired))


@pytest.mark.parametrize("kw", [dict(block_threads=1024),
                                dict(block_threads=544),
                                dict(block_threads=48),
                                dict(items_per_thread=12),
                                dict(items_per_thread=64),
                                dict(items_per_thread=1)])
def test_config_rejects_what_the_stage_kernel_cannot_run(kw):
    with pytest.raises(ValueError):
        tstage.config_lib.SortConfig(**kw)
