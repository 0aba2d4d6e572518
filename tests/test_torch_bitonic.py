"""The port's comparison network vs the JAX network kernels, bit for bit.

The JAX side runs ``sort_planes_bitonic`` / ``merge_sorted_planes_bitonic``
in interpret mode with log_tile < log_merge < logn, so its tile, cross-span
and merge kernels all run; its compact bodies (the same network, a smaller
program to compile) serve most cases. The port runs its plain version on
the CPU. The CUDA kernels are held against the same plain version on the
card by chip_smoke.py; here the launch plan that feeds them is checked to
cover every stage in order, and to give the plain network when each
planned pass runs through its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda.radixsort_tpu_torch as rt
from cuda.radixsort_tpu.kernels import bitonic as jb
from cuda.radixsort_tpu_torch.kernels import bitonic as tb
from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

LOGN, LOG_TILE, LOG_MERGE = 10, 7, 8


def _planes(n_planes, n_cmp, case, seed, logn=LOGN):
    """u32 planes; ``ties``: four values per comparand plane, ``constant``:
    one. n_cmp > 0 with ride planes gets a permutation as its last
    comparand, so the order is total."""
    rng = np.random.default_rng(seed)
    n = 1 << logn
    planes = [rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
              for _ in range(n_planes)]
    for q in range(min(abs(n_cmp), n_planes)):
        if case == "ties":
            planes[q] &= np.uint32(3)
        elif case == "constant":
            planes[q][:] = np.uint32(0xC0FFEE)
    if 0 < n_cmp < n_planes:
        planes[n_cmp - 1] = rng.permutation(n).astype(np.uint32)
    return planes


def _assert_planes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))


@pytest.mark.parametrize("n_planes,n_cmp,case,compact", [
    (1, 1, "random", False),
    (2, -1, "constant", True),
    (2, 2, "ties", True),
    (3, -2, "ties", True),
    (4, 3, "random", True),
    (4, -1, "ties", True),
])
def test_sort_planes_matches_jax(n_planes, n_cmp, case, compact):
    planes = _planes(n_planes, n_cmp, case, seed=n_planes * 10 + n_cmp)
    want = jb.sort_planes_bitonic(
        [jnp.asarray(p) for p in planes], n_cmp=n_cmp, log_tile=LOG_TILE,
        log_merge=LOG_MERGE, compact=compact, interpret=True)
    mine = [from_numpy(p, device="cpu") for p in planes]
    got = tb.sort_planes_bitonic(mine, n_cmp=n_cmp, log_tile=LOG_TILE)
    _assert_planes(got, want)
    assert all(g is m for g, m in zip(got, mine))  # in place
    if n_cmp < 0 and case == "ties":
        # the tile direction is part of the network: another log_tile
        # lands tied rows elsewhere
        other = tb.sort_planes_bitonic([from_numpy(p, device="cpu") for p in planes],
                                       n_cmp=n_cmp, log_tile=LOGN)
        assert not all(np.array_equal(to_numpy(o), np.asarray(w))
                       for o, w in zip(other, want))


@pytest.mark.parametrize("n_planes,n_cmp,case,log_block,compact", [
    (1, 1, "random", 6, False),
    (3, -2, "ties", 7, True),
])
def test_merge_planes_matches_jax(n_planes, n_cmp, case, log_block, compact):
    planes = _planes(n_planes, n_cmp, case, seed=log_block)
    want = jb.merge_sorted_planes_bitonic(
        [jnp.asarray(p) for p in planes], log_block=log_block, n_cmp=n_cmp,
        log_merge=LOG_MERGE, compact=compact, interpret=True)
    got = tb.merge_sorted_planes_bitonic([from_numpy(p, device="cpu") for p in planes],
                                         log_block=log_block, n_cmp=n_cmp)
    _assert_planes(got, want)


def test_sort_bits_sorts():
    x = _planes(1, 1, "random", seed=5, logn=12)[0]
    got = tb.sort_bits_bitonic(from_numpy(x, device="cpu"))
    np.testing.assert_array_equal(to_numpy(got), np.sort(x))


def _stages(ops, log_t_of):
    """The (k, j) stages a launch plan runs, in order."""
    out = []
    for op in ops:
        if op[0] == "tile":
            _, k_first, k_last, log_t = op
            assert log_t == log_t_of
            for k in range(k_first, k_last + 1):
                out += [(k, j) for j in range(min(k, log_t) - 1, -1, -1)]
        else:
            _, k, lo, c = op
            out += [(k, j) for j in range(lo + c - 1, lo - 1, -1)]
    return out


@pytest.mark.parametrize("n_planes", [1, 2, 3, 4])
@pytest.mark.parametrize("logn", [0, 1, 10, 13, 24, 31])
def test_plan_runs_every_stage_in_order(n_planes, logn):
    log_t = min(tb.tile_log_rows(n_planes), logn)
    c_max = tb.cross_strides(n_planes)
    for k_first in sorted({1, max(logn - 3, 1), max(logn, 1), logn + 1}):
        ops = tb.plan_passes(logn, k_first, n_planes)
        want = [(k, j) for k in range(k_first, logn + 1)
                for j in range(k - 1, -1, -1)]
        assert _stages(ops, log_t) == want
        for op in ops:
            if op[0] == "cross":
                assert 1 <= op[3] <= c_max and op[2] >= log_t


@pytest.mark.parametrize("n_planes,n_cmp", [(1, 1), (2, -1), (3, 2), (4, -2),
                                            (4, 4)])
def test_planned_passes_give_the_plain_network(n_planes, n_cmp):
    # the CUDA route's schedule, each pass through its plain version, on a
    # geometry small enough that every pass kind runs at 2^10 rows
    geo = dict(log_t=(4, 3, 3, 2)[n_planes - 1],
               c_max=(3, 2, 2, 1)[n_planes - 1])
    planes = [from_numpy(p, device="cpu") for p in _planes(n_planes, n_cmp, "ties",
                                             seed=n_planes, logn=10)]
    lt = 7  # the network's tile: levels below it fold in bit 7
    want = tb.sort_planes_bitonic_plain([p.clone() for p in planes],
                                        n_cmp=n_cmp, log_tile=lt)
    got = tb.run_passes([p.clone() for p in planes],
                        tb.plan_passes(10, 1, n_planes, **geo), lt, n_cmp)
    _assert_planes(got, [to_numpy(w) for w in want])
    merged = tb.run_passes([p.clone() for p in planes],
                           tb.plan_passes(10, 6, n_planes, **geo), 0, n_cmp)
    _assert_planes(merged, [to_numpy(w) for w in
                            tb.merge_sorted_planes_bitonic_plain(
                                [p.clone() for p in planes], log_block=5,
                                n_cmp=n_cmp)])


def test_wrappers_reject_bad_input():
    u = torch.zeros(8, dtype=torch.uint32)
    with pytest.raises(ValueError, match="power of two"):
        tb.sort_planes_bitonic([torch.zeros(6, dtype=torch.uint32)])
    with pytest.raises(TypeError):
        tb.sort_planes_bitonic([torch.zeros(8, dtype=torch.int32)])
    with pytest.raises(ValueError, match="planes"):
        tb.sort_planes_bitonic([u.clone() for _ in range(5)])
    with pytest.raises(ValueError, match="n_cmp"):
        tb.sort_planes_bitonic([u], n_cmp=0)
    with pytest.raises(ValueError, match="log_block"):
        tb.merge_sorted_planes_bitonic([u], log_block=4)
    with pytest.raises(ValueError, match="2\\^c"):
        tb.cross_pass([torch.zeros(64, dtype=torch.uint32) for _ in range(4)],
                      k=6, lo=0, c=5)
    with pytest.raises(ValueError, match="log_t"):
        tb.tile_pass([u], log_t=4, k_first=1, k_last=3)
    meta = [torch.empty(8, dtype=torch.uint32, device="meta")]
    for call in (lambda: tb.sort_planes_bitonic(meta),
                 lambda: tb.tile_pass(meta, log_t=3, k_first=1, k_last=3),
                 lambda: tb.cross_pass(meta, k=3, lo=0, c=1)):
        with pytest.raises(ValueError, match="device"):
            call()


def test_network_geometry_is_checked():
    # the largest tiles whose padded planes fit half of 227 KB of shared
    # memory (two blocks an SM), and the widest spans whose rows fit a
    # cross thread's 64 words
    assert [tb.tile_log_rows(p) for p in (1, 2, 3, 4)] == [14, 13, 13, 12]
    assert [tb.cross_strides(p) for p in (1, 2, 3, 4)] == [6, 5, 4, 4]
    with pytest.raises(ValueError, match="shared memory"):
        tb.plan_passes(20, 1, 1, log_t=16)
    with pytest.raises(ValueError, match="2\\^c"):
        tb.plan_passes(20, 1, 3, c_max=5)
    with pytest.raises(ValueError, match="split_sort_min_logn"):
        rt.SortConfig(split_sort_min_logn=10)


@pytest.mark.parametrize("n_planes", [1, 2, 3, 4])
def test_tile_geometry(n_planes):
    cfg = rt.config
    budget = cfg.SMEM_BYTES // cfg.TILE_BLOCKS_PER_SM
    top = tb.tile_log_rows(n_planes)
    assert tb.tile_smem_bytes(n_planes, top) <= budget
    assert tb.tile_smem_bytes(n_planes, top + 1) > budget
    for log_t in range(1, top + 2):
        e, threads = tb.tile_geometry(n_planes, log_t)
        # registers: E = 2^e rows of every plane, at most 64 words
        assert (n_planes << e) <= cfg.MAX_TILE_WORDS <= 64
        assert 1 <= e <= log_t
        assert tb.tile_smem_bytes(n_planes, log_t) <= cfg.SMEM_BYTES
        # threads x E rows cover the tile in whole passes of the block
        assert threads & (threads - 1) == 0
        assert threads <= cfg.MAX_TILE_THREADS
        passes = (1 << log_t) // (threads << e)
        assert passes >= 1 and threads * (1 << e) * passes == 1 << log_t
        assert threads >= 32 or passes == 1


def _phase_stages(phases, log_t, e):
    """The (k, j, kind) stages the tile kernel runs for a phase list: kind
    'shared', 'shuffle' (strides of 2^e and more in a register phase) or
    'register'."""
    out = []
    for kind, k, a, b in phases:
        if kind == "shared":  # strides 2^(a+b-1)..2^a of level k
            out += [(k, j, "shared") for j in range(a + b - 1, a - 1, -1)]
            continue
        stages = [(k, j) for j in range(b, -1, -1)]  # level k from 2^b
        stages += [(kk, j) for kk in range(k + 1, a + 1)  # levels k+1..k_end
                   for j in range(min(kk, log_t) - 1, -1, -1)]
        out += [(kk, j, "shuffle" if j >= e else "register")
                for kk, j in stages]
    return out


@pytest.mark.parametrize("n_planes,n_cmp", [(1, 1), (2, -1), (3, 2),
                                            (4, -2), (4, 4)])
@pytest.mark.parametrize("log_t", [2, 7, 12])
def test_tile_phases_run_the_plain_network(n_planes, n_cmp, log_t):
    # log_t 2: registers only; 7: registers and shuffles; 12: all three.
    # The phase list is the one tile_pass hands the kernel.
    logn, lt_net = 13, 11
    e, _ = tb.tile_geometry(n_planes, log_t)
    big = e + tb.SHUFFLE_STRIDES

    def stages(phases):
        return [(k, j) for k, j, _ in _phase_stages(phases, log_t, e)]

    sort_phases = tb.tile_phases(log_t, e, 1, log_t)
    assert stages(sort_phases) == [
        (k, j) for k in range(1, log_t + 1) for j in range(k - 1, -1, -1)]
    for k in range(log_t + 1, logn + 1):
        merge = tb.tile_phases(log_t, e, k, k)
        assert stages(merge) == [(k, j) for j in range(log_t - 1, -1, -1)]
    kinds = set()
    for phases in (sort_phases, tb.tile_phases(log_t, e, logn, logn)):
        for k, j, kind in _phase_stages(phases, log_t, e):
            kinds.add(kind)
            assert kind == ("shared" if j >= big else
                            "shuffle" if j >= e else "register")
        for kind, k, a, b in phases:
            if kind == "shared":  # <= e consecutive strides of one level
                assert 1 <= b <= e and a >= big
            else:  # the shuffles pair lanes of one warp
                assert k <= a and b - e < tb.SHUFFLE_STRIDES
    assert kinds == ({"register"} if log_t <= e else
                     {"register", "shuffle"} if log_t <= big else
                     {"register", "shuffle", "shared"})

    planes = [from_numpy(p, device="cpu") for p in _planes(n_planes, n_cmp, "ties",
                                             seed=log_t + n_planes,
                                             logn=logn)]
    want = tb.sort_planes_bitonic_plain([p.clone() for p in planes],
                                        n_cmp=n_cmp, log_tile=lt_net)
    views = [p.view(torch.int32) for p in planes]
    # the kernel's schedule: sort pass, then per level its cross strides
    # and its tile merge pass, every stage through _stage_plain
    run = stages(sort_phases)
    for k in range(log_t + 1, logn + 1):
        run += [(k, j) for j in range(k - 1, log_t - 1, -1)]
        run += stages(tb.tile_phases(log_t, e, k, k))
    assert run == [(k, j) for k in range(1, logn + 1)
                   for j in range(k - 1, -1, -1)]
    for k, j in run:
        tb._stage_plain(views, k, j, lt_net, n_cmp)
    _assert_planes(planes, [to_numpy(w) for w in want])
