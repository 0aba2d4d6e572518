"""Bitonic compare-exchange network over u32 planes — the network engine.

Counterpart of ``cuda/radixsort_tpu/kernels/bitonic.py``
(``sort_planes_bitonic``, ``sort_bits_bitonic``,
``merge_sorted_planes_bitonic``, comparator ``_cmpex_planes``). 1-4 planes
of 2^logn rows sort ascending, lexicographically on the first |n_cmp|
planes; the other planes ride along (``csrc/bitonic.cu`` states the
comparator and its contract: n_cmp > 0 needs a total order, n_cmp < 0 is
tie-safe).

The network is the JAX engine's: level k's pairs run descending iff bit k
of the lower index is set, XOR bit ``log_tile`` for levels below it (its
sort tiles alternate direction). Every schedule of the same stages gives
the same output, so the result, ties included, is JAX's whenever the two
run with the same ``log_tile``.

On a CUDA tensor the wrappers launch the two kernels of ``csrc/bitonic.cu``
(the shared-memory tile kernel and the register cross kernel) in the order
:func:`plan_passes` gives; on a CPU tensor they run the plain versions,
which apply the same network stage by stage to whole tensors. There is no
other route. Everything works in place: the planes passed in are
overwritten with the result, which is also returned.
"""

from __future__ import annotations

import ctypes

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch.utils import build

TILE_LAUNCHES = 0   # launches of the tile kernel (tile_pass)
CROSS_LAUNCHES = 0  # launches of the cross kernel (cross_pass)

_BIAS = -(1 << 31)  # int32 view ^ _BIAS orders as the unsigned bits


def network_log_tile(n_planes: int) -> int:
    """The JAX engine's default sort tile (``ops/sort.py`` ``lt_default``):
    2^16 rows up to 2 planes, 2^15 from 3 up. Part of the network's
    definition, so unstable sorts that pass it land ties where JAX does."""
    return 16 if n_planes <= 2 else 15


def _check(planes, n_cmp: int) -> int:
    """Validate the planes; returns logn."""
    if not 1 <= len(planes) <= config_lib.MAX_PLANES:
        raise ValueError(f"need 1..{config_lib.MAX_PLANES} planes; got "
                         f"{len(planes)}")
    dev, shape = planes[0].device, planes[0].shape
    for p in planes:
        if p.dtype != torch.uint32:
            raise TypeError(f"planes must be torch.uint32; got {p.dtype}")
        if p.dim() != 1 or p.shape != shape or p.device != dev:
            raise ValueError("planes must be 1-D with one shape and device")
        if not p.is_contiguous():
            raise ValueError("planes must be contiguous")
    n = shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(f"the row count must be a power of two; got {n}")
    if not isinstance(n_cmp, int) or n_cmp == 0:
        raise ValueError(f"n_cmp must be a non-zero int; got {n_cmp!r}")
    return n.bit_length() - 1


def _require_cuda(planes) -> None:
    if planes[0].device.type != "cuda":
        raise ValueError(f"unsupported device {planes[0].device}")


# ---------------------------------------------------------------------------
# plain versions: the network stage by stage on whole tensors
# ---------------------------------------------------------------------------


def _stage_plain(views, k: int, j: int, net_tile: int, n_cmp: int) -> None:
    """Stage (k, j) of the network, in place on int32 views of the planes:
    each (N/2^(j+1), 2, 2^j) view pairs row i with row i + 2^j."""
    s = 1 << j
    pairs = [v.view(-1, 2, s) for v in views]
    a = [p[:, 0, :] for p in pairs]
    b = [p[:, 1, :] for p in pairs]
    blk = torch.arange(pairs[0].shape[0], dtype=torch.int64,
                       device=views[0].device)
    d = blk >> (k - j - 1)               # bit k of the lower row's index
    if k < net_tile:
        d = d ^ (blk >> (net_tile - j - 1))
    desc = (d & 1).bool().unsqueeze(1)
    kcmp = min(abs(n_cmp), len(views))
    lt = eq = None
    for x, y in zip(a[:kcmp], b[:kcmp]):
        xb, yb = x ^ _BIAS, y ^ _BIAS
        lt = xb < yb if lt is None else lt | (eq & (xb < yb))
        eq = xb == yb if eq is None else eq & (xb == yb)
    gt = ~(lt | eq)
    if n_cmp > 0 or kcmp == len(views):
        take_a, take_b = lt ^ ~desc, gt ^ desc
    else:
        take_a = take_b = torch.where(desc, lt, gt)
    new_a = [torch.where(take_a, y, x) for x, y in zip(a, b)]
    new_b = [torch.where(take_b, x, y) for x, y in zip(a, b)]
    for x, y, nx, ny in zip(a, b, new_a, new_b):
        x.copy_(nx)
        y.copy_(ny)


def _levels_plain(planes, k_first: int, k_last: int, j_below: int,
                  net_tile: int, n_cmp: int):
    views = [p.view(torch.int32) for p in planes]
    for k in range(k_first, k_last + 1):
        for j in range(min(k, j_below) - 1, -1, -1):
            _stage_plain(views, k, j, net_tile, n_cmp)
    return planes


def tile_pass_plain(planes, *, log_t: int, k_first: int, k_last: int,
                    net_tile: int = 0, n_cmp: int = 1):
    """Plain version of :func:`tile_pass`."""
    planes = list(planes)
    logn = _check(planes, n_cmp)
    _check_tile(logn, log_t, k_first, k_last)
    return _levels_plain(planes, k_first, k_last, log_t, net_tile, n_cmp)


def cross_pass_plain(planes, *, k: int, lo: int, c: int, net_tile: int = 0,
                     n_cmp: int = 1):
    """Plain version of :func:`cross_pass`."""
    planes = list(planes)
    logn = _check(planes, n_cmp)
    _check_cross(logn, len(planes), k, lo, c)
    views = [p.view(torch.int32) for p in planes]
    for j in range(lo + c - 1, lo - 1, -1):
        _stage_plain(views, k, j, net_tile, n_cmp)
    return planes


def sort_planes_bitonic_plain(planes, *, n_cmp: int = 1, log_tile: int = 16):
    """Plain version of :func:`sort_planes_bitonic`: every stage of levels
    1..logn in order."""
    planes = list(planes)
    logn = _check(planes, n_cmp)
    return _levels_plain(planes, 1, logn, logn, min(log_tile, logn), n_cmp)


def merge_sorted_planes_bitonic_plain(planes, *, log_block: int,
                                      n_cmp: int = 1):
    """Plain version of :func:`merge_sorted_planes_bitonic`: every stage of
    levels log_block+1..logn in order."""
    planes = list(planes)
    logn = _check(planes, n_cmp)
    _check_block(logn, log_block)
    return _levels_plain(planes, log_block + 1, logn, logn, 0, n_cmp)


# ---------------------------------------------------------------------------
# the two kernels
# ---------------------------------------------------------------------------


def _check_tile(logn, log_t, k_first, k_last) -> None:
    if not 1 <= log_t <= logn or not 1 <= k_first <= k_last <= logn:
        raise ValueError(f"need 1 <= log_t <= logn and 1 <= k_first <= "
                         f"k_last <= logn; got log_t={log_t}, k_first="
                         f"{k_first}, k_last={k_last}, logn={logn}")


def _check_cross(logn, n_planes, k, lo, c) -> None:
    if not (0 <= lo and 1 <= c <= 6 and lo + c <= k <= logn
            and n_planes << c <= config_lib.MAX_CROSS_WORDS):
        raise ValueError(f"need 0 <= lo, 1 <= c <= 6, lo + c <= k <= logn "
                         f"and 2^c * planes <= {config_lib.MAX_CROSS_WORDS};"
                         f" got k={k}, lo={lo}, c={c}, logn={logn}, "
                         f"planes={n_planes}")


def _check_block(logn, log_block) -> None:
    if not 0 <= log_block <= logn:
        raise ValueError(f"need 0 <= log_block <= logn; got {log_block}, "
                         f"logn={logn}")


def tile_pass(planes, *, log_t: int, k_first: int, k_last: int,
              net_tile: int = 0, n_cmp: int = 1):
    """Levels k_first..k_last of the network, each over its strides below
    2^log_t, in 2^log_t-row tiles held in shared memory (one block per
    tile; the kernel runs the phases of :func:`tile_phases` on the
    :func:`tile_geometry` of this log_t). Sort mode is levels 1..log_t;
    merge mode one level k > log_t after its cross strides. net_tile: the
    network's log_tile (0: none). In place; returns the planes."""
    global TILE_LAUNCHES
    planes = list(planes)
    logn = _check(planes, n_cmp)
    _check_tile(logn, log_t, k_first, k_last)
    if planes[0].device.type == "cpu":
        return tile_pass_plain(planes, log_t=log_t, k_first=k_first,
                               k_last=k_last, net_tile=net_tile, n_cmp=n_cmp)
    _require_cuda(planes)
    e, threads = tile_geometry(len(planes), log_t)
    phases = tile_phases(log_t, e, k_first, k_last)
    words = [x for kind, k, a, b in phases
             for x in (kind == "shared", k, a, b)]
    words = (ctypes.c_int * len(words))(*words)
    lib = build.library()
    ptrs = build.ptr_array(planes)
    with torch.cuda.device(planes[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rs_bitonic_tile(ctypes.cast(ptrs, ctypes.c_void_p),
                                  len(planes), 1 << logn, log_t, e, threads,
                                  ctypes.cast(words, ctypes.c_void_p),
                                  len(phases), net_tile, n_cmp,
                                  tile_smem_bytes(len(planes), log_t), stream)
    build.check(err, "bitonic tile_pass")
    TILE_LAUNCHES += 1
    return planes


def cross_pass(planes, *, k: int, lo: int, c: int, net_tile: int = 0,
               n_cmp: int = 1):
    """Strides 2^(lo+c-1)..2^lo of level k in one round trip through
    device memory; each thread holds the 2^c rows of every plane that
    those strides connect. In place; returns the planes."""
    global CROSS_LAUNCHES
    planes = list(planes)
    logn = _check(planes, n_cmp)
    _check_cross(logn, len(planes), k, lo, c)
    if planes[0].device.type == "cpu":
        return cross_pass_plain(planes, k=k, lo=lo, c=c, net_tile=net_tile,
                                n_cmp=n_cmp)
    _require_cuda(planes)
    lib = build.library()
    ptrs = build.ptr_array(planes)
    with torch.cuda.device(planes[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rs_bitonic_cross(ctypes.cast(ptrs, ctypes.c_void_p),
                                   len(planes), 1 << logn, k, lo, c,
                                   net_tile, n_cmp, stream)
    build.check(err, "bitonic cross_pass")
    CROSS_LAUNCHES += 1
    return planes


# ---------------------------------------------------------------------------
# the engine: passes planned onto the two kernels
# ---------------------------------------------------------------------------


SHUFFLE_STRIDES = 5  # strides 2^e..2^(e+4) pair the lanes of one warp


def tile_smem_bytes(n_planes: int, log_t: int) -> int:
    """Shared memory of one tile-kernel block, which the launch gives it
    (the kernel traps if it is short): every plane of the tile, with one
    word of padding per 32 rows (against bank conflicts)."""
    rows = 1 << log_t
    return 4 * n_planes * (rows + (rows >> 5))


def tile_log_rows(n_planes: int) -> int:
    """log2 of the rows of the tile kernel's tile: the most whose padded
    planes fit the shared memory of one of TILE_BLOCKS_PER_SM blocks on an
    SM, so one block's copies overlap another's compare-exchanges (1
    plane: 2^14 rows = 66 KB; 3: 2^13 = 99 KB)."""
    budget = config_lib.SMEM_BYTES // config_lib.TILE_BLOCKS_PER_SM
    log_t = 1
    while tile_smem_bytes(n_planes, log_t + 1) <= budget:
        log_t += 1
    return log_t


def tile_geometry(n_planes: int, log_t: int) -> tuple[int, int]:
    """(e, threads) of a tile-kernel launch: a thread holds E = 2^e rows of
    every plane in registers (the most with E * planes <= MAX_TILE_WORDS,
    and E <= 2^log_t), and a block has up to MAX_TILE_THREADS threads,
    each looping over 2^log_t / (E * threads) units of E rows."""
    e = min((config_lib.MAX_TILE_WORDS // n_planes).bit_length() - 1, log_t)
    return e, min(config_lib.MAX_TILE_THREADS, 1 << (log_t - e))


def tile_phases(log_t: int, e: int, k_first: int, k_last: int) -> list:
    """The tile kernel's schedule of levels k_first..k_last: its phases in
    order, one barrier before each. :func:`tile_pass` passes this list to
    the kernel, which runs it as given.

    ("shared", k, lo, c): strides 2^(lo+c-1)..2^lo of level k, all of
    2^(e+5) and more, c <= e; a unit gathers the 2^c rows they connect
    through shared memory.
    ("register", k, k_end, top): E = 2^e consecutive rows a unit, level k
    from stride 2^top down, then levels k+1..k_end whole; strides of 2^e
    and more pair lanes of one warp (shuffles), smaller ones registers of
    one thread. Every level after k whose strides stay below 2^(e+5)
    joins it."""
    big = e + SHUFFLE_STRIDES
    phases = []
    k = k_first
    while k <= k_last:
        hi = min(k, log_t) - 1
        while hi >= big:
            c = min(e, hi - big + 1)
            phases.append(("shared", k, hi - c + 1, c))
            hi -= c
        k_end = k
        while k_end < k_last and min(k_end + 1, log_t) <= big:
            k_end += 1
        phases.append(("register", k, k_end, hi))
        k = k_end + 1
    return phases


def cross_strides(n_planes: int) -> int:
    """Strides one cross pass runs: a thread holds 2^c rows of every plane,
    at most MAX_CROSS_WORDS words (2^6 x 1 plane .. 2^4 x 4 planes)."""
    return min(6, (config_lib.MAX_CROSS_WORDS // n_planes).bit_length() - 1)


def plan_passes(logn: int, k_first: int, n_planes: int, *,
                log_t: int | None = None, c_max: int | None = None) -> list:
    """The launches that run levels k_first..logn: ("tile", k_first, k_last,
    log_t) for levels whose strides all lie below the tile, then per level
    k its cross strides 2^(k-1)..2^log_t in spans of at most c, widest
    first (as the JAX engine's ``_plan_spans``): ("cross", k, lo, c), and
    ("tile", k, k, log_t) for its strides below the tile.

    log_t, c_max: a smaller geometry than :func:`tile_log_rows` /
    :func:`cross_strides` (more cross passes at a small logn)."""
    log_t = tile_log_rows(n_planes) if log_t is None else log_t
    c_max = cross_strides(n_planes) if c_max is None else c_max
    if log_t < 1 or tile_smem_bytes(n_planes, log_t) > config_lib.SMEM_BYTES:
        raise ValueError(f"log_t = {log_t}: {n_planes} plane(s) of 2^{log_t} "
                         f"rows exceed {config_lib.SMEM_BYTES} bytes of shared "
                         "memory")
    if not 1 <= c_max <= cross_strides(n_planes):
        raise ValueError(f"c_max = {c_max}: need 1 <= c <= 6 and 2^c * "
                         f"{n_planes} <= {config_lib.MAX_CROSS_WORDS}")
    log_t = min(log_t, logn)
    ops = []
    k = k_first
    if k <= log_t:
        ops.append(("tile", k, log_t, log_t))
        k = log_t + 1
    for k in range(k, logn + 1):
        j = k - 1
        while j >= log_t:
            c = min(c_max, j - log_t + 1)
            ops.append(("cross", k, j - c + 1, c))
            j -= c
        ops.append(("tile", k, k, log_t))
    return ops


def run_passes(planes, ops, net_tile: int, n_cmp: int):
    """Launch the passes of a :func:`plan_passes` plan, in order."""
    for op in ops:
        if op[0] == "tile":
            tile_pass(planes, log_t=op[3], k_first=op[1], k_last=op[2],
                      net_tile=net_tile, n_cmp=n_cmp)
        else:
            cross_pass(planes, k=op[1], lo=op[2], c=op[3], net_tile=net_tile,
                       n_cmp=n_cmp)
    return planes


def sort_planes_bitonic(planes, *, n_cmp: int = 1, log_tile: int = 16):
    """Ascending bitonic sort of 1-4 parallel (N,) torch.uint32 planes, N a
    power of two (callers pad with 0xFFFFFFFF rows), lexicographic on the
    first |n_cmp| planes, in place.

    n_cmp > 0: the compare planes must be a total order over rows (make
    the last one an index or a unique tag: the sort is then stable); on a
    full tie the ride planes of one row are duplicated and the other's lost.
    n_cmp < 0: tie-safe, tied rows never exchange (an unstable pairs sort).
    log_tile: the network's tile (JAX's ``log_tile``; see
    :func:`network_log_tile`). Returns the planes."""
    planes = list(planes)
    logn = _check(planes, n_cmp)
    if planes[0].device.type == "cpu":
        return sort_planes_bitonic_plain(planes, n_cmp=n_cmp,
                                         log_tile=log_tile)
    _require_cuda(planes)
    ops = plan_passes(logn, 1, len(planes))
    return run_passes(planes, ops, min(log_tile, logn), n_cmp)


def sort_bits_bitonic(bits: torch.Tensor, *, log_tile: int = 16):
    """Keys-only :func:`sort_planes_bitonic` of one u32 tensor, in place."""
    return sort_planes_bitonic([bits], n_cmp=1, log_tile=log_tile)[0]


def merge_sorted_planes_bitonic(planes, *, log_block: int, n_cmp: int = 1):
    """Merge the 2^(logn-log_block) sorted blocks of the planes, in place.

    Block b must already be sorted ascending when b is even and descending
    when odd (the bitonic invariant); levels log_block+1..logn of the
    network finish the sort. n_cmp as in :func:`sort_planes_bitonic`.
    Returns the planes."""
    planes = list(planes)
    logn = _check(planes, n_cmp)
    _check_block(logn, log_block)
    if planes[0].device.type == "cpu":
        return merge_sorted_planes_bitonic_plain(planes, log_block=log_block,
                                                 n_cmp=n_cmp)
    _require_cuda(planes)
    ops = plan_passes(logn, log_block + 1, len(planes))
    return run_passes(planes, ops, 0, n_cmp)
