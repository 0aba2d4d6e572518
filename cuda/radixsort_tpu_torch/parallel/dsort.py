"""Distributed sample sort over a device mesh.

Counterpart of ``cuda/radixsort_tpu/parallel/dsort.py``, SPMD on
``torch.distributed``: every rank calls the same function with its shard
(rows [d*s, (d+1)*s) of the input padded to s*ndev rows, s =
ceil(n / ndev)) and the global row count ``n``. A global splitter
histogram (psum) picks balanced key ranges, heavy hitters are spread
over the ranks their sorted positions span, one all-to-all over padded
lanes moves each key to its owner, and each owner sorts its range with
the port's own sort (the histogram and stage kernels). Rank d returns the
block the JAX function's device d holds: the d-th key range, ascending,
sentinel-padded, with the (ndev,) counts and ExchangeStats every rank
shares.

``rounds`` > 1 splits the exchange into that many sub-lane rounds: round
k+1's all-to-all is issued (asynchronously) before round k's chunk is
sorted, and the sorted chunks merge (``ops/merge.py``). A keys-only
ascending sort has one answer, so the bits match the JAX function's,
whose chunks run its bitonic network.

u32 bit patterns ride int32 views (CPU torch and the card's torch lack
most uint32 operators): the routing math shifts and masks int32 bits and
compares unsigned values as int32 with the sign bit flipped.
"""

from __future__ import annotations

import os

import torch

from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.histogram import (_KERNEL_MAX_BINS,
                                                    count_bins)
from cuda.radixsort_tpu_torch.ops.merge import merge_sorted
from cuda.radixsort_tpu_torch.ops.sort import sort, sort_pairs, sort_struct
from cuda.radixsort_tpu_torch.parallel import comm
from cuda.radixsort_tpu_torch.parallel import stats as stats_lib
from cuda.radixsort_tpu_torch.utils.profiling import traced

_SIGN = -(1 << 31)
_SENTINEL = -1  # 0xFFFFFFFF as int32 bits


def axis_size(mesh, axis_name) -> int:
    """Ranks along ``axis_name``: one mesh dimension ("x") or a tuple of
    them (("host", "chip")), linearised most significant first."""
    return comm.axis_size(mesh, axis_name)


def _u32(bits_i32: torch.Tensor) -> torch.Tensor:
    return bits_i32.view(torch.uint32)


def _i32(bits_u32: torch.Tensor) -> torch.Tensor:
    return bits_u32.view(torch.int32)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of u32 bits held in int32 (s in 1..31)."""
    return (x >> s) & ((1 << (32 - s)) - 1)


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int32 whose signed order is the bits' unsigned order."""
    return x ^ _SIGN


def _bits_of(keys: torch.Tensor, descending: bool = False) -> torch.Tensor:
    """Twiddled key bits as u32 (``twiddle_in(...).astype(uint32)``):
    narrower keys zero-extend, 64-bit keys keep their low 32 bits."""
    b = twiddle.twiddle_in(keys, descending=descending)
    width = twiddle.bit_width(keys.dtype)
    if width == 32:
        return b
    v = twiddle.signed_view(b)
    if width < 32:
        v = v.to(torch.int32) & ((1 << width) - 1)
    else:
        v = v.view(torch.int32).reshape(-1, 2)[:, 0].contiguous()
    return v.view(torch.uint32)


def _splitter_owner(gh: torch.Tensor, ndev: int) -> torch.Tensor:
    """Owner rank of each of the B splitter buckets, balancing counts: the
    rank owning the bucket's mass midpoint (non-decreasing)."""
    total = torch.clamp_min(gh.sum(), 1)
    cum = torch.cumsum(gh, 0) - gh // 2
    return _dev_of(cum, _dev_boundaries(total, ndev))


def _dev_boundaries(total, ndev: int) -> torch.Tensor:
    """Sorted-position boundaries of the rank ranges: rank k owns
    positions [ceil(k*total/ndev), ceil((k+1)*total/ndev)), computed
    without the k*total product."""
    k = torch.arange(1, ndev, dtype=torch.int64, device=total.device)
    q, r = total // ndev, total % ndev
    return k * q + (k * r + ndev - 1) // ndev


def _dev_of(pos: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Rank owning sorted position pos = #boundaries <= pos."""
    d = torch.zeros(pos.shape, dtype=torch.int64, device=pos.device)
    for k in range(bounds.shape[0]):
        d = d + (pos >= bounds[k]).to(torch.int64)
    return d


# Two routing counts put most rows into a few of their bins: the splitter
# histogram when the keys crowd into one bucket, and a quantile level,
# whose rows off every target go to its spare bin. Above 255 bins
# count_bins is one index_add_, whose atomics on one address serialise;
# these two count into copies of the bins instead, the row's position
# picking the copy, and sum the copies (exact either way).
_CROWD_COPIES = 256
_CROWD_WORDS = 1 << 22  # counters in all, at most


def _count_crowded(idx: torch.Tensor, nbins: int) -> torch.Tensor:
    """count_bins(idx, nbins) for indices that crowd into few bins."""
    copies = min(_CROWD_COPIES, _CROWD_WORDS // (nbins + 1))
    if nbins <= _KERNEL_MAX_BINS or copies <= 1:
        return count_bins(idx, nbins)
    n, dev = idx.numel(), idx.device
    flat = (idx.reshape(-1).to(torch.int64)
            + (torch.arange(n, device=dev) % copies) * (nbins + 1))
    out = torch.zeros(copies * (nbins + 1), dtype=torch.int32, device=dev)
    out.index_add_(0, flat, torch.ones(n, dtype=torch.int32, device=dev))
    return out.view(copies, nbins + 1).sum(0, dtype=torch.int32)[:nbins]


def _dest_order(dest: torch.Tensor, ndev: int):
    """(order, counts): the stable permutation grouping rows by dest in
    [0, ndev] (ndev = dropped, sorted last) and the (ndev,) int32 rows per
    destination. One counting pass of the stage kernel over dest's low
    bits; the counts are one histogram."""
    n = dest.shape[0]
    d = dest.to(torch.int32)
    pos = torch.arange(n, dtype=torch.int32, device=dest.device)
    _, order = sort_pairs(d.view(torch.uint32), pos, begin_bit=0,
                          end_bit=max(ndev.bit_length(), 1))
    return order.long(), count_bins(d, ndev)


def _lanes(counts: torch.Tensor, ndev: int, cap: int, s: int):
    """(gather index (ndev*cap,), valid (ndev*cap,)): lane j of the padded
    send buffer takes rows [seg_start[j], seg_start[j] + counts[j]) of the
    dest-grouped rows."""
    c = counts.to(torch.int64)
    seg = torch.cumsum(c, 0) - c
    ar = torch.arange(cap, dtype=torch.int64, device=counts.device)
    idx = seg[:, None] + ar[None, :]
    valid = ar[None, :] < c[:, None]
    return torch.clamp(idx, 0, max(s - 1, 0)).reshape(-1), valid.reshape(-1)


def _make_padded_send(bits, dest, ndev: int, cap: int, sentinel=_SENTINEL):
    """Group local rows by destination into a dense (ndev, cap) buffer of
    u32 bits (lane order = row order within a destination; rows with dest
    == ndev are never picked up; empty slots hold ``sentinel``, a u32
    value or its int32 bits). Returns (send, counts)."""
    order, counts = _dest_order(dest, ndev)
    idx, valid = _lanes(counts, ndev, cap, bits.shape[0])
    fill = int(sentinel) & 0xFFFFFFFF
    fill = fill - (1 << 32) if fill >= 1 << 31 else fill
    send = torch.where(valid, _i32(bits)[order[idx]], fill)
    return _u32(send).reshape(ndev, cap), counts


# Heavy hitters: a key whose mass exceeds ~total/ndev cannot be balanced at
# bucket granularity. Equal keys are interchangeable in a keys-only sort, so
# its rows are dealt over the rank span its sorted positions cover. Every
# rank takes a strided sample, the all-gathered sample's top _HEAVY_SLOTS
# modes become candidates, and those are counted exactly (with their global
# sorted position p0 = psum of #keys < candidate). A candidate above
# total / (2*ndev) spreads: its rows go to the rank owning their own sorted
# slot, and the other rows of its splitter bucket to the rank of their gap
# interval's midpoint, so the bucket's order stays rank-monotone.
_HEAVY_SLOTS = 4
_SAMPLE_PER_DEV = 256


def _top_runs(runlen: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest run lengths, ties to the lower index
    (``lax.top_k``'s order)."""
    return torch.sort(-runlen, stable=True).indices[:k]


def _route_plan(bits, valid, axis_name, ndev: int, sb: int,
                spread_heavy: bool = True, *, mesh):
    """Splitter histogram -> owner -> per-key destination.

    bits: (S,) u32 twiddled key bits; valid: (S,) bool (False rows are
    padding: routed to dest == ndev and dropped by the exchange). Returns
    dest (S,) int64 in [0, ndev]."""
    ax = comm.Axis(mesh, axis_name)
    nb = 1 << sb
    s = bits.shape[0]
    dev = bits.device
    b = _i32(bits)
    top = _shr(b, 32 - sb).to(torch.int64)
    lh = _count_crowded(torch.where(valid, top, nb), nb)
    gh = comm.psum(lh, ax).to(torch.int64)
    owner = _splitter_owner(gh, ndev)
    dest = owner[top]

    if spread_heavy and ndev > 1:
        total = torch.clamp_min(gh.sum(), 1)
        bounds = _dev_boundaries(total, ndev)
        cumb = torch.cumsum(gh, 0) - gh

        # candidate discovery: the same global sample on every rank
        ks = min(_SAMPLE_PER_DEV, s)
        stride_idx = (torch.arange(ks, dtype=torch.int64, device=dev)
                      * s) // ks
        # invalid rows sample as 0 (harmless: candidates are re-counted)
        samp = torch.where(valid[stride_idx], b[stride_idx], 0)
        gsamp = comm.all_gather(samp, ax, tiled=True)
        ssamp = torch.sort(gsamp.to(torch.int64) & 0xFFFFFFFF).values
        m = ssamp.shape[0]
        run_start = torch.ones(m, dtype=torch.bool, device=dev)
        run_start[1:] = ssamp[1:] != ssamp[:-1]
        pos = torch.arange(m, dtype=torch.int64, device=dev)
        # run length at each start = next run start - own position
        rev = torch.flip(torch.where(run_start, pos, m), [0])
        nxt = torch.flip(torch.cummin(torch.cat(
            [torch.full((1,), m, dtype=torch.int64, device=dev), rev[:-1]]),
            0).values, [0])
        runlen = torch.where(run_start, nxt - pos, 0)
        cands = ssamp[_top_runs(runlen, _HEAVY_SLOTS)]   # (H,) u32 values
        co = (cands - (1 << 31)).to(torch.int32)        # as _ordered bits
        o = _ordered(b)

        # exact global count and sorted position of each candidate
        eq = [valid & (o == co[i]) for i in range(_HEAVY_SLOTS)]
        lt = [valid & (o < co[i]) for i in range(_HEAVY_SLOTS)]
        lstats = torch.stack([m_.sum(dtype=torch.int32) for m_ in eq + lt])
        # the gather spans every rank of the axis, which may be more than
        # ndev (the hierarchical sort routes to hosts, gathers over all)
        allc = comm.all_gather(lstats, ax).to(torch.int64)
        my = ax.index
        myoff = allc[:my].sum(0)[:_HEAVY_SLOTS]
        gstat = allc.sum(0)
        gcnt = gstat[:_HEAVY_SLOTS]
        gp0 = gstat[_HEAVY_SLOTS:]
        heavy = gcnt > (total // (2 * ndev))
        # a key sampled into two slots spreads once
        for i in range(_HEAVY_SLOTS):
            for j in range(i):
                heavy[i] = heavy[i] & (cands[i] != cands[j])

        cbkt = cands >> (32 - sb)
        # gap interval of every row in a heavy bucket: the whole bucket,
        # shrunk past each heavy candidate in the same bucket
        in_heavy_bkt = torch.zeros(s, dtype=torch.bool, device=dev)
        lo = cumb[top]
        hi = lo + gh[top]
        for i in range(_HEAVY_SLOTS):
            inb = heavy[i] & (top == cbkt[i])
            in_heavy_bkt = in_heavy_bkt | inb
            lo = torch.where(inb & (o > co[i]),
                             torch.maximum(lo, gp0[i] + gcnt[i]), lo)
            hi = torch.where(inb & (o < co[i]), torch.minimum(hi, gp0[i]), hi)
        # rows of one gap share (lo, hi), so one rank; the candidates' own
        # rows are overwritten below
        dest = torch.where(in_heavy_bkt, _dev_of(lo + (hi - lo) // 2, bounds),
                           dest)
        for i in range(_HEAVY_SLOTS):
            rank = torch.cumsum(eq[i].to(torch.int64), 0) - 1 + myoff[i]
            dest = torch.where(heavy[i] & eq[i],
                               _dev_of(gp0[i] + rank, bounds), dest)

    return torch.where(valid, dest, ndev)


def _default_splitter_bits(ndev: int) -> int:
    return min(16, max(8, (ndev - 1).bit_length() + 6))


def _shard_rows(keys: torch.Tensor, n, ndev: int):
    """(n, s) of a shard: s its row count, n the global row count (default
    s * ndev). Every rank must hold s = ceil(n / ndev) rows."""
    s = keys.shape[0]
    n = s * ndev if n is None else int(n)
    if s != -(-n // ndev):
        raise ValueError(f"a shard of {n} rows over {ndev} ranks has "
                         f"{-(-n // ndev)} rows; got {s}")
    return n, s


def _shard_valid(n: int, s: int, axis_name, *, mesh,
                 device=None) -> torch.Tensor:
    """Positional validity of this rank's rows: the padded global array
    has real rows [0, n); shard d holds rows [d*s, (d+1)*s)."""
    d = comm.axis_index(mesh, axis_name)
    return d * s + torch.arange(s, dtype=torch.int64, device=device) < n


def _padded_bits(keys, n, ndev, axis_name, descending, fill, *, mesh):
    """(bits, valid, n, s): the shard's twiddled bits with its padding rows
    set to ``fill`` (int32 bits), as the JAX function pads them."""
    n, s = _shard_rows(keys, n, ndev)
    valid = _shard_valid(n, s, axis_name, mesh=mesh, device=keys.device)
    bits = torch.where(valid, _i32(_bits_of(keys, descending)), fill)
    return _u32(bits), valid, n, s


def exchange_cap_for_sort(keys: torch.Tensor, *, mesh, axis_name="x",
                          descending: bool = False,
                          splitter_bits: int | None = None,
                          n: int | None = None) -> torch.Tensor:
    """Phase one of the sized exchange: the exact max (src, dst) lane
    occupancy of a sort_distributed of these keys (0-d int32, equal on
    every rank). Histogram only: no sort, two small collectives."""
    ndev = axis_size(mesh, axis_name)
    bits, valid, n, s = _padded_bits(keys, n, ndev, axis_name, descending,
                                     _SENTINEL, mesh=mesh)
    sb = splitter_bits or _default_splitter_bits(ndev)
    dest = _route_plan(bits, valid, axis_name, ndev, sb, mesh=mesh)
    counts = count_bins(dest, ndev)
    return comm.pmax(counts.max(), comm.Axis(mesh, axis_name))


def round_cap(c: int, quantum: int = 128) -> int:
    """Round a measured cap up to a power of two (>= quantum)."""
    c = max(int(c), quantum)
    return 1 << (c - 1).bit_length()


@traced
def sort_distributed_sized(keys: torch.Tensor, *, mesh, axis_name="x",
                           descending: bool = False, n: int | None = None):
    """Two-phase sized distributed sort: measure the exchange, then run
    sort_distributed with the tight cap. Returns (padded_sorted,
    valid_counts, cap, stats)."""
    cap = round_cap(int(exchange_cap_for_sort(
        keys, mesh=mesh, axis_name=axis_name, descending=descending, n=n)))
    out, counts, st = sort_distributed(keys, mesh=mesh, axis_name=axis_name,
                                       cap=cap, descending=descending, n=n)
    return out, counts, cap, st


def resolve_rounds(cap_rows: int, bytes_per_row: int = 4) -> int:
    """Default exchange round count: 2 (round k+1's all-to-all overlaps
    round k's chunk sort) once a send lane exceeds ~4 MB, else 1.
    RS_EXCHANGE_ROUNDS forces a value; RS_EXCHANGE_ROUNDS_LANE_BYTES moves
    the threshold."""
    ov = os.environ.get("RS_EXCHANGE_ROUNDS")
    if ov:
        return int(ov)
    threshold = int(os.environ.get("RS_EXCHANGE_ROUNDS_LANE_BYTES",
                                   4 * 1024 * 1024))
    return 2 if cap_rows * bytes_per_row > threshold else 1


def _merge_chunks(chunks):
    """Merge sorted u32 chunks into one ascending array, pairwise."""
    while len(chunks) > 1:
        chunks = [merge_sorted(chunks[i], chunks[i + 1])
                  if i + 1 < len(chunks) else chunks[i]
                  for i in range(0, len(chunks), 2)]
    return chunks[0]


def sort_sharded_bits(bits, axis_name, ndev: int, cap: int | None = None,
                      splitter_bits: int | None = None, valid=None,
                      rounds: int | None = None, *, mesh):
    """Distributed ascending sort of twiddled u32 key bits, one shard per
    rank.

    valid: optional (S,) bool marking real rows (padding is dropped from
    the exchange: validity is explicit, never read from a key's value, so
    keys equal to 0xFFFFFFFF survive). Returns (out_padded (ndev*cap,) or
    (rounds * chunk,), valid_count 0-d, send counts (ndev,)): rank d holds
    the d-th globally sorted key range, pad-filled at the tail."""
    ax = comm.Axis(mesh, axis_name)
    s = bits.shape[0]
    dev = bits.device
    cap = s if cap is None else cap
    if rounds is None:
        rounds = resolve_rounds(cap)
    sb = splitter_bits or _default_splitter_bits(ndev)
    if valid is None:
        valid = torch.ones(s, dtype=torch.bool, device=dev)

    dest = _route_plan(bits, valid, axis_name, ndev, sb, mesh=mesh)
    if rounds > 1:
        if rounds & (rounds - 1):
            raise ValueError("rounds must be a power of two")
        cap_r = -(-cap // rounds)
        cap = cap_r * rounds
    send, counts = _make_padded_send(bits, dest, ndev, cap, _SENTINEL)
    # rows source i actually sent here ride a small all-to-all
    recv_counts = comm.all_to_all(counts, ax)
    valid_count = recv_counts.sum(dtype=torch.int32)

    if rounds == 1:
        recv = comm.all_to_all(send, ax)
        return sort(recv.reshape(-1)), valid_count, counts

    # round-based exchange: chunks padded to a power of two, as the JAX
    # function's bitonic merge tail needs (the output keeps its length)
    cl = 1 << max((ndev * cap_r - 1).bit_length(), 10)

    def issue(r):
        sub = send[:, r * cap_r:(r + 1) * cap_r].contiguous()
        return comm.all_to_all(sub, ax, async_op=True)

    def chunk(wait):
        recv = wait().reshape(-1)
        if cl != recv.shape[0]:
            recv = _u32(torch.cat([_i32(recv), torch.full(
                (cl - recv.shape[0],), _SENTINEL, dtype=torch.int32,
                device=dev)]))
        return sort(recv)

    chunks = []
    prev = issue(0)
    for r in range(1, rounds):
        nxt = issue(r)  # issued before the previous round's sort
        chunks.append(chunk(prev))
        prev = nxt
    chunks.append(chunk(prev))
    return _merge_chunks(chunks), valid_count, counts


def make_mesh(n: int | None = None, axis: str = "x", device: str = "cuda"):
    """A 1-D DeviceMesh of n ranks (default: the world) named ``axis``,
    over the initialised process group: NCCL for the card, gloo for
    ``device="cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not torch.distributed.is_initialized():
        raise RuntimeError("initialise torch.distributed first "
                           "(init_process_group)")
    n = n or torch.distributed.get_world_size()
    return init_device_mesh(device, (n,), mesh_dim_names=(axis,))


def _gather_counts(c, mesh, axis_name) -> torch.Tensor:
    """The (ndev,) int32 per-rank counts, equal on every rank."""
    return comm.all_gather(c.reshape(1).to(torch.int32),
                           comm.Axis(mesh, axis_name), tiled=True)


@traced
def sort_distributed(keys: torch.Tensor, *, mesh, axis_name="x",
                     cap: int | None = None, descending: bool = False,
                     rounds: int | None = None, n: int | None = None):
    """Globally sort a sharded key array. Returns (padded_sorted,
    valid_counts, exchange_stats): this rank's block of twiddled u32 bits
    (its key range, ascending, sentinel-padded), the (ndev,) int32 counts
    of real keys per rank, and the global ExchangeStats.
    :func:`reconstruct_sorted` of every rank's block is the sorted array."""
    ndev = axis_size(mesh, axis_name)
    bits, valid, n, s = _padded_bits(keys, n, ndev, axis_name, descending,
                                     _SENTINEL, mesh=mesh)
    ccap = cap or s
    out, vcount, send_counts = sort_sharded_bits(
        bits, axis_name, ndev, cap=ccap, valid=valid, rounds=rounds,
        mesh=mesh)
    st = stats_lib.shard_stats(send_counts, vcount, ccap, ndev, axis_name,
                               bytes_per_row=4, mesh=mesh)
    return (out, _gather_counts(vcount, mesh, axis_name),
            stats_lib.gather(st, mesh=mesh, axis_name=axis_name))


@traced
def sort_pairs_distributed(keys: torch.Tensor, values: torch.Tensor, *,
                           mesh, axis_name="x", cap: int | None = None,
                           descending: bool = False, n: int | None = None):
    """Globally stable key-value sort over the mesh. Returns (keys_padded,
    values_padded, valid_counts, stats): rank d holds the d-th key range;
    rows beyond counts[d] of its block are padding.

    Stability across ranks: the exchange keeps (source rank, position)
    order per destination, heavy-key spreading deals ascending global
    ranks to ascending ranks, and the local sort orders by (validity,
    key) stably, so equal keys keep their global input order."""
    from cuda.radixsort_tpu_torch.parallel.shuffle import exchange_rows

    ndev = axis_size(mesh, axis_name)
    ax = comm.Axis(mesh, axis_name)
    bits, valid, n, s = _padded_bits(keys, n, ndev, axis_name, descending,
                                     _SENTINEL, mesh=mesh)
    values = twiddle.where(valid, values, torch.zeros(
        (), dtype=values.dtype, device=values.device))
    ccap = cap or s
    dest = _route_plan(bits, valid, axis_name, ndev,
                       _default_splitter_bits(ndev), mesh=mesh)
    (rb, rv), rvalid = exchange_rows([bits, values], dest, ndev, axis_name,
                                     ccap, mesh=mesh)
    counts = count_bins(dest, ndev)
    vcount = comm.all_to_all(counts, ax).sum(dtype=torch.int32)
    # stable local sort: invalid rows sink through a leading 0/1 limb
    inv = (~rvalid).to(torch.int32).view(torch.uint32)
    (_, sbits), sv = sort_struct((inv, rb), rv)
    st = stats_lib.shard_stats(counts, vcount, ccap, ndev, axis_name,
                               bytes_per_row=4 + values.dtype.itemsize,
                               mesh=mesh)
    out_keys = _keys_of_bits(sbits, keys.dtype, descending)
    return (out_keys, sv, _gather_counts(vcount, mesh, axis_name),
            stats_lib.gather(st, mesh=mesh, axis_name=axis_name))


def _keys_of_bits(bits: torch.Tensor, dtype, descending: bool):
    """twiddle_out of u32 bits for keys of up to 32 bits."""
    width = twiddle.bit_width(dtype)
    if width < 32:
        bits = _i32(bits).to(twiddle.signed_dtype(dtype)).view(
            twiddle.unsigned_dtype(dtype))
    return twiddle.twiddle_out(bits, dtype, descending=descending)


def make_mesh_2d(hosts: int, chips: int, host_axis: str = "host",
                 chip_axis: str = "chip", device: str = "cuda"):
    """(hosts x chips) DeviceMesh: the outer dimension the slower links."""
    from torch.distributed.device_mesh import init_device_mesh

    if not torch.distributed.is_initialized():
        raise RuntimeError("initialise torch.distributed first "
                           "(init_process_group)")
    return init_device_mesh(device, (hosts, chips),
                            mesh_dim_names=(host_axis, chip_axis))


@traced
def sort_distributed_hier(keys: torch.Tensor, *, mesh, host_axis="host",
                          chip_axis="chip", host_cap: int | None = None,
                          chip_cap: int | None = None,
                          descending: bool = False, n: int | None = None):
    """Hierarchical distributed sort over a (host x chip) mesh: keys cross
    the host links once, in host-aggregated lanes, then the chip links
    once.

    Stage 1 routes every key to its owner host (splitters from the global
    histogram at host granularity; the all-to-all runs over the host
    dimension only). Stage 2 is the chip-dimension sort of the host's key
    range. Rank (h, c) holds the c-th chip range of the h-th host range:
    the layout of ``sort_distributed`` over the tuple axis. Returns
    (padded_sorted, valid_counts, (host_stats, chip_stats))."""
    both = (host_axis, chip_axis)
    hax = comm.Axis(mesh, host_axis)
    nh = hax.size
    nc = axis_size(mesh, chip_axis)
    ndev = nh * nc
    bits, valid, n, s = _padded_bits(keys, n, ndev, both, descending,
                                     _SENTINEL, mesh=mesh)
    hcap = host_cap or s
    dest_h = _route_plan(bits, valid, both, nh, _default_splitter_bits(nh),
                         mesh=mesh)
    send, counts_h = _make_padded_send(bits, dest_h, nh, hcap, _SENTINEL)
    recv_counts = comm.all_to_all(counts_h, hax)
    recv = comm.all_to_all(send, hax).reshape(-1)
    ar = torch.arange(hcap, dtype=torch.int32, device=bits.device)
    rvalid = (ar[None, :] < recv_counts[:, None]).reshape(-1)
    st1 = stats_lib.shard_stats(counts_h, recv_counts.sum(), hcap, nh, both,
                                bytes_per_row=4, skew_ndev=ndev, mesh=mesh)
    out, vcount, counts_c = sort_sharded_bits(recv, chip_axis, nc,
                                              cap=chip_cap, valid=rvalid,
                                              mesh=mesh)
    st2 = stats_lib.shard_stats(counts_c, vcount, chip_cap or nh * hcap, nc,
                                both, bytes_per_row=4, skew_ndev=ndev,
                                mesh=mesh)
    return (out, _gather_counts(vcount, mesh, both),
            (stats_lib.gather(st1, mesh=mesh, axis_name=both),
             stats_lib.gather(st2, mesh=mesh, axis_name=both)))


def reconstruct_sorted(out, counts, dtype, n, descending: bool = False):
    """Host-side helper: the sorted (n,) numpy array from every rank's
    block (a list of u32 tensors or arrays, in rank order) and the (ndev,)
    counts: trims each block's padding and undoes the twiddle."""
    from cuda.radixsort_tpu_torch.utils.convert import from_numpy, to_numpy

    blocks = [o.detach().cpu() if isinstance(o, torch.Tensor)
              else from_numpy(o, "cpu") for o in out]
    bits = twiddle.cat([b[:int(c)] for b, c in zip(blocks, counts)])[:n]
    return to_numpy(_keys_of_bits(bits, dtype, descending))
