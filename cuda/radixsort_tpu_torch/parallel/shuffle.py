"""Distributed all-to-all shuffle, group-by and joins.

Counterpart of ``cuda/radixsort_tpu/parallel/shuffle.py``, SPMD on
``torch.distributed``. Rows move to owner ranks by bucket id (a key hash)
through one padded all-to-all per column, with the counts beside them.
Skew, per operator:

  * group-by: local partial aggregation before the exchange, so a heavy
    key collapses to one partial row per rank;
  * join: a small build side is broadcast (the probe never moves), a large
    one hash-exchanges both sides.

The probe and group-by inputs are sharded as ``dsort`` describes (rank d
holds rows [d*s, (d+1)*s) of the input padded to s*ndev, with the global
row count ``n``); a join's build side is the whole build table, the same
on every rank. Rank d returns the block the JAX function's device d
holds, with the (ndev,) counts and the ExchangeStats every rank shares.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.aggregate import groupby as local_groupby
from cuda.radixsort_tpu_torch.ops.histogram import count_bins
from cuda.radixsort_tpu_torch.ops.join import join as local_join
from cuda.radixsort_tpu_torch.ops.partition import _mix, _u32_bits, hash32
from cuda.radixsort_tpu_torch.ops.scan import _full
from cuda.radixsort_tpu_torch.parallel import comm
from cuda.radixsort_tpu_torch.parallel import stats as stats_lib
from cuda.radixsort_tpu_torch.parallel.dsort import (_dest_order, _lanes,
                                                      _gather_counts,
                                                      _shard_rows,
                                                      _shard_valid,
                                                      axis_size, round_cap)
from cuda.radixsort_tpu_torch.utils.profiling import traced


# a join's build side of at most this many rows is broadcast (probed on
# every rank), a larger one hash-exchanged: the one threshold
# join_distributed, filter_sort_join_distributed's "auto" and a plan's
# distributed joins route on
JOIN_BROADCAST_ROWS = 1 << 20


@traced
def exchange_rows(columns, dest, ndev: int, axis_name, cap: int, *, mesh):
    """Route each local row to rank dest[row]. columns: list of (S,)
    tensors.

    Returns (received_columns, valid_mask): each (ndev*cap,), rows from
    source rank i in slice [i*cap, (i+1)*cap), valid_mask marking real
    rows. Rows keep (source rank, original order).

    cap must cover every send lane. If any source's count for one
    destination exceeds cap, the overflow is loud, not a silent row drop:
    the received validity is all False on every rank (one psum), and
    ExchangeStats reports util > 1.0."""
    ax = comm.Axis(mesh, axis_name)
    s = dest.shape[0]
    d = dest.to(torch.int64)
    d = torch.where((d < 0) | (d > ndev), ndev, d)  # out of range: dropped
    order, counts = _dest_order(d, ndev)
    idx, valid = _lanes(counts, ndev, cap, s)
    rows = torch.where(valid, order[idx], 0)
    over_any = comm.psum((counts.max() > cap).to(torch.int32), ax) > 0
    recv_valid = comm.all_to_all(valid, ax) & ~over_any
    out = []
    for c in columns:
        send = twiddle.where(valid, twiddle.take(c, rows),
                             torch.zeros((), dtype=c.dtype, device=c.device))
        out.append(comm.all_to_all(send, ax))
    return out, recv_valid


def _umod(h: torch.Tensor, ndev: int) -> torch.Tensor:
    """u32 bits (int32) modulo ndev, as int64."""
    return (h.to(torch.int64) & 0xFFFFFFFF) % ndev


def _owner_of_keys(keys, ndev: int):
    return _umod(hash32(keys).view(torch.int32), ndev)


def _owner_of_key_tuple(cols, ndev: int):
    """Hash owner of a composite key: xor-chain the per-column mixes. Every
    distributed operator that localises by key tuple routes through this
    one definition, so rows of one group land on one rank."""
    cols = list(cols)
    h = hash32(cols[0]).view(torch.int32)
    for c in cols[1:]:
        h = _mix(_u32_bits(c) ^ h)
    return _umod(h, ndev)


def _agg_identity(agg: str, dtype, device):
    """Neutral element of the aggregation (0-d): rows carrying it never
    change a group's result, which neutralises padding rows."""
    if agg not in ("min", "max"):
        return torch.zeros((), dtype=dtype, device=device)
    if dtype.is_floating_point:
        v = float("inf") if agg == "min" else float("-inf")
    elif dtype in twiddle.PARTIAL:  # unsigned: [0, 2^w - 1]
        v = (1 << twiddle.bit_width(dtype)) - 1 if agg == "min" else 0
    else:
        info = torch.iinfo(dtype)
        v = info.max if agg == "min" else info.min
    return _full((), v, dtype, device)


def _first_key(keys, mesh, axis_name):
    """The global array's first row (rank 0's first row), on every rank."""
    return comm.all_gather(keys[:1], comm.Axis(mesh, axis_name),
                           tiled=True)[0]


def _groupby_inputs(keys, values, agg, n, ndev, axis_name, mesh):
    """(keys, values, agg, n, s) with count turned into a sum of ones and
    the padding rows set to (the global first key, the identity): they
    merge into a real group and change nothing."""
    n, s = _shard_rows(keys, n, ndev)
    if n == 0:
        raise ValueError("groupby_distributed needs at least one row")
    if agg == "count":
        values = torch.ones(s, dtype=torch.int32, device=keys.device)
        agg = "sum"
    if s * ndev != n:
        valid = _shard_valid(n, s, axis_name, mesh=mesh, device=keys.device)
        keys = twiddle.where(valid, keys,
                             _first_key(keys, mesh, axis_name).expand(s))
        values = twiddle.where(valid, values,
                               _agg_identity(agg, values.dtype, values.device))
    return keys, values, agg, n, s


@traced
def groupby_distributed(keys: torch.Tensor, values: torch.Tensor, *, mesh,
                        axis_name="x", agg: str = "sum",
                        cap: int | None = None,
                        config: config_lib.SortConfig | None = None,
                        n: int | None = None):
    """Distributed group-by over sharded rows, two-phase: local partial
    aggregate -> hash exchange of the partials -> local final aggregate.

    Returns (group_keys, aggregates, counts, stats): rank d holds the
    groups whose key hash routes to d, rows [0, counts[d]) of its block
    valid; group keys come back as u32 (the partials travel so).
    stats.rows_in counts the partial rows entering the exchange."""
    if agg not in ("sum", "count", "min", "max"):
        raise ValueError(agg)
    ndev = axis_size(mesh, axis_name)
    keys, values, agg, n, s = _groupby_inputs(keys, values, agg, n, ndev,
                                              axis_name, mesh)
    ident = _agg_identity(agg, values.dtype, values.device)
    ccap = cap or s
    gk, gv, cnt = local_groupby(keys, values, agg=agg, config=config)
    valid0 = torch.arange(gk.shape[0], device=gk.device) < cnt
    dest = torch.where(valid0, _owner_of_keys(gk, ndev), ndev)
    (rk, rv), rvalid = exchange_rows([gk, gv], dest, ndev, axis_name, ccap,
                                     mesh=mesh)
    # phase two: invalid fill rows get (max key, identity): they group last
    # and add nothing. A real key 0xFFFFFFFF shares their group; it is
    # dropped only when it holds no real max-key row.
    rku = _u32_bits(rk)
    k2 = torch.where(rvalid, rku, -1).view(torch.uint32)
    rv = twiddle.where(rvalid, rv, ident)
    g2k, g2v, c2 = local_groupby(k2, rv, agg=agg, config=config)
    has_invalid = (~rvalid).any()
    has_real_max = (rvalid & (rku == -1)).any()
    c2 = c2 - (has_invalid & ~has_real_max).to(torch.int32)
    send_counts = count_bins(dest, ndev)
    st = stats_lib.shard_stats(send_counts, c2, ccap, ndev, axis_name,
                               bytes_per_row=4 + values.dtype.itemsize,
                               mesh=mesh)
    return (g2k, g2v, _gather_counts(c2, mesh, axis_name),
            stats_lib.gather(st, mesh=mesh, axis_name=axis_name))


def groupby_exchange_cap(keys: torch.Tensor, values: torch.Tensor, *, mesh,
                         axis_name="x", agg: str = "sum",
                         config: config_lib.SortConfig | None = None,
                         n: int | None = None) -> torch.Tensor:
    """Phase one of the sized group-by exchange: the exact max number of
    partial rows any rank sends to any other (0-d, equal on every rank)."""
    ndev = axis_size(mesh, axis_name)
    keys, values, agg, n, s = _groupby_inputs(keys, values, agg, n, ndev,
                                              axis_name, mesh)
    gk, _, cnt = local_groupby(keys, values, agg=agg, config=config)
    valid0 = torch.arange(gk.shape[0], device=gk.device) < cnt
    dest = torch.where(valid0, _owner_of_keys(gk, ndev), ndev)
    return comm.pmax(count_bins(dest, ndev).max(),
                     comm.Axis(mesh, axis_name))


@traced
def groupby_distributed_sized(keys: torch.Tensor, values: torch.Tensor, *,
                              mesh, axis_name="x", agg: str = "sum",
                              config: config_lib.SortConfig | None = None,
                              n: int | None = None):
    """Two-phase sized distributed group-by: measure the partials
    exchange, then run groupby_distributed with the tight cap (a power of
    two). Returns (group_keys, aggregates, counts, cap, stats)."""
    cap = round_cap(int(groupby_exchange_cap(
        keys, values, mesh=mesh, axis_name=axis_name, agg=agg,
        config=config, n=n)))
    gk, gv, cnt, st = groupby_distributed(
        keys, values, mesh=mesh, axis_name=axis_name, agg=agg, cap=cap,
        config=config, n=n)
    return gk, gv, cnt, cap, st


def _pad_to(x: torch.Tensor, size: int, fill=0) -> torch.Tensor:
    pad = size - x.shape[0]
    if pad == 0:
        return x
    return twiddle.cat([x, _full((pad,), fill, x.dtype, x.device)])


def _build_shard(build_keys, build_vals, ndev, d):
    """(keys, vals, nb, sb) of rank d's block of the replicated build side
    padded to sb*ndev rows (sb = ceil(nb / ndev))."""
    nb = build_keys.shape[0]
    sb = -(-nb // ndev)
    bk = _pad_to(build_keys, sb * ndev)[d * sb:(d + 1) * sb]
    bv = _pad_to(build_vals, sb * ndev)[d * sb:(d + 1) * sb]
    return bk, bv, nb, sb


@traced
def join_distributed_broadcast(build_keys: torch.Tensor,
                               build_vals: torch.Tensor,
                               probe_keys: torch.Tensor, *, mesh,
                               axis_name="x",
                               config: config_lib.SortConfig | None = None,
                               n: int | None = None):
    """FK inner join with a broadcast build side: every rank joins its
    probe shard against the whole (replicated) build table; the probe
    never moves. ``n``: the global probe row count.

    Returns (keys, vals, probe_idx (global probe row), counts, stats)."""
    ndev = axis_size(mesh, axis_name)
    d = comm.axis_index(mesh, axis_name)
    npr, sp = _shard_rows(probe_keys, n, ndev)
    nb = build_keys.shape[0]
    sb = -(-nb // ndev)
    dev = probe_keys.device
    bk_full = _pad_to(build_keys, sb * ndev)
    bv_full = _pad_to(build_vals, sb * ndev)
    bvalid = torch.arange(sb * ndev, device=dev) < nb
    pvalid = _shard_valid(npr, sp, axis_name, mesh=mesh, device=dev)
    ok, ov, oi, cnt = local_join(bk_full, bv_full, probe_keys, how="inner",
                                 build_valid=bvalid, probe_valid=pvalid,
                                 config=config)
    og = d * sp + oi  # local -> global probe row
    # wire cost of a broadcast: this rank's build slice goes to every peer
    st = stats_lib.shard_stats(None, cnt, sb, ndev, axis_name,
                               bytes_per_row=4 + build_vals.dtype.itemsize,
                               mesh=mesh)
    return (ok, ov, og, _gather_counts(cnt, mesh, axis_name),
            stats_lib.gather(st, mesh=mesh, axis_name=axis_name))


def join_exchange_caps(build_keys: torch.Tensor, probe_keys: torch.Tensor, *,
                       mesh, axis_name="x",
                       config: config_lib.SortConfig | None = None,
                       n: int | None = None):
    """Phase one of the sized hash join: the exact max (src, dst) lane
    occupancy of the build and the probe exchanges (two 0-d tensors)."""
    ndev = axis_size(mesh, axis_name)
    ax = comm.Axis(mesh, axis_name)
    bk, _, nb, sb = _build_shard(build_keys, build_keys, ndev, ax.index)
    npr, sp = _shard_rows(probe_keys, n, ndev)
    caps = []
    for keys, rows, s in ((bk, nb, sb), (probe_keys, npr, sp)):
        valid = _shard_valid(rows, s, axis_name, mesh=mesh,
                             device=keys.device)
        dest = torch.where(valid, _owner_of_keys(keys, ndev), ndev)
        caps.append(comm.pmax(count_bins(dest, ndev).max(), ax))
    return caps[0], caps[1]


@traced
def join_distributed_hash(build_keys: torch.Tensor, build_vals: torch.Tensor,
                          probe_keys: torch.Tensor, *, mesh, axis_name="x",
                          build_cap: int | None = None,
                          probe_cap: int | None = None,
                          config: config_lib.SortConfig | None = None,
                          n: int | None = None):
    """Inner FK join with both sides hash-exchanged: rank d keeps block d
    of the replicated build side, and both sides' rows move to owner =
    hash(key) % ndev. Returns (keys, vals, probe_idx (global probe row),
    counts, stats); rank d emits the matches of the keys hashing to d."""
    ndev = axis_size(mesh, axis_name)
    d = comm.axis_index(mesh, axis_name)
    bk, bv, nb, sb = _build_shard(build_keys, build_vals, ndev, d)
    npr, sp = _shard_rows(probe_keys, n, ndev)
    dev = probe_keys.device
    bcap = build_cap or sb
    pcap = probe_cap or sp
    bvalid = _shard_valid(nb, sb, axis_name, mesh=mesh, device=dev)
    pvalid = _shard_valid(npr, sp, axis_name, mesh=mesh, device=dev)
    destb = torch.where(bvalid, _owner_of_keys(bk, ndev), ndev)
    destp = torch.where(pvalid, _owner_of_keys(probe_keys, ndev), ndev)
    (rbk, rbv), rbvalid = exchange_rows([bk, bv], destb, ndev, axis_name,
                                        bcap, mesh=mesh)
    gpidx = d * sp + torch.arange(sp, dtype=torch.int32, device=dev)
    (rpk, rpi), rpvalid = exchange_rows([probe_keys, gpidx], destp, ndev,
                                        axis_name, pcap, mesh=mesh)
    ok, ov, oi, cnt = local_join(rbk, rbv, rpk, how="inner",
                                 build_valid=rbvalid, probe_valid=rpvalid,
                                 config=config)
    # received row -> global probe row (the tail's indices are clamped)
    og = rpi[torch.clamp(oi.long(), 0, rpi.shape[0] - 1)]
    send_counts = count_bins(destb, ndev) + count_bins(destp, ndev)
    # both exchanges move a key and a 4-byte companion column
    st = stats_lib.shard_stats(send_counts, cnt, bcap + pcap, ndev,
                               axis_name, bytes_per_row=8, mesh=mesh)
    return (ok, ov, og, _gather_counts(cnt, mesh, axis_name),
            stats_lib.gather(st, mesh=mesh, axis_name=axis_name))


@traced
def join_distributed_sized(build_keys, build_vals, probe_keys, *, mesh,
                           axis_name="x",
                           config: config_lib.SortConfig | None = None,
                           n: int | None = None):
    """Two-phase sized hash join: measure both exchanges, round the caps
    to powers of two, run join_distributed_hash. Returns (keys, vals,
    probe_idx, counts, (build_cap, probe_cap), stats)."""
    bcap, pcap = join_exchange_caps(build_keys, probe_keys, mesh=mesh,
                                    axis_name=axis_name, config=config, n=n)
    bcap, pcap = round_cap(int(bcap)), round_cap(int(pcap))
    ok, ov, oi, cnt, st = join_distributed_hash(
        build_keys, build_vals, probe_keys, mesh=mesh, axis_name=axis_name,
        build_cap=bcap, probe_cap=pcap, config=config, n=n)
    return ok, ov, oi, cnt, (bcap, pcap), st


@traced
def join_distributed(build_keys, build_vals, probe_keys, *, mesh,
                     axis_name="x",
                     config: config_lib.SortConfig | None = None,
                     broadcast_threshold: int | None = None,
                     n: int | None = None):
    """Route a distributed inner join by build size: builds of at most
    ``broadcast_threshold`` rows (default JOIN_BROADCAST_ROWS, 2^20) are
    broadcast, larger ones hash-exchange both sides."""
    thresh = broadcast_threshold if broadcast_threshold is not None \
        else JOIN_BROADCAST_ROWS
    if build_keys.shape[0] <= thresh:
        return join_distributed_broadcast(
            build_keys, build_vals, probe_keys, mesh=mesh,
            axis_name=axis_name, config=config, n=n)
    ok, ov, oi, cnt, _, st = join_distributed_sized(
        build_keys, build_vals, probe_keys, mesh=mesh, axis_name=axis_name,
        config=config, n=n)
    return ok, ov, oi, cnt, st
