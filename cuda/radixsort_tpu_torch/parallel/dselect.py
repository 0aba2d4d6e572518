"""Distributed selection: k-th value, top-k, distinct and per-group
quantiles over a device mesh.

Counterpart of ``cuda/radixsort_tpu/parallel/dselect.py``:

* ``kth_value_distributed``: the radix-select walk of ``ops/select.py``
  with each 16-bin candidate histogram psum'd over the axis; no key moves.
* ``top_k_distributed``: local top-k per shard, one all-gather of the
  k*ndev candidates, and an exact (twiddled value, global index) sort, so
  ties break to the smallest global position (replicated output).
* ``distinct_distributed``: ``sort_distributed``, per-shard run starts,
  and one all-gather of each shard's last key to cut runs that cross
  shards.
* ``groupby_quantile_distributed``: per-group quantiles by histogram
  refinement, each (group, q) a pair of radix-select targets; per 4-bit
  level one psum'd (targets, 16) histogram.

Inputs are sharded as ``dsort`` describes, with the global row count
``n``; ``k`` and ``qs`` are the same on every rank.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.aggregate import _mean_dtype
from cuda.radixsort_tpu_torch.ops.filter import filter_columns
from cuda.radixsort_tpu_torch.ops.histogram import count_bins
from cuda.radixsort_tpu_torch.ops.select import top_k as _local_topk
from cuda.radixsort_tpu_torch.ops.sort import sort_struct
from cuda.radixsort_tpu_torch.ops.unique import _run_starts
from cuda.radixsort_tpu_torch.parallel import comm
from cuda.radixsort_tpu_torch.parallel.dsort import (_SENTINEL,
                                                      _count_crowded,
                                                      _gather_counts,
                                                      _keys_of_bits,
                                                      _padded_bits,
                                                      axis_size,
                                                      sort_distributed)
from cuda.radixsort_tpu_torch.utils.profiling import traced

_U32 = 0xFFFFFFFF


def _u64(bits: torch.Tensor) -> torch.Tensor:
    """u32 bits -> their unsigned value in int64."""
    return bits.view(torch.int32).to(torch.int64) & _U32


def _bits_u32(v: torch.Tensor) -> torch.Tensor:
    """An int64 holding a u32 value -> u32 bits."""
    return v.to(torch.int32).view(torch.uint32)


def _check32(keys: torch.Tensor, what: str) -> None:
    if twiddle.bit_width(keys.dtype) > 32:
        raise NotImplementedError(f"{what}: <=32-bit keys")


def _select_level(b64, cand_of, kk, prefix, level, ax):
    """One 4-bit level of the radix select over several targets: the
    psum'd 16-bin histograms of the candidate rows' digits pick each
    target's bucket."""
    digit = (b64 >> level) & 15
    hist = comm.psum(cand_of(digit), ax).to(torch.int64)
    cum = torch.cumsum(hist, -1) - hist
    bucket = torch.clamp((cum <= kk[..., None]).sum(-1) - 1, 0, 15)
    kk = kk - torch.gather(cum, -1, bucket[..., None])[..., 0]
    return kk, prefix | (bucket << level)


def _himask(level: int) -> int:
    return (_U32 << (level + 4)) & _U32 if level + 4 < 32 else 0


@traced
def kth_value_distributed(keys: torch.Tensor, k, *, mesh, axis_name="x",
                          largest: bool = False, n: int | None = None):
    """Global k-th smallest (0-based; largest=True for the k-th largest) of
    a sharded array: 8 psum'd 16-bin histograms, no exchange. Returns a
    0-d tensor of keys.dtype, equal on every rank."""
    _check32(keys, "kth_value_distributed")
    ax = comm.Axis(mesh, axis_name)
    bits, valid, n, s = _padded_bits(keys, n, axis_size(mesh, axis_name),
                                     axis_name, largest, 0, mesh=mesh)
    b = _u64(bits)
    dev = keys.device
    prefix = torch.zeros((), dtype=torch.int64, device=dev)
    kk = torch.as_tensor(k, dtype=torch.int64, device=dev).reshape(())
    for level in range(28, -1, -4):
        cand = valid & ((b & _himask(level)) == prefix)
        kk, prefix = _select_level(
            b, lambda digit: count_bins(torch.where(cand, digit, 16), 16),
            kk, prefix, level, ax)
    return _keys_of_bits(_bits_u32(prefix).reshape(1), keys.dtype,
                         largest)[0]


@traced
def top_k_distributed(keys: torch.Tensor, k: int, *, mesh, axis_name="x",
                      largest: bool = True, n: int | None = None):
    """Global top-k (values, global row indices) of a sharded array,
    bit-identical to the single-GPU ``top_k`` on the whole array (sorted,
    threshold ties to the smallest position). Equal on every rank."""
    _check32(keys, "top_k_distributed")
    ax = comm.Axis(mesh, axis_name)
    # padding takes the worst twiddled bits; validity masks it below
    bits, valid, n, s = _padded_bits(keys, n, ax.size, axis_name, largest,
                                     _SENTINEL, mesh=mesh)
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    kloc = min(k, s)
    vals, idx = _local_topk(bits, kloc, largest=False, sorted_result=False)
    idx = idx.long()
    ok = valid[idx]
    cv = torch.where(ok, _u64(vals), _U32)
    ci = torch.where(ok, ax.index * s + idx, _U32)
    av = comm.all_gather(cv, ax, tiled=True)
    ai = comm.all_gather(ci, ax, tiled=True)
    # lexicographic (value, index): stable sort by index, then by value
    o = torch.sort(ai, stable=True).indices
    o = o[torch.sort(av[o], stable=True).indices][:k]
    tv = _bits_u32(av[o])
    ti = ai[o].to(torch.int32)
    return _keys_of_bits(tv, keys.dtype, largest), ti


@traced
def distinct_distributed(keys: torch.Tensor, *, mesh, axis_name="x",
                         cap: int | None = None, n: int | None = None):
    """Sorted distinct values of a sharded array. Returns (this rank's
    block, (ndev,) counts): rank d's distinct values are block[:counts[d]];
    the concatenation over the ranks is the ascending distinct set."""
    ax = comm.Axis(mesh, axis_name)
    out, counts, _ = sort_distributed(keys, mesh=mesh, axis_name=axis_name,
                                      cap=cap, n=n)
    rows = out.shape[0]
    dev = out.device
    me = ax.index
    c = counts[me]
    valid = torch.arange(rows, device=dev) < c
    starts = _run_starts(out) & valid
    # a run crossing shards: my first key repeats the nearest non-empty
    # predecessor's last key
    bi = out.view(torch.int32)
    lasts = comm.all_gather(bi[torch.clamp_min(c - 1, 0)], ax)
    devs = torch.arange(ax.size, device=dev)
    has = (devs < me) & (counts > 0)
    prev_i = torch.where(has, devs, -1).argmax()
    dup_first = has.any() & (bi[0] == lasts[prev_i]) & (c > 0)
    starts[0] = starts[0] & ~dup_first
    (kept,), ucnt = filter_columns(starts, (out,))
    return (_keys_of_bits(kept, keys.dtype, False),
            _gather_counts(ucnt, mesh, axis_name))


@traced
def groupby_quantile_distributed(keys, values, qs=(0.5,), *, mesh,
                                 axis_name="x", max_groups: int = 64,
                                 n: int | None = None):
    """Per-group quantiles over a sharded table by histogram refinement:
    no key or value moves. A quantile is a k-th smallest within its group;
    linear interpolation needs the floor- and ceil-rank elements, so each
    (group, q) is two radix-select targets refined together, one psum'd
    (targets, 16) histogram per 4-bit level.

    Requires at most max_groups distinct groups and <=32-bit keys and
    values. Returns (group_keys (G,), quantile columns (G,) each in the
    mean dtype, n_groups), equal on every rank: the first
    min(n_groups, max_groups) slots are valid, key-ascending; n_groups >
    max_groups signals that only the max_groups key-smallest groups were
    kept (their quantiles exact)."""
    if isinstance(qs, (int, float)):
        qs = (float(qs),)
    qs = tuple(qs)
    for q in qs:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
    if twiddle.bit_width(keys.dtype) > 32 or twiddle.bit_width(
            values.dtype) > 32:
        raise NotImplementedError(
            "groupby_quantile_distributed: <=32-bit keys and values")
    G = max_groups
    ax = comm.Axis(mesh, axis_name)
    md0 = _mean_dtype(values.dtype)
    dev = keys.device
    if n == 0:
        return (torch.zeros(G, dtype=keys.dtype, device=dev),
                tuple(torch.zeros(G, dtype=md0, device=dev) for _ in qs),
                torch.zeros((), dtype=torch.int32, device=dev))
    kb, valid, n, s = _padded_bits(keys, n, ax.size, axis_name, False, 0,
                                   mesh=mesh)
    vb, _, _, _ = _padded_bits(values, n, ax.size, axis_name, False, 0,
                               mesh=mesh)
    gk, qstack, n_groups = quantile_refine_shard(
        kb, vb, valid, qs, G, values.dtype, axis_name, mesh=mesh)
    return (_keys_of_bits(gk, keys.dtype, False),
            tuple(qstack[i] for i in range(len(qs))), n_groups)


def _distinct_padded(bits, invalid, G):
    """First G distinct values of u32 ``bits`` (rows with invalid=True
    excluded), ascending, their slot validity and the true local distinct
    count. Invalidity rides its own sort limb: no bit pattern is
    reserved."""
    flag = invalid.to(torch.int32).view(torch.uint32)
    sf, sb = sort_struct((flag, bits))
    # a run with any valid row starts with one (flag-major order)
    starts = _run_starts(sb) & (sf.view(torch.int32) == 0)
    (kept,), cnt = filter_columns(starts, (sb,))
    ki = kept.view(torch.int32)
    if ki.shape[0] < G:
        ki = torch.cat([ki, torch.full((G - ki.shape[0],), _SENTINEL,
                                       dtype=torch.int32, device=ki.device)])
    slotvalid = torch.arange(G, device=ki.device) < torch.clamp_max(cnt, G)
    # pads take the max bit pattern so the slots stay ascending for the
    # binary search; 'left' still finds a real 0xFFFFFFFF group's slot
    padded = torch.where(slotvalid, ki[:G], _SENTINEL).view(torch.uint32)
    return padded, slotvalid, cnt


def distinct_count_capped(keys: torch.Tensor, *, cap: int, mesh,
                          axis_name="x", n: int | None = None):
    """Distinct-value count of a sharded array, exact while <= cap; any
    value above cap means "more than cap" (0-d, equal on every rank). One
    local sort and one (cap,) all-gather."""
    _check32(keys, "distinct_count_capped")
    ax = comm.Axis(mesh, axis_name)
    b, valid, n, s = _padded_bits(keys, n, ax.size, axis_name, False, 0,
                                  mesh=mesh)
    lk, lval, lcnt = _distinct_padded(b, ~valid, cap)
    ak = comm.all_gather(lk, ax, tiled=True)
    av = comm.all_gather(lval, ax, tiled=True)
    _, _, gcnt = _distinct_padded(ak, ~av, cap)
    over = comm.psum((lcnt > cap).to(torch.int32), ax) > 0
    return torch.where(over | (gcnt > cap), cap + 1, gcnt).to(torch.int32)


def quantile_refine_shard(kb, vb, valid, qs, max_groups, value_dtype,
                          axis_name, *, mesh):
    """Per-shard histogram-refinement group-by quantiles, the core of
    :func:`groupby_quantile_distributed`, which the plan's quantiles stage
    also runs in place of a row exchange.

    kb, vb: (s,) u32 twiddled key / value bits; valid: (s,) bool. Returns
    (group-key bits (G,) u32, ascending over the valid slots; qstack (Q, G)
    in the mean dtype of value_dtype; n_groups 0-d int32, above G when
    groups beyond the G key-smallest were dropped)."""
    ax = comm.Axis(mesh, axis_name)
    G, Q = max_groups, len(qs)
    md = _mean_dtype(value_dtype)
    dev = kb.device

    # the replicated global group-key set (<= G by the contract)
    lk, lval, lcnt = _distinct_padded(kb, ~valid, G)
    ak = comm.all_gather(lk, ax, tiled=True)
    av = comm.all_gather(lval, ax, tiled=True)
    gk, gvalid, gcnt = _distinct_padded(ak, ~av, G)
    # a shard whose local distinct count exceeds G truncated its
    # candidates: report n_groups > G
    over = comm.psum((lcnt > G).to(torch.int32), ax) > 0
    n_groups = torch.where(over, torch.clamp_min(gcnt, G + 1), gcnt)
    gk64 = _u64(gk)
    k64 = _u64(kb)
    gid = torch.clamp(torch.searchsorted(gk64, k64, side="left"), 0, G - 1)
    # rows of groups beyond the kept slots count nowhere
    valid = valid & (gk64[gid] == k64)
    cnt = comm.psum(count_bins(torch.where(valid, gid, G), G), ax)

    # targets: for each q and group, the floor and the ceil rank
    cntf = torch.clamp_min(cnt - 1, 0).to(torch.float32)
    klo, khi, fracs = [], [], []
    for q in qs:
        idx_f = cntf * torch.tensor(q, dtype=torch.float32, device=dev)
        lo = torch.floor(idx_f).to(torch.int32)
        klo.append(lo)
        khi.append(torch.ceil(idx_f).to(torch.int32))
        fracs.append(idx_f - lo.to(torch.float32))
    # (2Q, G): row j is the j-th target column over the groups
    kk = torch.stack(klo + khi).to(torch.int64)
    v64 = _u64(vb)
    prefix = torch.zeros((2 * Q, G), dtype=torch.int64, device=dev)
    for level in range(28, -1, -4):
        hi = v64 & _himask(level)

        def counts(digit, prefix=prefix, hi=hi):
            # rows match target (j, g) iff gid == g and their high bits
            # equal the target's prefix: one (G, 16) count per column j
            rows = []
            for j in range(2 * Q):
                m = valid & (hi == prefix[j][gid])
                rows.append(_count_crowded(
                    torch.where(m, gid * 16 + digit, G * 16),
                    G * 16).reshape(G, 16))
            return torch.stack(rows)

        kk, prefix = _select_level(v64, counts, kk, prefix, level, ax)

    qcols = []
    for qi in range(Q):
        vlo = _keys_of_bits(_bits_u32(prefix[qi]), value_dtype,
                            False).to(md)
        vhi = _keys_of_bits(_bits_u32(prefix[Q + qi]), value_dtype,
                            False).to(md)
        f = fracs[qi].to(md)
        col = vlo * (1 - f) + vhi * f
        qcols.append(torch.where(gvalid & (cnt > 0), col,
                                 torch.zeros((), dtype=md, device=dev)))
    return gk, torch.stack(qcols), n_groups
