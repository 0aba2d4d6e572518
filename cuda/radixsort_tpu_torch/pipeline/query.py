"""Pipelined query: filter -> sort -> join, with per-stage row counts.

Counterpart of ``cuda/radixsort_tpu/pipeline/query.py``, single GPU: the
filter compacts the probe side (``ops/filter.py::compaction_config``: the
stable 2-bit pass), the join sorts both sides, and a last compaction
drops the matches of filtered-out probe rows. Counts stay 0-d int32
tensors on the device.

Distributed: every rank filters and sorts its probe shard; the join
either probes the whole build table (broadcast) or hash-exchanges the
filtered probe rows and the build side's blocks (``parallel/shuffle.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.filter import (compaction_config,
                                                 filter_columns)
from cuda.radixsort_tpu_torch.ops.join import join


class QueryStats(NamedTuple):
    rows_in: torch.Tensor
    rows_after_filter: torch.Tensor
    rows_joined: torch.Tensor


def filter_sort_join(probe_keys: torch.Tensor, probe_vals: torch.Tensor,
                     build_keys: torch.Tensor, build_vals: torch.Tensor,
                     threshold,
                     config: config_lib.SortConfig | None = None):
    """SELECT p.key, p.val, b.val FROM probe p JOIN build b USING (key)
    WHERE p.val > threshold.

    Returns (keys, probe_vals, build_vals, count, stats): rows [0, count)
    valid, ordered by key (ties in probe order)."""
    n = probe_keys.shape[0]
    dev = probe_keys.device
    fcfg = compaction_config(config)
    (fk, fv), nf = filter_columns(twiddle.greater(probe_vals, threshold),
                                  (probe_keys, probe_vals), config=fcfg)
    # the join sees every probe row; matches of rows the filter dropped
    # (probe index >= nf) are compacted away after it
    ok, ov, oi, cnt = join(build_keys, build_vals, fk, how="inner",
                           config=config)
    keep = (torch.arange(ok.shape[0], device=dev) < cnt) & (oi < nf)
    (k2, bv2, pi2), cnt2 = filter_columns(keep, (ok, ov, oi), config=fcfg)
    pv2 = twiddle.take(fv, pi2.long())
    stats = QueryStats(
        rows_in=torch.tensor(n, dtype=torch.int32, device=dev),
        rows_after_filter=nf, rows_joined=cnt2)
    return k2, pv2, bv2, cnt2, stats


def filter_sort_join_distributed(probe_keys: torch.Tensor,
                                 probe_vals: torch.Tensor,
                                 build_keys: torch.Tensor,
                                 build_vals: torch.Tensor, threshold, *,
                                 mesh, axis_name="x",
                                 join_strategy: str = "auto",
                                 config: config_lib.SortConfig | None = None):
    """The distributed query: every rank passes its block of the probe side
    (the probe and build row counts must divide the mesh) and the whole
    build side. The build is broadcast (small builds: no probe row moves)
    or hash-exchanged with the filtered probe rows (large builds), per
    ``join_strategy`` ('auto' routes at ``JOIN_BROADCAST_ROWS``
    build rows, ``parallel/shuffle.py``). Returns this
    rank's (keys, probe_vals, build_vals) block, the (ndev,) counts and
    the QueryStats totals (equal on every rank)."""
    from cuda.radixsort_tpu_torch.parallel import comm
    from cuda.radixsort_tpu_torch.parallel.dsort import _gather_counts
    from cuda.radixsort_tpu_torch.parallel.shuffle import (
        JOIN_BROADCAST_ROWS, _owner_of_keys, exchange_rows)

    if join_strategy not in ("auto", "broadcast", "hash"):
        raise ValueError(join_strategy)
    if join_strategy == "auto":
        join_strategy = ("broadcast"
                         if build_keys.shape[0] <= JOIN_BROADCAST_ROWS
                         else "hash")
    ax = comm.Axis(mesh, axis_name)
    ndev = ax.size
    if build_keys.shape[0] % ndev:
        raise ValueError(f"{build_keys.shape[0]} build rows do not divide "
                         f"{ndev} ranks")
    if join_strategy == "broadcast":
        k, pv, bv, cnt, st = filter_sort_join(
            probe_keys, probe_vals, build_keys, build_vals, threshold,
            config=config)
        tot = QueryStats(*[comm.psum(x, ax) for x in st])
        return k, pv, bv, _gather_counts(cnt, mesh, axis_name), tot
    sp, sb = probe_keys.shape[0], build_keys.shape[0] // ndev
    dev = probe_keys.device
    bk = build_keys[ax.index * sb:(ax.index + 1) * sb]
    bvals = build_vals[ax.index * sb:(ax.index + 1) * sb]
    # 1. local filter (rows [0, nf) valid)
    (fk, fv), nf = filter_columns(twiddle.greater(probe_vals, threshold),
                                  (probe_keys, probe_vals), config=config)
    pvalid = torch.arange(sp, device=dev) < nf
    # 2. hash exchange of the filtered probe rows and the build rows
    destp = torch.where(pvalid, _owner_of_keys(fk, ndev), ndev)
    (rpk, rpv), rpvalid = exchange_rows([fk, fv], destp, ndev, axis_name, sp,
                                        mesh=mesh)
    destb = _owner_of_keys(bk, ndev)
    (rbk, rbv), rbvalid = exchange_rows([bk, bvals], destb, ndev, axis_name,
                                        sb, mesh=mesh)
    # 3. local join of the received key partitions
    ok, ov, oi, cnt = join(rbk, rbv, rpk, how="inner", build_valid=rbvalid,
                           probe_valid=rpvalid, config=config)
    opv = twiddle.take(rpv, torch.clamp(oi.long(), 0, rpv.shape[0] - 1))
    tot = QueryStats(
        rows_in=comm.psum(torch.tensor(sp, dtype=torch.int32, device=dev),
                          ax),
        rows_after_filter=comm.psum(nf.to(torch.int32), ax),
        rows_joined=comm.psum(cnt.to(torch.int32), ax))
    return ok, opv, ov, _gather_counts(cnt, mesh, axis_name), tot
