"""Distributed segmented scan (scan-by-key) over a device mesh.

Counterpart of ``cuda/radixsort_tpu/parallel/dscan.py``. Each rank scans
its shard locally (the segmented-scan kernel), then one small all-gather
of three numbers per rank (the shard's tail-run total, its last key, and
whether the whole shard is one run) lets every rank resolve its
cross-shard carry: shard d's carry combines the tail totals of the
maximal chain of predecessors d-1, d-2, ... whose last key equals shard
d's first key, stopping at the first predecessor that is not a single
run. The carry applies only to shard d's first run. No row moves.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.scan import (_full, _resolve_op,
                                               segmented_scan)
from cuda.radixsort_tpu_torch.parallel import comm
from cuda.radixsort_tpu_torch.parallel.dsort import _shard_rows, axis_size
from cuda.radixsort_tpu_torch.utils.profiling import traced


@traced
def scan_by_key_distributed(keys: torch.Tensor, values: torch.Tensor,
                            op="sum", *, mesh, axis_name="x",
                            exclusive: bool = False, init=None,
                            identity=None, n: int | None = None):
    """Scan ``values`` within runs of consecutive equal ``keys``, laid out
    shard-major over ``axis_name``: rank d passes rows [d*s, (d+1)*s) of
    the input padded to s*ndev rows, and ``n``, the global row count.
    Rank d returns its block of the single-GPU ``scan_by_key`` result; when
    ``n`` does not divide the mesh, every rank returns the whole (n,)
    result, gathered (the padding rows extend the last run and never
    reach a real output).

    op: "sum" | "prod" | "min" | "max" or an associative callable (which
    needs identity=). ``init`` seeds every segment of an exclusive scan,
    or folds into every element of an inclusive one."""
    ax = comm.Axis(mesh, axis_name)
    ndev = axis_size(mesh, axis_name)
    f, ident = _resolve_op(op, identity, values.dtype, values.device,
                           need_identity=True)
    if values.shape[0] != keys.shape[0]:
        raise ValueError(f"keys/values length mismatch: {keys.shape[0]} vs "
                         f"{values.shape[0]}")
    n, s = _shard_rows(keys, n, ndev)
    if n == 0:
        return values
    kv = twiddle.full_view(keys)
    heads = torch.ones(s, dtype=torch.bool, device=keys.device)
    heads[1:] = kv[1:] != kv[:-1]
    # the inclusive scan's last slot is the shard's tail-run total
    inc = segmented_scan(values, heads, op, identity=identity)
    local = (segmented_scan(values, heads, op, identity=identity,
                            exclusive=True) if exclusive else inc)
    n_heads = heads.sum(dtype=torch.int32)
    tails = comm.all_gather(inc[-1], ax)
    lasts = twiddle.full_view(comm.all_gather(keys[-1], ax))
    whole = comm.all_gather(n_heads == 1, ax)
    d = ax.index
    carry = ident
    cont = torch.ones((), dtype=torch.bool, device=keys.device)
    has = torch.zeros((), dtype=torch.bool, device=keys.device)
    for p in range(d):  # predecessors d-1, d-2, ..., 0
        q = d - 1 - p
        match = (lasts[q] == kv[0]) & cont
        carry = twiddle.where(match, twiddle.where(has, f(tails[q], carry),
                                                   tails[q]), carry)
        cont = match & whole[q]
        has = has | match
    # the carry feeds only the shard's first run
    first_run = torch.cumsum(heads[1:].to(torch.int32), 0) == 0
    first_run = torch.cat([torch.ones(1, dtype=torch.bool,
                                      device=keys.device), first_run])
    out = twiddle.where(first_run & has, f(carry, local), local)
    if init is not None:
        out = f(_full((), init, values.dtype, values.device), out)
    if s * ndev != n:
        out = comm.all_gather(out, ax, tiled=True)[:n]
    return out
