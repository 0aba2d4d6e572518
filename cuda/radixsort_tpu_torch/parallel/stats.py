"""Per-operator exchange statistics of the distributed layer.

Counterpart of ``cuda/radixsort_tpu/parallel/stats.py``: every distributed
operator returns an :class:`ExchangeStats` beside its result, with the
same fields and dtypes. :func:`shard_stats` builds this rank's slice,
shaped as a ``shard_map`` body's ((1,) per-rank fields, 0-d replicated
ones); :func:`stats_out_specs` says which fields concatenate over the
axis, and :func:`gather` assembles them so, so that every rank returns
the global statistics the JAX function returns.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cuda.radixsort_tpu_torch.parallel import comm


class ExchangeStats(NamedTuple):
    """Per-operator exchange statistics.

    rows_in:  (ndev,) int32: valid input rows contributed per source shard.
    rows_out: (ndev,) int32: valid result rows owned per destination shard.
    wire_bytes: (ndev,) float32: bytes each rank puts on the interconnect,
        the padded-lane upper bound ((ndev - 1) send lanes of ``cap`` rows;
        the self lane stays local).
    cap: int32: the lane capacity the exchange ran with.
    cap_utilization: float32: max send-lane occupancy / cap (above 1.0 the
        exchange overflowed and its result was poisoned to empty).
    skew: float32: max(rows_out) / mean(rows_out) over the ranks.
    """

    rows_in: torch.Tensor
    rows_out: torch.Tensor
    wire_bytes: torch.Tensor
    cap: torch.Tensor
    cap_utilization: torch.Tensor
    skew: torch.Tensor


def shard_stats(send_counts, rows_out, cap: int, ndev: int, axis_name,
                bytes_per_row: int, skew_ndev: int | None = None, *, mesh):
    """This rank's slice of ExchangeStats.

    send_counts: (ndev,) rows this shard sends to each destination, or
    None when the operator broadcasts instead of exchanging. rows_out: 0-d
    valid rows this shard owns after the operator. skew_ndev: the rank
    count of the skew's denominator where it differs from the lane count
    (hierarchical exchanges). Per-rank fields are (1,), the replicated
    ones 0-d (one psum and two pmax over the axis)."""
    ax = comm.Axis(mesh, axis_name)
    skew_ndev = ndev if skew_ndev is None else skew_ndev
    rows_out = torch.as_tensor(rows_out).to(torch.int32).reshape(())
    dev = rows_out.device
    # the product is a Python int: no int32 overflow
    wire = torch.tensor(float((ndev - 1) * cap * bytes_per_row),
                        dtype=torch.float32, device=dev)
    if send_counts is None:
        rows_in = rows_out
        util = torch.ones((), dtype=torch.float32, device=dev)
    else:
        rows_in = send_counts.sum(dtype=torch.int32)
        # times the f32 reciprocal, as XLA folds a division by a constant
        util = send_counts.max().to(torch.float32) * float(
            np.float32(1) / np.float32(cap))
    total = comm.psum(rows_out, ax)
    mx = comm.pmax(rows_out, ax)
    skew = mx.to(torch.float32) * skew_ndev / torch.clamp_min(
        total.to(torch.float32), 1.0)
    return ExchangeStats(
        rows_in=rows_in.reshape(1),
        rows_out=rows_out.reshape(1),
        wire_bytes=wire.reshape(1),
        cap=torch.tensor(cap, dtype=torch.int32, device=dev),
        cap_utilization=comm.pmax(util, ax),
        skew=skew,
    )


def stats_out_specs(axis_name):
    """How the fields of a rank's ExchangeStats assemble: the axis name
    for the per-rank vectors (concatenated over the axis in rank order),
    None for the replicated scalars."""
    return ExchangeStats(rows_in=axis_name, rows_out=axis_name,
                         wire_bytes=axis_name, cap=None,
                         cap_utilization=None, skew=None)


def gather(st: ExchangeStats, *, mesh, axis_name) -> ExchangeStats:
    """The global ExchangeStats from this rank's slice, as
    :func:`stats_out_specs` lays them out (equal on every rank)."""
    ax = comm.Axis(mesh, axis_name)
    return ExchangeStats(*[
        f if spec is None else comm.all_gather(f, ax, tiled=True)
        for f, spec in zip(st, stats_out_specs(axis_name))])


def describe(stats: ExchangeStats) -> str:
    """One-line human summary."""
    ri = stats.rows_in.cpu()
    ro = stats.rows_out.cpu()
    wb = float(stats.wire_bytes.sum())
    util = float(stats.cap_utilization)
    over = "  !!OVERFLOW(rows dropped)" if util > 1.0 else ""
    return (
        f"rows_in={int(ri.sum())} rows_out={int(ro.sum())} "
        f"per_dev_out={ro.tolist()} wire_MB={wb / 1e6:.2f} "
        f"cap={int(stats.cap)} util={util:.2f} "
        f"skew={float(stats.skew):.2f}{over}"
    )
