"""Pipelined query: filter -> sort -> join, with per-stage row counts.

Counterpart of ``cuda/radixsort_tpu/pipeline/query.py``, single GPU: the
filter compacts the probe side (``ops/filter.py::compaction_config``: the
stable 2-bit pass), the join sorts both sides, and a last compaction
drops the matches of filtered-out probe rows. Counts stay 0-d int32
tensors on the device. The distributed form waits for ROADMAP A.11.
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
    (fk, fv), nf = filter_columns(probe_vals > threshold,
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


def filter_sort_join_distributed(*args, **kwargs):
    raise NotImplementedError("filter_sort_join_distributed is distributed "
                              "work, not ported yet (ROADMAP A.11)")
