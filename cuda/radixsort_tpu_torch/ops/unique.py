"""Unique and run-length encoding over sorted or run-structured keys.

Counterpart of ``cuda/radixsort_tpu/ops/unique.py``. Parity:
cub::DeviceSelect::Unique and cub::DeviceRunLengthEncode::{Encode,
NonTrivialRuns}: only adjacent equal keys collapse, so ``unique(sort(x))``
is the distinct-value set (:func:`distinct`). Run starts are one
neighbour compare; the compaction is the filter operator's stable 2-bit
pass (the stage kernel). Outputs keep their full length, with a 0-d int32
count on the device, as ``filter_columns``'.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.aggregate import _neighbour_differs
from cuda.radixsort_tpu_torch.ops.filter import (filter_columns,
                                                 selection_vector)
from cuda.radixsort_tpu_torch.ops.sort import sort
from cuda.radixsort_tpu_torch.utils.profiling import traced


def _run_starts(keys: torch.Tensor) -> torch.Tensor:
    """True where a run of equal keys begins (floats compare as values:
    -0.0 joins 0.0's run, each NaN starts its own)."""
    if keys.shape[0] == 0:
        return torch.zeros(0, dtype=torch.bool, device=keys.device)
    starts = _neighbour_differs(keys)
    starts[0] = True
    return starts


@traced
def unique(keys: torch.Tensor,
           config: config_lib.SortConfig | None = None):
    """Collapse consecutive equal keys (cub::DeviceSelect::Unique).

    Returns (unique_keys, count): unique_keys[:count] are the first key of
    each run, in order; the tail holds the dropped duplicates."""
    (uk,), count = filter_columns(_run_starts(keys), (keys,), config=config)
    return uk, count


def _run_lengths(starts: torch.Tensor, config):
    """(sel, lengths, count): sel[:count] the start row of each run in
    order, lengths[:count] the runs' lengths (0 past count)."""
    n = starts.shape[0]
    sel, count = selection_vector(starts, config=config)
    idx = torch.arange(n, dtype=torch.int32, device=starts.device)
    nxt = torch.roll(sel, -1)  # the next run's start, but at the last run
    ends = torch.where(idx == count - 1, n, nxt)
    return sel, torch.where(idx < count, ends - sel, 0), count


@traced
def run_length_encode(keys: torch.Tensor,
                      config: config_lib.SortConfig | None = None):
    """Run-length encode (cub::DeviceRunLengthEncode::Encode).

    Returns (unique_keys, run_lengths, num_runs): run i < num_runs is
    run_lengths[i] copies of unique_keys[i], in input order; later entries
    have length 0. unique_keys is the input reordered by the selection
    vector, so its tail holds the dropped duplicates, as :func:`unique`'s."""
    sel, lengths, count = _run_lengths(_run_starts(keys), config)
    return twiddle.take(keys, sel.long()), lengths, count


@traced
def non_trivial_runs(keys: torch.Tensor,
                     config: config_lib.SortConfig | None = None):
    """Offsets and lengths of the runs longer than one element
    (cub::DeviceRunLengthEncode::NonTrivialRuns).

    Returns (run_offsets, run_lengths, num_runs); lengths past num_runs
    are 0."""
    sel, lengths, _ = _run_lengths(_run_starts(keys), config)
    (offs, lens), nruns = filter_columns(lengths >= 2, (sel, lengths),
                                         config=config)
    idx = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    return offs, torch.where(idx < nruns, lens, 0), nruns


@traced
def distinct(keys: torch.Tensor,
             config: config_lib.SortConfig | None = None):
    """Sorted distinct values of any key tensor: radix sort, then unique.

    Returns (values, count): values[:count] ascending, free of
    duplicates."""
    return unique(sort(keys, config=config), config=config)
