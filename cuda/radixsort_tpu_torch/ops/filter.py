"""Predicate filter with selection vectors.

Counterpart of ``cuda/radixsort_tpu/ops/filter.py``. Compaction is a stable
partition by the negated predicate (kept rows first): one 2-bit counting
pass through ``sort_pairs``, the same stage kernel as the sort. Outputs keep
their full length: rows [0, count) are the kept rows in their original
order, the tail holds the dropped rows in their original order, and count
is a 0-d int32 tensor on the device (no host sync).
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch.ops.sort import sort_pairs
from cuda.radixsort_tpu_torch.utils.profiling import traced


def compaction_config(config: config_lib.SortConfig | None = None
                      ) -> config_lib.SortConfig:
    """The configuration every compaction runs with: the caller's (default:
    the preset), resolved, with 2-bit digits for the 0/1 key."""
    return config_lib.for_partition(config_lib.resolve(config), bits=1)


def _partition_key(mask: torch.Tensor) -> torch.Tensor:
    """u32 0 for a kept row, 1 for a dropped one."""
    return (~mask.to(torch.bool)).to(torch.int32).view(torch.uint32)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.to(torch.bool).sum(dtype=torch.int32)


@traced
def selection_vector(mask: torch.Tensor,
                     config: config_lib.SortConfig | None = None):
    """mask (N,) bool -> (sel (N,) int32, count). sel[:count] are the indices
    of rows where mask is True, in order; sel[count:] are the dropped rows'
    indices (a permutation, usable to invert the filter)."""
    cfg = compaction_config(config)
    idx = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    # end_bit = the digit width: the key is already 0/1, and a width-aligned
    # range is one pass with no masked copy of the key
    _, sel = sort_pairs(_partition_key(mask), idx, begin_bit=0,
                        end_bit=cfg.radix_bits, config=cfg)
    return sel, _count(mask)


@traced
def filter_columns(mask: torch.Tensor, columns,
                   config: config_lib.SortConfig | None = None):
    """Compact a tensor, or a list, tuple or dict of equal-length tensors,
    by a boolean predicate.

    Returns (filtered_columns, count): rows [0, count) of every output column
    are the rows where mask was True, in their original order; tail rows are
    the dropped rows (not zeroed: slice or mask with count).
    """
    cfg = compaction_config(config)
    _, out = sort_pairs(_partition_key(mask), columns, begin_bit=0,
                        end_bit=cfg.radix_bits, config=cfg)
    return out, _count(mask)
