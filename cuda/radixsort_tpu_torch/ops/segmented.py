"""Segmented sort: an independent stable sort inside every segment.

Counterpart of ``cuda/radixsort_tpu/ops/segmented.py``. Parity:
cub::DeviceSegmentedRadixSort. The segment id becomes the most significant
limb of a composite key, so the whole batch is one sort, whatever the
segment sizes:

* 'bitonic', keys only, keys of up to 32 bits, full range: a 2-plane
  (segment, key) network sort;
* otherwise the (segment, key limbs...) sort of ``ops/sort.py``: the
  network's pair route where it serves the shape, the stable radix path
  elsewhere. The radix engine declares only the bits a segment id needs,
  so fewer digit passes run.

Segment ids come from the offsets by a scatter of nseg ones and a running
sum (the scan kernel), never by a per-row search.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch.ops.scan import plain_scan_fast
from cuda.radixsort_tpu_torch.ops.sort import (_bitonic_planes, _check_1d,
                                               _check_device_n, _flatten,
                                               _key_to_limbs, _limbs_to_key,
                                               _sort_limbs, _unflatten,
                                               full_range)
from cuda.radixsort_tpu_torch.utils.profiling import traced


def _segment_ids(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """Row -> segment id (u32) for offsets (nseg + 1,): a one at each inner
    boundary, then an inclusive running sum. Boundaries outside [0, n] are
    dropped."""
    cuts = offsets[1:-1].to(torch.int64)
    cuts = cuts[(cuts >= 0) & (cuts <= n)]
    ind = torch.zeros(n + 1, dtype=torch.int32, device=offsets.device)
    ind.index_add_(0, cuts, torch.ones_like(cuts, dtype=torch.int32))
    return plain_scan_fast(ind[:n].contiguous(), "sum").view(torch.uint32)


@traced
def segmented_sort(keys: torch.Tensor, offsets: torch.Tensor, values=None, *,
                   descending: bool = False,
                   num_segments_bound: int | None = None,
                   begin_bit: int | None = None, end_bit: int | None = None,
                   config: config_lib.SortConfig | None = None):
    """Stable sort within each segment; segment s is rows
    [offsets[s], offsets[s+1]) of the (num_segments + 1,) int offsets.
    Returns the sorted keys, and the values (a tensor, or a list, tuple or
    dict of tensors) when given; segment boundaries do not move.

    num_segments_bound caps the segment limb's bit width on the radix
    engine (default: enough for len(offsets) - 1 segments).
    begin_bit/end_bit restrict the key bits that order, as
    cub::DeviceSegmentedRadixSort's digit range (the segment limb always
    orders in full)."""
    cfg = config_lib.resolve(config)
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-D; got shape {tuple(keys.shape)}")
    n = keys.shape[0]
    _check_device_n(n)
    leaves: list = []
    spec = _flatten(values, leaves) if values is not None else None
    for i, v in enumerate(leaves):
        _check_1d(f"values leaf {i}", v, n, keys.device)
    if n == 0:
        out = keys.clone()
        if values is None:
            return out
        return out, _unflatten(spec, iter([v.clone() for v in leaves]))
    nseg = num_segments_bound or (offsets.shape[0] - 1)
    seg_bits = max(1, max(nseg - 1, 1).bit_length())
    seg = _segment_ids(offsets, n)

    limbs, limb_bits = _key_to_limbs(keys, descending, begin_bit, end_bit)
    full = full_range(keys.dtype, begin_bit, end_bit)
    if (cfg.engine == "bitonic" and values is None and len(limbs) == 1
            and full):
        # (segment, key) as a 2-plane total order of bit-identical ties
        out = _bitonic_planes([seg, limbs[0]], n, 2, cfg)
        return _limbs_to_key(out[1:], keys.dtype, descending)

    # a comparison network gains nothing from a narrow segment limb; the
    # radix engine runs fewer passes with it
    seg_range = (0, 32) if cfg.engine == "bitonic" and full else (0, seg_bits)
    limbs, out = _sort_limbs([seg] + limbs, [seg_range] + limb_bits, leaves,
                             cfg)
    keys_out = _limbs_to_key(limbs[1:], keys.dtype, descending)
    if values is None:
        return keys_out
    return keys_out, _unflatten(spec, iter(out))
