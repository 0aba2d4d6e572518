"""LSD loop over u32 limb columns — plain torch glue around the two kernels.

Counterpart of ``cuda/radixsort_tpu/kernels/pipeline.py``. Before the first
pass, one histogram launch counts every stage of every limb (histograms do
not change under the permutations the passes apply) and the stages'
maxima are read to the host once (one sync per sort) for the trivial-pass
skip; then, per limb (least significant first), one partition stage per
digit that is not skipped. The first pass reads the caller's planes; the
passes then ping-pong between the result's columns, allocated up front,
and one scratch set in their layout, in the order that makes the last
pass write the result.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch.kernels import histogram as hist_lib
from cuda.radixsort_tpu_torch.kernels import stage as stage_lib
from cuda.radixsort_tpu_torch.utils.profiling import sync_span

ROWS = 0  # rows of every sort that entered the LSD loop (sort_limbs)


def _stages_for(begin: int, end: int, width: int) -> list[int]:
    """Stage shifts covering the width-aligned hull of [begin, end), LSD
    order."""
    return [width * s for s in range(begin // width, -(-end // width))]


def sort_limbs(limbs, limb_bits, payloads, cfg):
    """Stable LSD sort of u32 limb columns via the stage kernel.

    limbs[k]: (N,) torch.uint32, most significant first; limb_bits[k] =
    (begin, end): the bits of limb k that take part in the order.
    payloads: (N,) torch.uint32 planes that follow the permutation. A limb
    or payload is contiguous or one stride-2 half of an 8-byte column
    (``histogram.halves``) whose other half is also given; the two halves
    of a 64-bit key are neighbouring limbs. A bit range that is not
    width-aligned is sorted through a masked copy of the limb as the key,
    with the original limb riding along (CUB begin_bit/end_bit semantics).
    Returns (limbs, payloads) in the inputs' layout (an 8-byte column's
    halves are the halves of one fresh column); the inputs are never
    written and never returned.
    """
    global ROWS
    width = cfg.radix_bits  # digit width of one stage: 2, 4 or 8
    n = limbs[0].numel()
    ROWS += n
    planes = list(limbs) + list(payloads)
    partner = hist_lib.pair_planes(planes)
    n_limbs = len(limbs)

    # every limb's stage histograms in one read, and their maxima on the
    # host in one sync: a stage whose digit puts every key in one bucket is
    # the identity and is skipped (CUB's dispatch copy shortcut)
    hist = hist_lib.limb_histograms(limbs, limb_bits, width)
    bases = hist_lib.stage_bases(hist)
    hist_max = []
    if hist.shape[0]:
        maxima = hist_lib.counts64(hist).max(dim=1).values
        with sync_span("lsd_maxima"):
            hist_max = maxima.tolist()
    ranges = hist_lib.limb_stages(limb_bits, width)  # (mask, n_stages)
    first_row = [sum(st for _, st in ranges[:k]) for k in range(len(ranges))]
    passes = [(k, shift, first_row[k] + shift // width)
              for k in range(n_limbs - 1, -1, -1)
              for shift in _stages_for(*limb_bits[k], width)
              if limb_bits[k][0] < limb_bits[k][1]
              and hist_max[first_row[k] + shift // width] != n]

    # the result, and (for two passes or more) one scratch set: pass p
    # writes the result when an even number of passes follow it
    result = stage_lib.empty_like(planes, partner)
    if not passes:
        for r, p in zip(result, planes):
            r.copy_(p)
        return result[:n_limbs], result[n_limbs:]
    scratch = (stage_lib.empty_like(planes, partner) if len(passes) > 1
               else None)
    cur = planes
    masked, masked_limb = None, None  # the masked key copy, its ping-pong
    for p, (k, shift, s) in enumerate(passes):
        dst = result if (len(passes) - 1 - p) % 2 == 0 else scratch
        begin, end = limb_bits[k]
        if begin % width == 0 and end % width == 0:
            order = [k] + [i for i in range(len(planes)) if i != k]
            src, out = [cur[i] for i in order], [dst[i] for i in order]
        else:
            if masked_limb != k:  # the limb as it stands, masked
                if masked is None:
                    masked = [torch.empty(n, dtype=torch.uint32,
                                          device=planes[0].device)
                              for _ in range(2)]
                mask = ranges[k][0]
                torch.bitwise_and(
                    cur[k].view(torch.int32),
                    mask - (1 << 32) if mask >= 1 << 31 else mask,
                    out=masked[0].view(torch.int32))
                masked_limb = k
            src = [masked[0]] + list(cur)
            out = [masked[1]] + list(dst)
            masked.reverse()
        stage_lib.partition_stage(src, bases[s], shift=shift, width=width,
                                  out=out, config=cfg)
        cur = dst
    return result[:n_limbs], result[n_limbs:]
