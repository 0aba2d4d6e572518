"""LSD loop over key columns — plain torch glue around the two kernels.

Counterpart of ``cuda/radixsort_tpu/kernels/pipeline.py``. Before the first
pass, one histogram launch counts every stage of every key column
(histograms do not change under the permutations the passes apply) and the
stages' maxima are read to the host once (one sync per sort) for the
trivial-pass skip; then, per column (least significant first), one
partition stage per digit that is not skipped. The first pass reads the
caller's columns; the passes then ping-pong between the result's columns,
allocated up front, and one scratch set, in the order that makes the last
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
    """Stable LSD sort of key columns via the stage kernel.

    limbs[k]: (N,) contiguous key column, most significant first,
    torch.uint32 or 8 bytes wide (its words order as u64); limb_bits[k] =
    (begin, end): the bits of column k, of its 32 or 64, that take part in
    the order. payloads: (N,) contiguous columns, torch.uint32 or 8 bytes
    wide, that follow the permutation. A bit range that is not
    width-aligned is sorted through a masked copy of the column as the key,
    with the original column riding along (CUB begin_bit/end_bit
    semantics). Returns (limbs, payloads): fresh columns of the inputs'
    dtypes; the inputs are never written and never returned.
    """
    global ROWS
    width = cfg.radix_bits  # digit width of one stage: 2, 4 or 8
    n = limbs[0].numel()
    ROWS += n
    columns = list(limbs) + list(payloads)
    n_limbs = len(limbs)

    # every column's stage histograms in one read, and their maxima on the
    # host in one sync: a stage whose digit puts every key in one bucket is
    # the identity and is skipped (CUB's dispatch copy shortcut)
    hist = hist_lib.limb_histograms(limbs, limb_bits, width)
    bases, maxima = hist_lib.bases_and_maxima(hist)
    hist_max = []
    if hist.shape[0]:
        with sync_span("lsd_maxima"):
            hist_max = maxima.tolist()
    rows = hist_lib.stage_rows(limbs, limb_bits, width)
    passes = [(k, shift) for k in range(n_limbs - 1, -1, -1)
              for shift in _stages_for(*limb_bits[k], width)
              if limb_bits[k][0] < limb_bits[k][1]
              and hist_max[rows[k, shift]] != n]

    # the result, and (for two passes or more) one scratch set: pass p
    # writes the result when an even number of passes follow it
    result = [torch.empty_like(c) for c in columns]
    if not passes:
        for r, c in zip(result, columns):
            r.copy_(c)
        return result[:n_limbs], result[n_limbs:]
    scratch = ([torch.empty_like(c) for c in columns] if len(passes) > 1
               else None)
    cur = columns
    masked, masked_limb = None, None  # the masked key copy, its ping-pong
    for p, (k, shift) in enumerate(passes):
        dst = result if (len(passes) - 1 - p) % 2 == 0 else scratch
        begin, end = limb_bits[k]
        if begin % width == 0 and end % width == 0:
            order = [k] + [i for i in range(len(columns)) if i != k]
            src, out = [cur[i] for i in order], [dst[i] for i in order]
        else:
            if masked_limb != k:  # the column as it stands, masked
                if masked is None or masked[0].dtype != cur[k].dtype:
                    masked = [torch.empty_like(cur[k]) for _ in range(2)]
                bits = 8 * cur[k].element_size()
                mask = ((1 << end) - 1) & ~((1 << begin) - 1)
                torch.bitwise_and(
                    hist_lib.signed_words(cur[k]),
                    mask - (1 << bits) if mask >> (bits - 1) else mask,
                    out=hist_lib.signed_words(masked[0]))
                masked_limb = k
            src = [masked[0]] + list(cur)
            out = [masked[1]] + list(dst)
            masked.reverse()
        stage_lib.partition_stage(src, bases[rows[k, shift]], shift=shift,
                                  width=width, out=out, config=cfg)
        cur = dst
    return result[:n_limbs], result[n_limbs:]
