"""LSD loop over u32 limb columns — plain torch glue around the two kernels.

Counterpart of ``cuda/radixsort_tpu/kernels/pipeline.py``. Before the first
pass, one histogram launch counts every stage of every limb (histograms do
not change under the permutations the passes apply) and the stages'
maxima are read to the host once (one sync per sort) for the trivial-pass
skip; then, per limb (least significant first), one partition stage per
digit. The stages ping-pong between two plane sets allocated once per sort.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch.kernels import histogram as hist_lib
from cuda.radixsort_tpu_torch.kernels import stage as stage_lib


def _stages_for(begin: int, end: int, width: int) -> list[int]:
    """Stage shifts covering the width-aligned hull of [begin, end), LSD
    order."""
    return [width * s for s in range(begin // width, -(-end // width))]


class _Slot:
    """One plane of the sort: its current tensor and two buffers to
    ping-pong between (allocated on first use)."""

    def __init__(self, tensor: torch.Tensor):
        self.cur = tensor
        self.bufs: list[torch.Tensor] = []

    def next_buffer(self) -> torch.Tensor:
        if not self.bufs:
            self.bufs = [torch.empty_like(self.cur), torch.empty_like(self.cur)]
        return self.bufs[1] if self.cur is self.bufs[0] else self.bufs[0]


def sort_limbs(limbs, limb_bits, payloads, cfg):
    """Stable LSD sort of u32 limb columns via the stage kernel.

    limbs[k]: (N,) contiguous torch.uint32, most significant first;
    limb_bits[k] = (begin, end): the bits of limb k that take part in the
    order. payloads: (N,) torch.uint32 planes that follow the permutation.
    A bit range that is not width-aligned is sorted through a masked copy of
    the limb as the key, with the original limb riding along (CUB
    begin_bit/end_bit semantics). Returns (limbs, payloads); the inputs are
    never written and never returned.
    """
    width = cfg.radix_bits  # digit width of one stage: 2, 4 or 8
    n = limbs[0].numel()
    limb_slots = [_Slot(t) for t in limbs]
    pay_slots = [_Slot(t) for t in payloads]
    masked = None  # slot of the masked key copy, for unaligned limbs

    # every limb's stage histograms in one read, and their maxima on the
    # host in one sync: a stage whose digit puts every key in one bucket is
    # the identity and is skipped (CUB's dispatch copy shortcut)
    hist = hist_lib.limb_histograms(limbs, limb_bits, width)
    bases = hist_lib.stage_bases(hist)
    hist_max = (hist_lib.counts64(hist).max(dim=1).values.tolist()
                if hist.shape[0] else [])
    ranges = hist_lib.limb_stages(limb_bits, width)  # (mask, n_stages)
    first_row = [sum(st for _, st in ranges[:k]) for k in range(len(ranges))]

    for k in range(len(limbs) - 1, -1, -1):
        begin, end = limb_bits[k]
        if begin >= end:
            continue
        if begin % width == 0 and end % width == 0:
            key = limb_slots[k]
            riders = [s for i, s in enumerate(limb_slots) if i != k]
        else:
            if masked is None:
                masked = _Slot(limbs[k])
            mask = ranges[k][0]
            buf = masked.next_buffer()
            torch.bitwise_and(limb_slots[k].cur.view(torch.int32),
                              mask - (1 << 32) if mask >= 1 << 31 else mask,
                              out=buf.view(torch.int32))
            masked.cur = buf
            key = masked
            riders = list(limb_slots)
        slots = [key] + riders + pay_slots

        for shift in _stages_for(begin, end, width):
            s = first_row[k] + shift // width
            if hist_max[s] == n:
                continue
            outs = [sl.next_buffer() for sl in slots]
            stage_lib.partition_stage([sl.cur for sl in slots], bases[s],
                                      shift=shift, width=width, out=outs,
                                      config=cfg)
            for sl, o in zip(slots, outs):
                sl.cur = o

    def result(slot, original):
        return slot.cur.clone() if slot.cur is original else slot.cur

    return ([result(s, t) for s, t in zip(limb_slots, limbs)],
            [result(s, t) for s, t in zip(pay_slots, payloads)])
