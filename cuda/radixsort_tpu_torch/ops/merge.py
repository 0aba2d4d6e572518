"""Merge of two sorted sequences.

Counterpart of ``cuda/radixsort_tpu/ops/merge.py``. Parity:
cub::DeviceMerge::{MergeKeys, MergePairs}: a stable two-way merge, equal
keys keep input order and a's rows come before b's.

Two routes, chosen by the engine alone (the JAX router looks at size and
backend instead; both routes give the same bits):

* 'bitonic': a ascending, then b reversed, each padded with 0xFFFFFFFF
  rows to 2^p, is a bitonic sequence, so one level of the network
  (``kernels/bitonic.py::merge_sorted_planes_bitonic``) merges it. Pairs
  carry a source-index plane as the last comparand (a's rows 0..na-1,
  b's na..), so the network merge is stable.
* otherwise, rank-scatter: each row's output position is its own rank
  plus a searchsorted into the other side (left for a, right for b, the
  stable tie order), applied with one scatter.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.kernels import bitonic as kbitonic
from cuda.radixsort_tpu_torch.ops.sort import (_MAX_U32, _flatten,
                                               _key_to_limbs, _limbs_to_key,
                                               _unflatten, apply_permutation)
from cuda.radixsort_tpu_torch.utils.profiling import traced


def ordered_i64(bits: torch.Tensor) -> torch.Tensor:
    """Unsigned twiddled bits (u8..u64) -> int64 with the same order, for
    torch.searchsorted (which has no unsigned compare)."""
    width = twiddle.bit_width(bits.dtype)
    s = twiddle.signed_view(bits)
    if width == 64:
        return s ^ (-(1 << 63))
    return s.to(torch.int64) & ((1 << width) - 1)


def _merge_ranks(abits: torch.Tensor, bbits: torch.Tensor):
    """Output positions of a's and b's rows in the merged order (ascending
    twiddled bits; a's rows before equal b's)."""
    a64, b64 = ordered_i64(abits), ordered_i64(bbits)
    dev = abits.device
    ra = torch.arange(a64.numel(), device=dev) + torch.searchsorted(b64, a64)
    rb = torch.arange(b64.numel(), device=dev) + torch.searchsorted(
        a64, b64, right=True)
    return ra, rb


def _network_merge(a_planes, b_planes, n_cmp: int):
    """Pad each side to 2^p (p >= 10) with 0xFFFFFFFF rows, reverse side b
    behind side a and run the top level of the network. Returns the merged
    planes, na + nb rows each."""
    na, nb = a_planes[0].shape[0], b_planes[0].shape[0]
    logp = max((max(na, nb) - 1).bit_length(), 10)
    p = 1 << logp
    planes = []
    for pa, pb in zip(a_planes, b_planes):
        buf = torch.empty(2 * p, dtype=torch.uint32, device=pa.device)
        buf[:na].copy_(pa)
        buf[na:2 * p - nb].view(torch.int32).fill_(_MAX_U32)
        buf[2 * p - nb:].copy_(twiddle.flip(pb))
        planes.append(buf)
    kbitonic.merge_sorted_planes_bitonic(planes, log_block=logp, n_cmp=n_cmp)
    return [q[:na + nb] for q in planes]


def _check_keys(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != b.dtype:
        raise TypeError(f"key dtypes differ: {a.dtype} vs {b.dtype}")
    if a.dim() != 1 or b.dim() != 1:
        raise ValueError("keys must be 1-D")
    if a.device != b.device:
        raise ValueError(f"keys on {a.device} and {b.device}")


@traced
def merge_sorted(a: torch.Tensor, b: torch.Tensor, *,
                 descending: bool = False,
                 config: config_lib.SortConfig | None = None) -> torch.Tensor:
    """Merge two 1-D key tensors, both sorted in the direction of
    ``descending``, into one sorted tensor. Parity: DeviceMerge::MergeKeys."""
    _check_keys(a, b)
    cfg = config_lib.resolve(config)
    na, nb = a.shape[0], b.shape[0]
    if na == 0 or nb == 0:
        return (b if na == 0 else a).clone()
    if cfg.engine == "bitonic":
        a_limbs, _ = _key_to_limbs(a, descending, None, None)
        b_limbs, _ = _key_to_limbs(b, descending, None, None)
        out = _network_merge(a_limbs, b_limbs, len(a_limbs))
        return _limbs_to_key(out, a.dtype, descending)
    abits = twiddle.twiddle_in(a, descending=descending)
    bbits = twiddle.twiddle_in(b, descending=descending)
    ra, rb = _merge_ranks(abits, bbits)
    (mbits,) = apply_permutation(torch.cat([ra, rb]),
                                 [twiddle.cat([abits, bbits])])
    return twiddle.twiddle_out(mbits, a.dtype, descending=descending)


@traced
def merge_sorted_pairs(a_keys: torch.Tensor, a_values, b_keys: torch.Tensor,
                       b_values, *, descending: bool = False,
                       config: config_lib.SortConfig | None = None):
    """Stable merge of two sorted key-value sequences. The values are a
    tensor, or lists, tuples or dicts of tensors of the same structure on
    both sides. Equal keys keep a-before-b order. On the 'bitonic' engine
    the network takes it where every value is 4 bytes wide and keys, index
    and values make at most 4 planes; otherwise rank-scatter.
    Parity: DeviceMerge::MergePairs."""
    _check_keys(a_keys, b_keys)
    cfg = config_lib.resolve(config)
    a_leaves: list = []
    b_leaves: list = []
    spec = _flatten(a_values, a_leaves)
    if _flatten(b_values, b_leaves) != spec:
        raise TypeError("value structures differ between a and b")
    na, nb = a_keys.shape[0], b_keys.shape[0]
    for side, keys, leaves in (("a", a_keys, a_leaves), ("b", b_keys, b_leaves)):
        for i, v in enumerate(leaves):
            if v.dim() != 1 or v.shape[0] != keys.shape[0]:
                raise ValueError(f"{side} values leaf {i} must be 1-D of "
                                 f"length {keys.shape[0]}")
    if na == 0 or nb == 0:
        keys, leaves = (b_keys, b_leaves) if na == 0 else (a_keys, a_leaves)
        return keys.clone(), _unflatten(spec, iter([v.clone() for v in leaves]))

    a_limbs, _ = _key_to_limbs(a_keys, descending, None, None)
    b_limbs, _ = _key_to_limbs(b_keys, descending, None, None)
    four_byte = all(p.dtype.itemsize == 4 for p in a_leaves + b_leaves)
    if (cfg.engine == "bitonic" and four_byte
            and len(a_limbs) + 1 + len(a_leaves) <= 4):
        dev = a_keys.device
        ia = torch.arange(na, dtype=torch.int32, device=dev)
        ib = torch.arange(na, na + nb, dtype=torch.int32, device=dev)
        au = [p.contiguous().view(torch.uint32) for p in a_leaves]
        bu = [p.contiguous().view(torch.uint32) for p in b_leaves]
        out = _network_merge(a_limbs + [ia.view(torch.uint32)] + au,
                             b_limbs + [ib.view(torch.uint32)] + bu,
                             len(a_limbs) + 1)
        k = len(a_limbs)
        keys = _limbs_to_key(out[:k], a_keys.dtype, descending)
        leaves = [o.view(p.dtype) for o, p in zip(out[k + 1:], a_leaves)]
        return keys, _unflatten(spec, iter(leaves))

    abits = twiddle.twiddle_in(a_keys, descending=descending)
    bbits = twiddle.twiddle_in(b_keys, descending=descending)
    ra, rb = _merge_ranks(abits, bbits)
    cols = [twiddle.cat([abits, bbits])] + [
        twiddle.cat([pa, pb]) for pa, pb in zip(a_leaves, b_leaves)]
    out = apply_permutation(torch.cat([ra, rb]), cols)
    keys = twiddle.twiddle_out(out[0], a_keys.dtype, descending=descending)
    return keys, _unflatten(spec, iter(out[1:]))
