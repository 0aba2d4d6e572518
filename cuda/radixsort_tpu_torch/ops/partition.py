"""Radix partition: a stable bucket partition of rows by key or key hash.

Counterpart of ``cuda/radixsort_tpu/ops/partition.py``. The bucket id of
each row is the top ``bits`` of its twiddled key (range partition) or of
its hash (hash partition); one ``sort_pairs`` over the ids' low ``bits``
bits moves the rows, so the stage kernel runs one 2-bit pass for
bits <= 2 and ceil(bits / radix_bits) passes otherwise. Offsets come from
a binary search of the sorted ids. Everything stays on the keys' device.

u32 bit patterns are carried in int32 views: an int32 multiply wraps as a
u32 multiply does, and a logical shift is an arithmetic shift and a mask
(CPU torch has no u32 ``*`` or ``>>``).
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.sort import sort_pairs
from cuda.radixsort_tpu_torch.utils.profiling import traced

HASH_MUL = 0x9E3779B1  # Fibonacci hashing constant
HASH_MUL2 = 0x85EBCA77


def _i32(value: int) -> int:
    """A u32 constant as the int32 with the same bits."""
    return value - (1 << 32) if value >= 1 << 31 else value


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of the u32 bits held in an int32 tensor."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def _u32_bits(keys: torch.Tensor) -> torch.Tensor:
    """keys converted to u32 as ``astype(uint32)`` converts them in the
    reference, as int32 bits: integers wrap modulo 2^32 (wider ones
    truncate, narrower signed ones sign-extend), floats truncate toward
    zero and saturate to [0, 2^32 - 1] (NaN to 0)."""
    d = keys.dtype
    if d == torch.uint32:
        return keys.view(torch.int32)
    if d.is_floating_point:
        v = torch.nan_to_num(keys.to(torch.float64), nan=0.0)
        v = v.clamp(0, (1 << 32) - 1).to(torch.int64)
    elif d in twiddle.PARTIAL:
        width = twiddle.bit_width(d)
        v = twiddle.signed_view(keys).to(torch.int64)
        if width < 64:
            v = v & ((1 << width) - 1)
    else:
        v = keys.to(torch.int64)
    return (v & 0xFFFFFFFF).to(torch.int32)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """The reference's u32 mix on int32 bits."""
    x = x * _i32(HASH_MUL)
    x = x ^ _shr(x, 15)
    x = x * _i32(HASH_MUL2)
    return x ^ _shr(x, 13)


@traced
def hash32(keys: torch.Tensor) -> torch.Tensor:
    """Cheap elementwise u32 mix for hash partitioning; non-u32 keys are
    converted to u32 first (as ``astype``). Returns torch.uint32."""
    return _mix(_u32_bits(keys)).view(torch.uint32)


@traced
def bucket_ids(keys: torch.Tensor, *, bits: int, by_hash: bool = False):
    """Bucket id (torch.uint32, in [0, 2**bits)) of each key: the top
    ``bits`` of the hash, or of the twiddled key. The hash reads a 4-byte
    key's bits (an f32 key hashes its bit pattern) and converts any other
    width (:func:`hash32`)."""
    width = twiddle.bit_width(keys.dtype)
    most = 32 if by_hash else min(width, 32)
    if not 1 <= bits <= most:
        raise ValueError(f"bits must be in [1, {most}] for {keys.dtype} "
                         f"keys; got {bits}")
    if by_hash:
        x = (twiddle.signed_view(keys).view(torch.int32)
             if keys.dtype.itemsize == 4 else _u32_bits(keys))
        return _shr(_mix(x), 32 - bits).view(torch.uint32)
    b = twiddle.signed_view(twiddle.twiddle_in(keys))
    if width < 64:
        b = b.to(torch.int64) & ((1 << width) - 1)
    top = (b >> (width - bits)) & ((1 << bits) - 1)
    return top.to(torch.int32).view(torch.uint32)


@traced
def partition(keys: torch.Tensor, values=None, *, bits: int,
              by_hash: bool = False,
              config: config_lib.SortConfig | None = None):
    """Stable partition into 2**bits buckets by the top ``bits`` of the
    twiddled key (range partition) or of its hash (hash partition).

    Returns (keys_out, values_out, offsets): offsets is (2**bits + 1,)
    int32, bucket b = rows [offsets[b], offsets[b+1]). values may be None
    (values_out is then None) or a tensor, list, tuple or dict of
    equal-length tensors."""
    cfg = config_lib.for_partition(config_lib.resolve(config), bits=bits)
    n = keys.shape[0]
    bkt = bucket_ids(keys, bits=bits, by_hash=by_hash)
    payload = (keys, values) if values is not None else (keys,)
    sids, pay = sort_pairs(bkt, payload, begin_bit=0, end_bit=bits,
                           config=cfg)
    queries = torch.arange(1 << bits, dtype=torch.int64, device=keys.device)
    ids64 = sids.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    offsets = torch.cat([
        torch.searchsorted(ids64, queries).to(torch.int32),
        torch.full((1,), n, dtype=torch.int32, device=keys.device)])
    if values is not None:
        return pay[0], pay[1], offsets
    return pay[0], None, offsets
