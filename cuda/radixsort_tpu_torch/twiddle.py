"""Key-ordering traits: order-preserving bijections into unsigned bit space.

PyTorch counterpart of ``cuda.radixsort_tpu.twiddle`` (same semantics: CUB
``util_type.cuh:839-942`` — unsigned = identity, signed = XOR sign bit,
float = XOR sign bit if positive / full complement if negative — plus the
full complement for descending order; -0.0 is canonicalised to +0.0 on the
raw bits). NaNs follow the bit-pattern order this induces: positive NaNs
sort above +inf, negative NaNs below -inf.

CPU torch has no shifts, compares or ``where`` on uint16/32/64, so every
function works on the same-width *signed* view of the bits and returns the
unsigned view. Only XOR, AND, OR, NOT, signed compares and ``view`` are used.
``where``, ``cat``, ``take`` and ``flip`` move tensors of any dtype the same
way.
"""

from __future__ import annotations

import math

import torch

_UNSIGNED_OF = {
    torch.uint8: torch.uint8,
    torch.uint16: torch.uint16,
    torch.uint32: torch.uint32,
    torch.uint64: torch.uint64,
    torch.int8: torch.uint8,
    torch.int16: torch.uint16,
    torch.int32: torch.uint32,
    torch.int64: torch.uint64,
    torch.float16: torch.uint16,
    torch.bfloat16: torch.uint16,
    torch.float32: torch.uint32,
    torch.float64: torch.uint64,
}

_SIGNED_OF_WIDTH = {8: torch.int8, 16: torch.int16, 32: torch.int32,
                    64: torch.int64}

_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
_UNSIGNED = (torch.uint8, torch.uint16, torch.uint32, torch.uint64)


def bit_width(dtype: torch.dtype) -> int:
    """Number of key bits for a supported key dtype."""
    return dtype.itemsize * 8


def unsigned_dtype(dtype: torch.dtype) -> torch.dtype:
    """The unsigned bit-space dtype a key dtype twiddles into."""
    if dtype not in _UNSIGNED_OF:
        raise TypeError(f"unsupported radix-sort key dtype: {dtype}")
    return _UNSIGNED_OF[dtype]


def is_supported(dtype: torch.dtype) -> bool:
    """True for the twelve key dtypes the twiddle maps."""
    return dtype in _UNSIGNED_OF


def signed_dtype(dtype: torch.dtype) -> torch.dtype:
    """The signed integer dtype of the same width."""
    return _SIGNED_OF_WIDTH[bit_width(dtype)]


def signed_view(bits: torch.Tensor) -> torch.Tensor:
    """Same-width signed view of any 1/2/4/8-byte tensor (no copy)."""
    return bits.view(signed_dtype(bits.dtype))


def sign_min(width: int) -> int:
    """The sign bit as a value of the signed view (its minimum)."""
    return -(1 << (width - 1))


# ---------------------------------------------------------------------------
# moves that keep the bits, for every dtype
# ---------------------------------------------------------------------------
# torch implements only part of its operators for uint16/32/64 (CPU torch
# has no `<`, `flip` or `scatter` on them). These helpers move such tensors
# through their signed views of the same bits; other dtypes go straight to
# torch.

PARTIAL = (torch.uint16, torch.uint32, torch.uint64)


def full_view(t: torch.Tensor) -> torch.Tensor:
    """t, or for a dtype in PARTIAL its signed view: a view with the same
    bits that torch's operators all take (equality is kept)."""
    return signed_view(t) if t.dtype in PARTIAL else t


def where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where(cond, a, b) for tensors a and b of one dtype."""
    return torch.where(cond, full_view(a), full_view(b)).view(a.dtype)


def cat(tensors) -> torch.Tensor:
    """torch.cat of 1-D tensors of one dtype."""
    tensors = list(tensors)
    return torch.cat([full_view(t) for t in tensors]).view(tensors[0].dtype)


def take(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """t[index] for an integer index tensor."""
    return full_view(t)[index].view(t.dtype)


def flip(t: torch.Tensor) -> torch.Tensor:
    """t reversed along its first axis."""
    return torch.flip(full_view(t), [0]).view(t.dtype)


def greater(t: torch.Tensor, scalar) -> torch.Tensor:
    """t > scalar as numbers, for every dtype: a dtype in PARTIAL is
    compared through an int64 of the same order (an integer exceeds x when
    it exceeds floor(x))."""
    if t.dtype not in PARTIAL:
        return t > scalar
    width = bit_width(t.dtype)
    bound = math.floor(scalar)
    if not 0 <= bound < (1 << width) - 1:
        return torch.full(t.shape, bound < 0, dtype=torch.bool, device=t.device)
    if width < 64:
        return (signed_view(t).to(torch.int64) & ((1 << width) - 1)) > bound
    return (signed_view(t) ^ sign_min(64)) > bound + sign_min(64)


def twiddle_in(keys: torch.Tensor, descending: bool = False) -> torch.Tensor:
    """Map keys to unsigned bits whose unsigned order equals the sort order.
    Unsigned keys in ascending order are their own bits: the result is a
    view of ``keys`` (no copy), which callers read and never write."""
    d = keys.dtype
    u = unsigned_dtype(d)
    width = bit_width(d)
    sign = sign_min(width)
    raw = signed_view(keys)
    if d in _UNSIGNED:
        bits = raw
    elif d in _FLOATS:
        # canonicalise -0.0 (exactly the sign bit) to +0.0 on the raw bits,
        # so denormals never fall into the zero bucket
        raw = torch.where(raw == sign, torch.zeros_like(raw), raw)
        bits = torch.where(raw < 0, ~raw, raw | sign)
    else:  # signed integers
        bits = raw ^ sign
    if descending:
        bits = ~bits
    return bits.view(u)


def twiddle_out(bits: torch.Tensor, dtype: torch.dtype,
                descending: bool = False, *, copy: bool = True) -> torch.Tensor:
    """Inverse of :func:`twiddle_in` (modulo -0.0 canonicalisation).
    Unsigned keys in ascending order are copied out of ``bits``, or with
    ``copy=False`` (bits that only the caller holds, such as a sort's own
    output) returned as a view of them."""
    u = unsigned_dtype(dtype)
    if bits.dtype.itemsize != u.itemsize:
        raise TypeError(f"{bits.dtype} bits cannot hold {dtype} keys")
    width = bit_width(dtype)
    sign = sign_min(width)
    b = signed_view(bits)
    if descending:
        b = ~b
    if dtype in _UNSIGNED:
        out = b.clone() if copy and not descending else b
    elif dtype in _FLOATS:
        # sign bit clear in twiddled space = negative float: undo the full
        # complement; otherwise clear the sign bit that twiddle_in set
        out = torch.where(b >= 0, ~b, b & ~sign)
    else:
        out = b ^ sign
    return out.view(dtype)
