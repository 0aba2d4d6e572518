"""LSD radix sort — the public sort surface of the port.

Counterpart of ``cuda/radixsort_tpu/ops/sort.py`` for its radix engine
(``_sort_limbs``' Pallas branch): keys are twiddled into unsigned bits,
split into u32 limbs (64-bit keys: hi, lo), and sorted least significant
limb first by the histogram and stage kernels; payloads ride along as u32
planes. Every sort here is stable, so ``stable=False`` returns the stable
result.

Parity: CUB DeviceRadixSort::{SortKeys, SortPairs} (+Descending) with
begin_bit/end_bit, and the decomposer protocol for struct keys.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.kernels import pipeline as kpipe

# Digit counts and bucket bases are int32, as in the JAX reference, so a
# bucket must hold fewer than 2^31 keys; lifting the limit is later work.
_DEVICE_MAX_N = (1 << 31) - 1

_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def _check_device_n(n: int) -> None:
    if n > _DEVICE_MAX_N:
        raise ValueError(f"device sort paths are limited to {_DEVICE_MAX_N} "
                         f"rows; got {n}")


def _check_1d(name: str, t: torch.Tensor, n: int, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor; got {type(t).__name__}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name} must be 1-D of length {n}; got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, keys on {device}")


# ---------------------------------------------------------------------------
# payload <-> u32 planes
# ---------------------------------------------------------------------------


def _widen_u32(p: torch.Tensor) -> torch.Tensor:
    """Bit-preserving widen of a sub-4-byte payload column to u32.
    Integers and bool widen by value (the narrow back is modular); f16/bf16
    widen their bits."""
    if p.dtype in _FLOATS:
        p = twiddle.signed_view(p)
        return (p.to(torch.int32) & 0xFFFF).view(torch.uint32)
    if p.dtype == torch.uint16:
        return (p.view(torch.int16).to(torch.int32) & 0xFFFF).view(torch.uint32)
    return p.to(torch.int32).view(torch.uint32)


def _narrow_u32(o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_widen_u32`."""
    o = o.view(torch.int32)
    if dtype in _FLOATS or dtype == torch.uint16:
        return o.to(torch.int16).view(dtype)
    return o.to(dtype)


def _to_planes(p: torch.Tensor):
    """A 1-D payload column -> (u32 planes, how to rebuild it)."""
    p = p.contiguous()
    size = p.dtype.itemsize
    if size == 4:
        return [p.view(torch.uint32)], ("view", p.dtype)
    if size < 4:
        return [_widen_u32(p)], ("narrow", p.dtype)
    if size == 8:
        lohi = p.view(torch.int32).reshape(-1, 2)
        return ([lohi[:, 0].contiguous().view(torch.uint32),
                 lohi[:, 1].contiguous().view(torch.uint32)], ("pair", p.dtype))
    raise TypeError(f"unsupported payload dtype {p.dtype}")


def _from_planes(planes, spec) -> torch.Tensor:
    how, dtype = spec
    if how == "view":
        return planes[0].view(dtype)
    if how == "narrow":
        return _narrow_u32(planes[0], dtype)
    lo, hi = (q.view(torch.int32) for q in planes)
    return torch.stack([lo, hi], dim=1).view(dtype).reshape(-1)


def _sort_limbs(limbs, limb_bits, payloads, cfg):
    """Stable LSD sort of u32 limb columns (most significant first) with
    payload columns of any supported dtype riding along."""
    planes, specs, counts = [], [], []
    for p in payloads:
        ps, spec = _to_planes(p)
        planes += ps
        specs.append(spec)
        counts.append(len(ps))
    out_limbs, out_planes = kpipe.sort_limbs(limbs, limb_bits, planes, cfg)
    out, i = [], 0
    for spec, c in zip(specs, counts):
        out.append(_from_planes(out_planes[i:i + c], spec))
        i += c
    return out_limbs, out


# ---------------------------------------------------------------------------
# key <-> limb columns
# ---------------------------------------------------------------------------


def _key_to_limbs(keys: torch.Tensor, descending: bool, begin_bit, end_bit):
    """Twiddle keys and split them into u32 limb columns, most significant
    first. Returns (limbs, limb_bits)."""
    width = twiddle.bit_width(keys.dtype)
    begin = 0 if begin_bit is None else begin_bit
    end = width if end_bit is None else end_bit
    if not 0 <= begin <= end <= width:
        raise ValueError(f"bad bit range [{begin}, {end}) for {keys.dtype}")
    bits = twiddle.signed_view(twiddle.twiddle_in(keys.contiguous(), descending))
    if width < 32:
        limb = (bits.to(torch.int32) & ((1 << width) - 1)).view(torch.uint32)
        return [limb], [(begin, end)]
    if width == 32:
        return [bits.view(torch.uint32)], [(begin, end)]
    # 64-bit keys: little-endian (lo, hi) halves of the bits
    lohi = bits.view(torch.int32).reshape(-1, 2)
    hi = lohi[:, 1].contiguous().view(torch.uint32)
    lo = lohi[:, 0].contiguous().view(torch.uint32)
    lo_range = (min(begin, 32), min(end, 32))
    hi_range = (max(begin, 32) - 32, max(end, 32) - 32)
    return [hi, lo], [hi_range, lo_range]


def _limbs_to_key(limbs, dtype: torch.dtype, descending: bool) -> torch.Tensor:
    width = twiddle.bit_width(dtype)
    u = twiddle.unsigned_dtype(dtype)
    if width < 32:
        narrow = torch.int8 if width == 8 else torch.int16
        bits = limbs[0].view(torch.int32).to(narrow).view(u)
    elif width == 32:
        bits = limbs[0]
    else:
        hi, lo = (q.view(torch.int32) for q in limbs)
        bits = torch.stack([lo, hi], dim=1).view(torch.int64).reshape(-1).view(u)
    return twiddle.twiddle_out(bits, dtype, descending=descending)


# ---------------------------------------------------------------------------
# pytrees of payloads (tensor, list, tuple, dict)
# ---------------------------------------------------------------------------


def _flatten(tree, leaves: list):
    if isinstance(tree, dict):
        return ("dict", [(k, _flatten(v, leaves)) for k, v in tree.items()])
    if isinstance(tree, (list, tuple)):
        return (type(tree), [_flatten(v, leaves) for v in tree])
    leaves.append(tree)
    return None


def _unflatten(spec, leaves):
    if spec is None:
        return next(leaves)
    kind, children = spec
    if kind == "dict":
        return {k: _unflatten(c, leaves) for k, c in children}
    return kind(_unflatten(c, leaves) for c in children)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def sort(keys: torch.Tensor, *, descending: bool = False,
         begin_bit: int | None = None, end_bit: int | None = None,
         config: config_lib.SortConfig | None = None) -> torch.Tensor:
    """Stable radix sort of a 1-D key tensor. Parity: DeviceRadixSort::SortKeys.
    With begin_bit/end_bit only those bits of the twiddled key order it."""
    cfg = config_lib.resolve(config)
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-D; got shape {tuple(keys.shape)}")
    _check_device_n(keys.shape[0])
    if keys.shape[0] == 0:
        return keys.clone()
    limbs, limb_bits = _key_to_limbs(keys, descending, begin_bit, end_bit)
    limbs, _ = _sort_limbs(limbs, limb_bits, [], cfg)
    return _limbs_to_key(limbs, keys.dtype, descending)


def sort_pairs(keys: torch.Tensor, values, *, descending: bool = False,
               begin_bit: int | None = None, end_bit: int | None = None,
               config: config_lib.SortConfig | None = None,
               stable: bool = True, unique_leading_payload: bool = False):
    """Key-value radix sort. ``values``: a tensor, or a list, tuple or dict
    of tensors (nested), each of leading dimension len(keys). Always stable
    (``stable=False`` is accepted for parity and gives the stable result).
    ``unique_leading_payload=True`` says the first value leaf is a unique
    u32 row tag; the JAX network engine then orders ties by that tag. The
    result here is the stable one, which is the same whenever the tag
    increases in input order. Parity: DeviceRadixSort::SortPairs."""
    del stable, unique_leading_payload  # stable by construction
    cfg = config_lib.resolve(config)
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-D; got shape {tuple(keys.shape)}")
    n = keys.shape[0]
    _check_device_n(n)
    leaves: list = []
    spec = _flatten(values, leaves)
    for i, v in enumerate(leaves):
        _check_1d(f"values leaf {i}", v, n, keys.device)
    if n == 0:
        return keys.clone(), _unflatten(spec, iter([v.clone() for v in leaves]))
    limbs, limb_bits = _key_to_limbs(keys, descending, begin_bit, end_bit)
    limbs, out = _sort_limbs(limbs, limb_bits, leaves, cfg)
    return (_limbs_to_key(limbs, keys.dtype, descending),
            _unflatten(spec, iter(out)))


def argsort(keys: torch.Tensor, *, descending: bool = False,
            begin_bit: int | None = None, end_bit: int | None = None,
            config: config_lib.SortConfig | None = None) -> torch.Tensor:
    """Stable argsort (int32 positions) through an index payload."""
    idx = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    _, perm = sort_pairs(keys, idx, descending=descending,
                         begin_bit=begin_bit, end_bit=end_bit, config=config)
    return perm


def sort_struct(key_columns, values=None, *, descending: bool = False,
                config: config_lib.SortConfig | None = None,
                stable: bool = True):
    """Stable lexicographic sort by several key columns, most significant
    first (each any supported key dtype). Returns the sorted key columns as
    a tuple, or (that tuple, sorted values) when values is given."""
    del stable  # always stable
    cols = list(key_columns)
    if not cols:
        raise ValueError("need at least one key column")
    n = cols[0].shape[0]
    _check_device_n(n)
    cfg = config_lib.resolve(config)
    for i, c in enumerate(cols):
        _check_1d(f"key column {i}", c, n, cols[0].device)
    leaves: list = []
    spec = _flatten(values, leaves) if values is not None else None
    for i, v in enumerate(leaves):
        _check_1d(f"values leaf {i}", v, n, cols[0].device)
    if n == 0:
        out_cols = tuple(c.clone() for c in cols)
        out = [v.clone() for v in leaves]
    else:
        limbs, limb_bits, spans = [], [], []
        for col in cols:
            lb, bb = _key_to_limbs(col, descending, None, None)
            spans.append(len(lb))
            limbs += lb
            limb_bits += bb
        limbs, out = _sort_limbs(limbs, limb_bits, leaves, cfg)
        out_cols, i = [], 0
        for col, span in zip(cols, spans):
            out_cols.append(_limbs_to_key(limbs[i:i + span], col.dtype,
                                          descending))
            i += span
        out_cols = tuple(out_cols)
    if values is None:
        return out_cols
    return out_cols, _unflatten(spec, iter(out))
