"""Plain-torch reference of the ``cccl_sort`` calls, and their controls.

Imports nothing of the program. The card's torch has no sort, compare or
indexing on uint32 and uint64, so keys are ordered through the signed
view of the same width with the sign bit flipped (its signed order is the
unsigned order of the keys) and gathered through signed views.
"""

from __future__ import annotations

import torch

_SIGNED = {torch.uint32: torch.int32, torch.uint64: torch.int64}
_SIGN = {torch.uint32: -2**31, torch.uint64: -2**63}


def _order_key(keys: torch.Tensor) -> torch.Tensor:
    return keys.view(_SIGNED[keys.dtype]) ^ _SIGN[keys.dtype]


def _gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return t.view(_SIGNED[t.dtype])[idx].view(t.dtype)


def _by_order(keys, values, idx) -> list:
    out = [_gather(keys, idx)]
    if values is not None:
        out.append(_gather(values, idx))
    return out


def expected(keys: torch.Tensor, values: torch.Tensor | None) -> list:
    """[keys ascending, values in the same stable order]."""
    idx = torch.sort(_order_key(keys), stable=True).indices
    return _by_order(keys, values, idx)


def mismatched_rows(got: list, want: list) -> int:
    """Rows where any output plane differs from the reference's bits."""
    if len(got) != len(want) or any(g.shape != w.shape
                                    for g, w in zip(got, want)):
        return max(w.numel() for w in want)
    bad = torch.zeros(want[0].shape, dtype=torch.bool, device=want[0].device)
    for g, w in zip(got, want):
        bad |= g.view(_SIGNED[g.dtype]) != w.view(_SIGNED[w.dtype])
    return int(bad.sum())


def control(name: str, keys: torch.Tensor, values) -> tuple:
    """The reference with one of the configuration's guarantees broken:

    skip_low_bits_<b>  the passes over the lowest b bits left out (the
                       order holds on the other bits only): exact order
                       broken
    reverse_ties       equal keys in reverse input order: stability broken
    """
    if name.startswith("skip_low_bits_"):
        bits = int(name.rsplit("_", 1)[1])
        idx = torch.sort(_order_key(keys) >> bits, stable=True).indices
    elif name == "reverse_ties":
        n = keys.shape[0]
        rev = torch.sort(_order_key(keys).flip(0), stable=True).indices
        idx = n - 1 - rev
    else:
        raise ValueError(f"no control {name!r}")
    return tuple(_by_order(keys, values, idx))
