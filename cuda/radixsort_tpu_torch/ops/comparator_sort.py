"""Comparator sort: keys that are not radix-sortable (struct keys, a user's
comparator) take a comparison sort.

Counterpart of ``cuda/radixsort_tpu/ops/comparator_sort.py``. Parity:
cub::DeviceMergeSort::{SortKeys, SortPairs, StableSortKeys,
StableSortPairs} and thrust smart_sort's merge-sort fallback.

The same network as the reference, stage for stage, so that equal keys
land where the reference's network leaves them: p = the next power of two
above n, log2(p)(log2(p)+1)/2 compare-exchange stages, each a partner
gather (lane XOR stride) and elementwise selects; pads are edge copies that
order after every real row by their index; a pair swaps only when it is
strictly out of order for its direction; stability adds the original index
as a tie-break and costs a second comparator call per stage. Plain torch
(gathers and ``where``s per stage), as the reference is plain jnp: this is
a capability path of O(n log^2 n) gathers. Arithmetic keys under
``less``/``greater`` go to the radix engine instead (the compat layers
route them, as thrust's ``can_use_primitive_sort`` does).

Keys and values may be a tensor or a (nested) tuple, list or dict of
tensors of one leading length; leaves may have trailing dimensions, moved
as rows. Unsigned leaves move through ``twiddle``'s signed views; the
``less``/``greater`` markers compare them with the sign bit flipped. A
user's comparator over unsigned leaves is the user's code: where torch
refuses an operator on such a dtype, the sort raises ``TypeError`` naming
it.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.sort import _flatten, _unflatten
from cuda.radixsort_tpu_torch.utils.profiling import traced


def _ordered(t: torch.Tensor) -> torch.Tensor:
    """t, or for an unsigned dtype torch orders only in part, a signed view
    with the sign bit flipped: the same order, on operators torch has."""
    if t.dtype in twiddle.PARTIAL:
        return twiddle.signed_view(t) ^ twiddle.sign_min(
            twiddle.bit_width(t.dtype))
    return t


class Less:
    """std::less / thrust::less marker: a comparator, and recognised by the
    compat routers as "primitive sort OK" (thrust's
    ``can_use_primitive_sort``)."""

    def __call__(self, a, b):
        return _ordered(a) < _ordered(b)


class Greater:
    """std::greater / thrust::greater marker (primitive descending sort)."""

    def __call__(self, a, b):
        return _ordered(a) > _ordered(b)


less = Less()
greater = Greater()


def primitive_comparator(comp) -> tuple[bool, bool]:
    """(is_primitive, descending): whether ``comp`` is a less/greater marker,
    so callers can take the radix engine instead of the network."""
    if isinstance(comp, Less) or comp is Less:
        return True, False
    if isinstance(comp, Greater) or comp is Greater:
        return True, True
    return False, False


def _ceil_log2(n: int) -> int:
    return max(1, (n - 1).bit_length())


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """x with its last row repeated ``pad`` times (numpy's edge mode)."""
    if pad == 0:
        return x
    v = twiddle.full_view(x)
    return torch.cat([v, v[-1:].expand(pad, *v.shape[1:])]).view(x.dtype)


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (p,) mask shaped to broadcast against a (p, ...) column."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def _unsigned_leaves(leaves) -> list:
    return sorted({str(t.dtype) for t in leaves if t.dtype in twiddle.PARTIAL})


@traced
def comparator_sort(
    keys: Any,
    comp: Callable[[Any, Any], torch.Tensor],
    *,
    values: Any = None,
    stable: bool = True,
):
    """Sort by a strict-weak-order comparator.

    Args:
      keys: a tensor, or a tuple, list or dict of tensors of one leading
        length (a struct key); leaves may have trailing dimensions.
      comp: ``comp(a, b) -> bool tensor`` over structures shaped like
        ``keys``: True where ``a`` orders strictly before ``b`` (like a C++
        comparator; not <=).
      values: optional tensor or structure of payloads moved with the keys.
      stable: keep input order among comparator-equal keys (CUB
        StableSort*). ``False`` skips the second comparator call per stage
        (CUB Sort*: equal keys in the network's order).

    Returns:
      sorted keys, or ``(sorted_keys, permuted_values)`` when ``values`` is
      given.
    """
    key_leaves: list = []
    key_spec = _flatten(keys, key_leaves)
    if not key_leaves:
        raise TypeError("keys have no tensor leaves")
    n = key_leaves[0].shape[0]
    for leaf in key_leaves:
        if leaf.shape[0] != n:
            raise ValueError("key leaves disagree on leading length")
    val_leaves: list = []
    val_spec = _flatten(values, val_leaves) if values is not None else None
    for leaf in val_leaves:
        if leaf.shape[0] != n:
            raise ValueError("value leaves disagree with keys on length")

    if n <= 1:
        return keys if values is None else (keys, values)

    logp = _ceil_log2(n)
    p = 1 << logp
    nk = len(key_leaves)
    dev = key_leaves[0].device
    cols = [_pad_rows(x, p - n) for x in key_leaves + val_leaves]
    lane = torch.arange(p, dtype=torch.int64, device=dev)
    # the original position: the stability tie-break and the validity
    # order at once (pads have index >= n and sort after every real row)
    idx = lane

    def call(a_cols, b_cols):
        a = _unflatten(key_spec, iter(a_cols[:nk]))
        b = _unflatten(key_spec, iter(b_cols[:nk]))
        try:
            return comp(a, b)
        except (RuntimeError, NotImplementedError, TypeError) as err:
            unsigned = _unsigned_leaves(key_leaves)
            if unsigned:
                raise TypeError(
                    f"the comparator failed on key dtype(s) {unsigned}, on "
                    f"which torch implements only some operators; compare "
                    f"a signed view (twiddle.signed_view) in the "
                    f"comparator: {err}") from err
            raise

    def pair_lt(a_cols, a_idx, b_cols, b_idx):
        """Strict total order: comp, then (stable / validity) the index."""
        a_first = call(a_cols, b_cols)
        a_real = a_idx < n
        b_real = b_idx < n
        if stable:
            b_first = call(b_cols, a_cols)
            tie = ~(a_first | b_first)
            a_first = a_first | (tie & (a_idx < b_idx))
        # pads order after every real row (their keys are edge copies, so
        # comp may claim otherwise: validity overrides)
        return (a_real & ~b_real) | (a_real & b_real & a_first)

    for k in range(1, logp + 1):
        asc = (lane & (1 << k)) == 0
        for jbit in range(k - 1, -1, -1):
            partner = lane ^ (1 << jbit)
            low = lane < partner
            p_cols = [twiddle.take(c, partner) for c in cols]
            p_idx = idx[partner]
            # the pair's low-lane and high-lane rows (the same on both lanes)
            a_cols = [twiddle.where(_rows(low, c), c, pc)
                      for c, pc in zip(cols, p_cols)]
            a_idx = torch.where(low, idx, p_idx)
            b_cols = [twiddle.where(_rows(low, c), pc, c)
                      for c, pc in zip(cols, p_cols)]
            b_idx = torch.where(low, p_idx, idx)
            # strictly out of order for this direction -> swap (the same
            # decision on both lanes of the pair)
            swap = torch.where(asc, pair_lt(b_cols, b_idx, a_cols, a_idx),
                               pair_lt(a_cols, a_idx, b_cols, b_idx))
            cols = [twiddle.where(_rows(swap, c), pc, c)
                    for c, pc in zip(cols, p_cols)]
            idx = torch.where(swap, p_idx, idx)

    cols = [c[:n] for c in cols]
    out_keys = _unflatten(key_spec, iter(cols[:nk]))
    if values is None:
        return out_keys
    return out_keys, _unflatten(val_spec, iter(cols[nk:]))


@traced
def comparator_argsort(
    keys: Any,
    comp: Callable[[Any, Any], torch.Tensor],
    *,
    stable: bool = True,
) -> torch.Tensor:
    """The int32 permutation that sorts ``keys`` under ``comp`` (stable by
    default)."""
    leaves: list = []
    _flatten(keys, leaves)
    iota = torch.arange(leaves[0].shape[0], dtype=torch.int32,
                        device=leaves[0].device)
    _, perm = comparator_sort(keys, comp, values=iota, stable=stable)
    return perm
