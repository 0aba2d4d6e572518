"""Thrust-shaped container API of the port: ``thrust::sort`` /
``sort_by_key`` / ``stable_sort*`` and their companion algorithms.

Counterpart of ``cuda/radixsort_tpu/thrust_compat.py``. The routing rule is
thrust's ``can_use_primitive_sort``: an arithmetic key under
``less``/``greater`` takes the radix engine; any other comparator takes the
comparison network of ``ops/comparator_sort.py`` (thrust's merge sort).

Differences from thrust, as in the reference:
  * functional: every algorithm returns its result instead of mutating a
    vector in place;
  * compacting algorithms (``copy_if``, ``unique``, ``partition``, ...)
    return ``(full_length_output, count)``: the valid prefix and a 0-d int32
    count on the device stand for thrust's returned end iterator;
  * execution policies are not taken: work runs on the inputs' device and
    the current stream. Functions that make data from nothing
    (``sequence``, ``tabulate``) take ``device=`` and default to the card.

Usage:

    from cuda.radixsort_tpu_torch import thrust_compat as thrust

    s = thrust.sort(keys)
    k, v = thrust.sort_by_key(keys, values)
    s = thrust.sort(recs, comp=lambda a, b: a["score"] > b["score"])
    kept, n = thrust.copy_if(x, lambda v: v % 3 == 0)
"""

from __future__ import annotations

from typing import Callable

import torch

from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.cub_compat import (DeviceSelect, _ordered,
                                                 _segment_reduce, _subtract,
                                                 _wide_sum)
from cuda.radixsort_tpu_torch.ops import setops as _setops
from cuda.radixsort_tpu_torch.ops.comparator_sort import (  # noqa: F401
    Greater,
    Less,
    comparator_argsort,
    comparator_sort,
    greater,
    less,
    primitive_comparator,
)
from cuda.radixsort_tpu_torch.ops.filter import filter_columns
from cuda.radixsort_tpu_torch.ops.merge import merge_sorted, merge_sorted_pairs
from cuda.radixsort_tpu_torch.ops.scan import (_full, plain_scan,
                                              plain_scan_fast, reduce_with,
                                              scan_by_key)
from cuda.radixsort_tpu_torch.ops.sort import _flatten, _unflatten, argsort
from cuda.radixsort_tpu_torch.ops.sort import sort as _sort
from cuda.radixsort_tpu_torch.ops.sort import sort_pairs
from cuda.radixsort_tpu_torch.ops.unique import _run_starts
from cuda.radixsort_tpu_torch.ops.unique import unique as _unique


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of like's dtype and device (unsigned values
    through their signed bits)."""
    return _full((), value, like.dtype, like.device)


def _eq(x: torch.Tensor, value) -> torch.Tensor:
    return twiddle.full_view(x) == twiddle.full_view(_scalar(value, x))


def _add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b, wrapping for unsigned dtypes (on their signed views)."""
    if a.dtype in twiddle.PARTIAL:
        return (twiddle.signed_view(a) + twiddle.signed_view(b)).view(a.dtype)
    return a + b


def _first_true(m: torch.Tensor) -> torch.Tensor:
    """Index of the first True in m, len(m) if none, as int32."""
    n = m.shape[0]
    if n == 0:
        return torch.zeros((), dtype=torch.int32, device=m.device)
    return torch.where(m.any(), m.to(torch.int8).argmax(), n).to(torch.int32)


def _shifted(keys):
    """(keys[:-1], keys[1:]) of a tensor or of every leaf of a structure."""
    leaves: list = []
    spec = _flatten(keys, leaves)
    return (_unflatten(spec, iter([t[:-1] for t in leaves])),
            _unflatten(spec, iter([t[1:] for t in leaves])))


def _exclusive(inc: torch.Tensor, init: torch.Tensor, op) -> torch.Tensor:
    """[init, op(init, inc[0]), ..., op(init, inc[n-2])]."""
    if inc.shape[0] == 0:
        return inc
    return twiddle.cat([init.reshape(1), op(init, inc[:-1])])


# ---------------------------------------------------------------------------
# sort family (thrust smart_sort)
# ---------------------------------------------------------------------------


def sort(keys, comp: Callable = less, *, config=None):
    """thrust::sort. Stable on the primitive path (the radix engine is
    stable); the comparator path leaves equal keys in the network's order,
    thrust's contract for plain ``sort``."""
    prim, desc = primitive_comparator(comp)
    if prim and isinstance(keys, torch.Tensor):
        return _sort(keys, descending=desc, config=config)
    return comparator_sort(keys, comp, stable=False)


def stable_sort(keys, comp: Callable = less, *, config=None):
    """thrust::stable_sort."""
    prim, desc = primitive_comparator(comp)
    if prim and isinstance(keys, torch.Tensor):
        return _sort(keys, descending=desc, config=config)
    return comparator_sort(keys, comp, stable=True)


def sort_by_key(keys, values, comp: Callable = less, *, config=None):
    """thrust::sort_by_key -> (sorted_keys, permuted_values). ``values`` may
    be a tensor or a tuple, list or dict of tensors (a zip_iterator of
    columns)."""
    return _sort_by_key(keys, values, comp, stable=False, config=config)


def stable_sort_by_key(keys, values, comp: Callable = less, *, config=None):
    """thrust::stable_sort_by_key."""
    return _sort_by_key(keys, values, comp, stable=True, config=config)


def _splittable(v: torch.Tensor) -> bool:
    """A value leaf the pair sort can carry: 1-D, or 2-D with at most 8
    columns of at most 4 bytes (each column one u32 plane)."""
    return v.dim() == 1 or (v.dim() == 2 and v.shape[1] <= 8
                            and v.element_size() <= 4)


def _stack_columns(cols) -> torch.Tensor:
    return torch.stack([twiddle.full_view(c) for c in cols], 1).view(
        cols[0].dtype)


def _sort_by_key(keys, values, comp, *, stable, config):
    prim, desc = primitive_comparator(comp)
    if not (prim and isinstance(keys, torch.Tensor)):
        return comparator_sort(keys, comp, values=values, stable=stable)
    leaves: list = []
    spec = _flatten(values, leaves)
    if all(v.dim() == 1 for v in leaves):
        # thrust::sort_by_key does not promise equal keys' payload order:
        # stable=False lets the network drop its index plane
        return sort_pairs(keys, values, descending=desc, config=config,
                          stable=stable)
    if not all(_splittable(v) for v in leaves):
        perm = argsort(keys, descending=desc, config=config).long()
        return (twiddle.take(keys, perm),
                _unflatten(spec, iter([twiddle.take(v, perm)
                                       for v in leaves])))
    # 2-D leaves of a few narrow columns (an (N, 3) point column) split
    # into one plane a column and ride the same pair sort
    planes, widths = [], []
    for v in leaves:
        cols = [v] if v.dim() == 1 else [v[:, j].contiguous()
                                         for j in range(v.shape[1])]
        planes += cols
        widths.append(None if v.dim() == 1 else len(cols))
    ok, out = sort_pairs(keys, planes, descending=desc, config=config,
                         stable=stable)
    it = iter(out)
    regrouped = [next(it) if w is None else _stack_columns(
        [next(it) for _ in range(w)]) for w in widths]
    return ok, _unflatten(spec, iter(regrouped))


def is_sorted(keys, comp: Callable = less) -> torch.Tensor:
    """thrust::is_sorted: no adjacent pair strictly out of order."""
    a, b = _shifted(keys)
    return ~torch.any(comp(b, a))


def is_sorted_until(keys, comp: Callable = less) -> torch.Tensor:
    """thrust::is_sorted_until: the length of the sorted prefix (int32)."""
    a, b = _shifted(keys)
    bad = comp(b, a)
    if bad.shape[0] == 0:  # 0 or 1 rows: all of them
        leaves: list = []
        _flatten(keys, leaves)
        return torch.full((), leaves[0].shape[0], dtype=torch.int32,
                          device=bad.device)
    return _first_true(bad) + 1


# ---------------------------------------------------------------------------
# merge and set companions
# ---------------------------------------------------------------------------


def merge(a, b, comp: Callable = less, *, config=None):
    """thrust::merge of two sorted ranges (less/greater comparators)."""
    prim, desc = primitive_comparator(comp)
    if not prim:
        raise NotImplementedError(
            "thrust_compat.merge supports less/greater; for a custom "
            "comparator sort the concatenation with stable_sort")
    return merge_sorted(a, b, descending=desc, config=config)


def merge_by_key(a_keys, a_values, b_keys, b_values, comp: Callable = less,
                 *, config=None):
    """thrust::merge_by_key (stable: ties keep a before b)."""
    prim, desc = primitive_comparator(comp)
    if not prim:
        raise NotImplementedError(
            "thrust_compat.merge_by_key supports less/greater")
    return merge_sorted_pairs(a_keys, a_values, b_keys, b_values,
                              descending=desc, config=config)


def set_intersection(a, b, *, config=None):
    """thrust::set_intersection (sorted multisets) -> (padded, count)."""
    return _setops.set_intersection(a, b, config=config)


def set_union(a, b, *, config=None):
    """thrust::set_union -> (padded, count)."""
    return _setops.set_union(a, b, config=config)


def set_difference(a, b, *, config=None):
    """thrust::set_difference -> (padded, count)."""
    return _setops.set_difference(a, b, config=config)


def set_symmetric_difference(a, b, *, config=None):
    """thrust::set_symmetric_difference -> (padded, count)."""
    return _setops.set_symmetric_difference(a, b, config=config)


def unique(keys, *, config=None):
    """thrust::unique (consecutive duplicates) -> (padded_keys, count)."""
    return _unique(keys, config=config)


def unique_by_key(keys, values, *, config=None):
    """thrust::unique_by_key -> (keys, values, count)."""
    return DeviceSelect.UniqueByKey(keys, values, config=config)


def unique_count(keys) -> torch.Tensor:
    """thrust::unique_count: the number of runs of equal keys."""
    return _run_starts(keys).sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# partition and selection
# ---------------------------------------------------------------------------


def copy_if(x, pred: Callable, *, config=None):
    """thrust::copy_if -> (padded_kept_rows, count)."""
    (out,), count = filter_columns(pred(x), (x,), config=config)
    return out, count


def remove_if(x, pred: Callable, *, config=None):
    """thrust::remove_if -> (padded_kept_rows, count) of the rows that do not
    match."""
    (out,), count = filter_columns(~pred(x).to(torch.bool), (x,),
                                   config=config)
    return out, count


def stable_partition(x, pred: Callable, *, config=None):
    """thrust::stable_partition -> (reordered, num_true): rows [0, num_true)
    satisfy pred, the rest do not, both parts in input order (the
    compaction keeps the dropped rows in order behind the kept ones)."""
    (out,), count = filter_columns(pred(x), (x,), config=config)
    return out, count


partition = stable_partition  # the partition here is always the stable one


def partition_copy(x, pred: Callable, *, config=None):
    """thrust::partition_copy -> (true_rows, false_rows, num_true)."""
    m = pred(x).to(torch.bool)
    (head,), count = filter_columns(m, (x,), config=config)
    (tail,), _ = filter_columns(~m, (x,), config=config)
    return head, tail, count


def partition_point(x, pred: Callable) -> torch.Tensor:
    """thrust::partition_point of an already partitioned range."""
    return pred(x).sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# reductions, scans and the rest of the container staples
# ---------------------------------------------------------------------------


def reduce(x, init=None, binary_op: Callable | None = None):
    """thrust::reduce (associative binary_op; default plus with init 0).
    The default sum widens integers to 64 bits, as numpy does."""
    if binary_op is None:
        total = _wide_sum(x) if x.dtype in twiddle.PARTIAL else torch.sum(x)
        if init is None:
            return total
        if total.dtype in twiddle.PARTIAL:  # init as a value of x's dtype
            init = int(init) % (1 << twiddle.bit_width(x.dtype))
            return _add(total, _full((), init, total.dtype, x.device))
        return total + _scalar(init, x)
    return reduce_with(x, binary_op, init)


_SEGMENT_OPS = {"sum": "sum", "min": "amin", "max": "amax", "prod": "prod"}


def reduce_by_key(keys, values, binary_op: str = "sum", *, config=None):
    """thrust::reduce_by_key: reduce runs of consecutive equal keys (sort
    first for a global group-by). binary_op: 'sum', 'min', 'max' or 'prod'.

    Returns (unique_keys, reduced_values, num_runs); reduced_values past
    num_runs hold the op's identity."""
    how = _SEGMENT_OPS[binary_op]
    run_id = plain_scan_fast(_run_starts(keys).to(torch.int32), "sum") - 1
    uk, count = _unique(keys, config=config)
    red = _segment_reduce(values, run_id.long(), keys.shape[0], how)
    return uk, red, count


def inclusive_scan(x, binary_op: Callable | None = None):
    """thrust::inclusive_scan (default: a sum in x's dtype, wrapping)."""
    if binary_op is None:
        return plain_scan_fast(x, "sum")
    return plain_scan(x, binary_op)


def exclusive_scan(x, init=0, binary_op: Callable | None = None):
    """thrust::exclusive_scan."""
    if binary_op is None:
        return _add(_subtract(plain_scan_fast(x, "sum"), x), _scalar(init, x))
    return _exclusive(plain_scan(x, binary_op), _scalar(init, x), binary_op)


def count(x, value) -> torch.Tensor:
    """thrust::count."""
    return _eq(x, value).sum(dtype=torch.int32)


def count_if(x, pred: Callable) -> torch.Tensor:
    """thrust::count_if."""
    return pred(x).sum(dtype=torch.int32)


def gather(index_map, src):
    """thrust::gather: out[i] = src[map[i]]."""
    return twiddle.take(src, index_map.long())


def scatter(src, index_map, out_len: int):
    """thrust::scatter: out[map[i]] = src[i] (map a permutation into
    [0, out_len)); rows no index reaches are 0."""
    out = torch.zeros((out_len,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    twiddle.full_view(out)[index_map.long()] = twiddle.full_view(src)
    return out


def sequence(n: int, init=0, step=1, dtype=torch.int32, *, device="cuda"):
    """thrust::sequence: init + i * step in ``dtype`` (wrapping), on
    ``device``."""
    sd = twiddle.signed_dtype(dtype) if dtype in twiddle.PARTIAL else dtype
    i = torch.arange(n, dtype=sd, device=device)
    ini = twiddle.full_view(_full((), init, dtype, device))
    stp = twiddle.full_view(_full((), step, dtype, device))
    return (ini + i * stp).view(dtype)


def min_element(x, comp: Callable = less) -> torch.Tensor:
    """thrust::min_element: the index of the first minimum (int32)."""
    prim, desc = primitive_comparator(comp)
    if prim:
        o = _ordered(x)
        return (torch.argmax(o) if desc else torch.argmin(o)).to(torch.int32)
    return comparator_argsort(x, comp, stable=True)[0]


def max_element(x, comp: Callable = less) -> torch.Tensor:
    """thrust::max_element: the index of the first maximum (int32)."""
    prim, desc = primitive_comparator(comp)
    if prim:
        o = _ordered(x)
        return (torch.argmin(o) if desc else torch.argmax(o)).to(torch.int32)
    # a stable sort under the reversed order puts the first maximum first
    return comparator_argsort(x, lambda a, b: comp(b, a), stable=True)[0]


def lower_bound(sorted_x, queries, comp: Callable = less) -> torch.Tensor:
    """thrust::lower_bound (vectorised; less/greater orders)."""
    return _bound(sorted_x, queries, comp, right=False)


def upper_bound(sorted_x, queries, comp: Callable = less) -> torch.Tensor:
    """thrust::upper_bound."""
    return _bound(sorted_x, queries, comp, right=True)


def binary_search(sorted_x, queries, comp: Callable = less) -> torch.Tensor:
    """thrust::binary_search: membership flags."""
    return (_bound(sorted_x, queries, comp, right=True)
            > _bound(sorted_x, queries, comp, right=False))


def _bound(sorted_x, queries, comp, *, right: bool) -> torch.Tensor:
    prim, desc = primitive_comparator(comp)
    if not prim:
        raise NotImplementedError("bounds support less/greater comparators")
    s, q = _ordered(sorted_x), _ordered(queries)
    if desc:
        pos = torch.searchsorted(torch.flip(s, [0]), q, right=not right)
        return (sorted_x.shape[0] - pos).to(torch.int32)
    return torch.searchsorted(s, q, right=right).to(torch.int32)


# ---------------------------------------------------------------------------
# scans by key (segments are runs of consecutive equal keys)
# ---------------------------------------------------------------------------


def inclusive_scan_by_key(keys, values, binary_op=None,
                          binary_pred: Callable | None = None):
    """thrust::inclusive_scan_by_key."""
    op = "sum" if binary_op is None else binary_op
    return scan_by_key(keys, values, op, equality_op=binary_pred)


def exclusive_scan_by_key(keys, values, init=0, binary_op=None,
                          binary_pred: Callable | None = None, *,
                          identity=None):
    """thrust::exclusive_scan_by_key: init seeds every segment. A callable
    binary_op needs identity= (its neutral element)."""
    op = "sum" if binary_op is None else binary_op
    return scan_by_key(keys, values, op, exclusive=True, init=init,
                       identity=identity, equality_op=binary_pred)


# ---------------------------------------------------------------------------
# elementwise and transform family (op applied per element: torch.func.vmap)
# ---------------------------------------------------------------------------


def for_each(x, op: Callable):
    """thrust::for_each, functional: op applied to each element."""
    return torch.func.vmap(op)(x)


def transform(op: Callable, *xs):
    """thrust::transform (unary, binary or n-ary)."""
    return torch.func.vmap(op)(*xs)


def transform_reduce(x, unary_op: Callable, init, binary_op: Callable):
    """thrust::transform_reduce."""
    return reduce_with(torch.func.vmap(unary_op)(x), binary_op, init)


def transform_inclusive_scan(x, unary_op: Callable, binary_op: Callable):
    """thrust::transform_inclusive_scan."""
    return plain_scan(torch.func.vmap(unary_op)(x), binary_op)


def transform_exclusive_scan(x, unary_op: Callable, init,
                             binary_op: Callable):
    """thrust::transform_exclusive_scan."""
    t = torch.func.vmap(unary_op)(x)
    return _exclusive(plain_scan(t, binary_op), _scalar(init, t), binary_op)


def tabulate(n: int, op: Callable, *, device="cuda"):
    """thrust::tabulate: op over the indices [0, n), made on ``device``."""
    return torch.func.vmap(op)(torch.arange(n, device=device))


def fill(x, value):
    """thrust::fill."""
    return _full(x.shape, value, x.dtype, x.device)


def replace(x, old_value, new_value):
    """thrust::replace."""
    return twiddle.where(_eq(x, old_value), _scalar(new_value, x), x)


def replace_if(x, pred: Callable, new_value):
    """thrust::replace_if."""
    return twiddle.where(pred(x), _scalar(new_value, x), x)


def adjacent_difference(x, binary_op: Callable | None = None):
    """thrust::adjacent_difference (out[0] = x[0], CUB SubtractLeft)."""
    op = _subtract if binary_op is None else binary_op
    return twiddle.cat([x[:1], op(x[1:], x[:-1])])


def inner_product(a, b, init=0):
    """thrust::inner_product."""
    return torch.sum(a * b) + _scalar(init, a)


def reverse(x):
    """thrust::reverse."""
    return twiddle.flip(x)


def swap_ranges(a, b):
    """thrust::swap_ranges, functional: returns (b, a)."""
    return b, a


# ---------------------------------------------------------------------------
# predicates and search
# ---------------------------------------------------------------------------


def all_of(x, pred: Callable) -> torch.Tensor:
    """thrust::all_of."""
    return torch.all(pred(x))


def any_of(x, pred: Callable) -> torch.Tensor:
    """thrust::any_of."""
    return torch.any(pred(x))


def none_of(x, pred: Callable) -> torch.Tensor:
    """thrust::none_of."""
    return ~torch.any(pred(x))


def find(x, value) -> torch.Tensor:
    """thrust::find: index of the first occurrence, len(x) if absent."""
    return _first_true(_eq(x, value))


def find_if(x, pred: Callable) -> torch.Tensor:
    """thrust::find_if: index of the first match, len(x) if none."""
    return _first_true(pred(x).to(torch.bool))


def mismatch(a, b) -> torch.Tensor:
    """thrust::mismatch: the first index where a and b differ (len if
    equal)."""
    return _first_true(twiddle.full_view(a) != twiddle.full_view(b))


def equal(a, b) -> torch.Tensor:
    """thrust::equal."""
    return torch.all(twiddle.full_view(a) == twiddle.full_view(b))
