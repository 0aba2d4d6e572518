"""Segmented scans (scan-by-key): prefix scans that restart at run starts.

Counterpart of ``cuda/radixsort_tpu/ops/scan.py``. Parity:
cub::DeviceScan::{Inclusive,Exclusive}{Sum,Scan}ByKey and InclusiveScanInit:
segments are maximal runs of consecutive keys equal under ``equality_op``
(a run-based contract, not a global group-by).

Routes, by ``engine=`` (JAX's three values) and then by operator and dtype
(no size gate):
  * 'auto': named sum/min/max over int32, uint32 and float32 take the
    segmented-scan kernel (``kernels/scan.py``; its plain version on a CPU
    tensor), the rest the routes of 'xla';
  * 'pallas': the kernel, for those ops and dtypes only (another op raises
    JAX's ValueError, another dtype a TypeError);
  * 'xla': the routes that are not the kernel, on the tensor's own device:
    integer sums by the running sum minus its value at each segment head
    (exact, wrapping); everything else (float sums, min, max, prod, a
    callable op) by a flagged Hillis-Steele doubling.
Exclusive scans shift values one slot right within each segment (heads take
the operator's identity) and run the same inclusive machinery; ``init`` is
then combined from the left into every output element, CUB's per-segment
init contract.
"""

from __future__ import annotations

from typing import Callable

import torch

from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.kernels import scan as kscan
from cuda.radixsort_tpu_torch.utils.profiling import traced

_NAMED = ("sum", "prod", "min", "max")
ENGINES = ("auto", "pallas", "xla")


def _full(shape, value, dtype, device) -> torch.Tensor:
    """torch.full for any dtype; unsigned values beyond the signed range
    are written through the signed view of the same bits."""
    if dtype in twiddle.PARTIAL:
        width = twiddle.bit_width(dtype)
        value = int(value)  # a numpy scalar would not wrap to the signed view
        if value >= 1 << (width - 1):
            value -= 1 << width
        return torch.full(shape, value, dtype=twiddle.signed_dtype(dtype),
                          device=device).view(dtype)
    return torch.full(shape, value, dtype=dtype, device=device)


def _identity_of(op: str, dtype: torch.dtype):
    """The neutral element of a named op as a Python number."""
    if op == "sum":
        return 0
    if op == "prod":
        return 1
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _resolve_op(op, ident, dtype, device, *, need_identity):
    """(f, identity as a 0-d tensor or None) for a named or callable op."""
    if callable(op):
        if ident is None:
            if need_identity:
                raise ValueError("a callable op needs identity= (its "
                                 "neutral element) for exclusive scans")
            return op, None
    elif op not in _NAMED:
        raise ValueError(f"op must be callable or one of {list(_NAMED)}")
    else:
        ident = _identity_of(op, dtype)
        op = torch.mul if op == "prod" else (
            lambda a, b, name=op: kscan.combine(name, a, b))
    return op, _full((), ident, dtype, device)


def _head_flags(keys, equality_op):
    """True where a new run of equal consecutive keys begins."""
    cols = keys if isinstance(keys, (tuple, list)) else (keys,)
    if equality_op is None:
        cols = [twiddle.full_view(c) for c in cols]
        neq = cols[0][1:] != cols[0][:-1]
        for c in cols[1:]:
            neq = neq | (c[1:] != c[:-1])
    else:
        if len(cols) != 1:
            raise ValueError("equality_op takes a single key column")
        neq = ~equality_op(cols[0][:-1], cols[0][1:])
    return torch.cat([torch.ones(1, dtype=torch.bool, device=neq.device), neq])


def plain_scan_fast(x: torch.Tensor, op: str) -> torch.Tensor:
    """Unsegmented inclusive scan for the named ops 'max', 'min' and 'sum'
    (same dtype, sums wrap): the segmented-scan kernel with no heads for
    int32/uint32/float32 (it reads no flags), torch's cumulative ops for
    other dtypes."""
    if x.dim() == 1 and x.dtype in kscan.DTYPES:
        return kscan.segmented_scan(x.contiguous(), None, op)
    if op == "sum":
        return torch.cumsum(x, 0, dtype=x.dtype)
    return {"max": torch.cummax, "min": torch.cummin}[op](x, 0).values


@traced
def segmented_scan(values: torch.Tensor, head_flags: torch.Tensor, op="sum", *,
                   identity=None, exclusive: bool = False, init=None,
                   engine: str = "auto"):
    """Prefix-scan ``values`` with ``op``, restarting at every True in
    ``head_flags`` (position 0 is always a segment head).

    op: 'sum', 'prod', 'min', 'max' or an associative callable
    f(earlier, later) (then ``identity=`` is needed for exclusive scans).
    exclusive=True shifts the scan right within each segment; ``init``
    (optional) is combined from the left into every output element: for
    an inclusive scan CUB's InclusiveScanInit, for an exclusive scan the
    seed of each segment (ExclusiveScanByKey). engine: 'auto', 'pallas'
    (the scan kernel) or 'xla' (the routes that are not the kernel), as
    the module's docstring sets out."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}; got {engine!r}")
    f, ident = _resolve_op(op, identity, values.dtype, values.device,
                           need_identity=exclusive)
    n = values.shape[0]
    if n == 0:
        return values
    if engine == "pallas" and (callable(op) or op not in kscan.OPS):
        raise ValueError(f"op must be one of {list(kscan.OPS)}")
    flags = head_flags.to(torch.bool).clone()
    flags[0] = True
    if exclusive:
        shifted = twiddle.cat([ident.reshape(1), values[:-1]])
        values = twiddle.where(flags, ident, shifted)
    if engine == "pallas" or (engine == "auto" and op in kscan.OPS
                              and values.dtype in kscan.DTYPES):
        out = kscan.segmented_scan(values.contiguous(), flags, op)
    elif op == "sum" and not values.dtype.is_floating_point:
        out = kscan.segmented_cumsum(values, flags)
    else:
        out = kscan.segmented_doubling(values, flags, f)
    if init is not None:
        out = f(_full((), init, values.dtype, values.device), out)
    return out


@traced
def plain_scan(values: torch.Tensor, op, *, identity=None,
               exclusive: bool = False, init=None):
    """Whole-array prefix scan on the same machinery (no heads but the
    first): the route for custom operators."""
    n = values.shape[0]
    if n == 0:
        return values
    flags = torch.zeros((n,), dtype=torch.bool, device=values.device)
    return segmented_scan(values, flags, op, identity=identity,
                          exclusive=exclusive, init=init)


@traced
def reduce_with(values: torch.Tensor, op, init=None, *, identity=None):
    """Whole-array reduction for an associative op: a log-depth pairwise
    fold (halving loop). Returns a 0-d tensor."""
    f, _ = _resolve_op(op, identity, values.dtype, values.device,
                       need_identity=False)
    v = values
    while v.shape[0] > 1:
        m = v.shape[0] // 2
        head = f(v[:m], v[m:2 * m])
        v = head if v.shape[0] % 2 == 0 else twiddle.cat([head, v[-1:]])
    total = v[0]
    if init is not None:
        total = f(_full((), init, values.dtype, values.device), total)
    return total


@traced
def scan_by_key(keys, values: torch.Tensor, op="sum", *, identity=None,
                exclusive: bool = False, init=None,
                equality_op: Callable | None = None, engine: str = "auto"):
    """Scan ``values`` within runs of consecutive equal ``keys``.

    ``keys`` may be one tensor or a tuple of equal-length tensors (runs
    break where any column changes). op: 'sum', 'prod', 'min', 'max' or an
    associative callable (then pass identity=). engine as in
    :func:`segmented_scan`. Matches cub::DeviceScan::*ByKey semantics."""
    if values.shape[0] == 0:
        return values
    heads = _head_flags(keys, equality_op)
    return segmented_scan(values, heads, op, identity=identity,
                          exclusive=exclusive, init=init, engine=engine)
