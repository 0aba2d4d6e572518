"""Inclusive segmented scan: a prefix scan that restarts at every head flag.

Counterpart of ``cuda/radixsort_tpu/kernels/scan.py::segmented_scan_pallas``:
named ``sum``/``min``/``max`` over int32, uint32 and float32 values, with
bool (or uint8) head flags, or none (an unsegmented scan); position 0 is
always a head. On a CUDA tensor the wrapper launches the hand-written
single-pass kernel in ``csrc/scan.cu``; on a CPU tensor it runs
:func:`segmented_scan_plain`. There is no other route.

int32 and uint32 sums wrap, as in JAX. float32 min/max propagate NaN. A
float32 sum on the card associates differently from the plain version (a
flagged doubling, as JAX's CPU path); the two agree within 1e-5 of the
segment's running sum of |x|, and the card gives the same bits on every run.
Integer results and min/max agree bit for bit.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.utils import build

OPS = ("sum", "min", "max")
DTYPES = (torch.int32, torch.uint32, torch.float32)
TILE = 4096  # rows per block: kTile in csrc/scan.cu

LAUNCHES = 0  # calls of segmented_scan that launched the scan kernel


def _check(values: torch.Tensor, head_flags: torch.Tensor | None,
           op: str) -> None:
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}; got {op!r}")
    if values.dtype not in DTYPES:
        raise TypeError(f"values must be one of {DTYPES}; got {values.dtype}")
    if values.dim() != 1 or not values.is_contiguous():
        raise ValueError("values must be 1-D and contiguous; got shape "
                         f"{tuple(values.shape)}")
    if head_flags is None:
        return
    if head_flags.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"head_flags must be bool or uint8; got {head_flags.dtype}")
    if head_flags.shape != values.shape:
        raise ValueError("values and head_flags must be of one length; got "
                         f"{tuple(values.shape)} and {tuple(head_flags.shape)}")
    if head_flags.device != values.device:
        raise ValueError("values and head_flags must share one device")
    if not head_flags.is_contiguous():
        raise ValueError("head_flags must be contiguous")


def combine(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a o b for a named op, a the earlier operand. Unsigned dtypes (which
    CPU torch cannot add or compare) work on their signed views: sums on
    the same bits, min/max with the sign bit flipped."""
    if a.dtype in twiddle.PARTIAL:
        sa, sb = twiddle.signed_view(a), twiddle.signed_view(b)
        if op == "sum":
            return (sa + sb).view(a.dtype)
        sign = twiddle.sign_min(twiddle.bit_width(a.dtype))
        return (combine(op, sa ^ sign, sb ^ sign) ^ sign).view(a.dtype)
    return {"sum": torch.add, "min": torch.minimum,
            "max": torch.maximum}[op](a, b)


def start_positions(flags: torch.Tensor) -> torch.Tensor:
    """Position of each row's segment head (flags[0] must be set): the
    running max of the head positions, exact since positions increase."""
    pos = torch.arange(flags.shape[0], device=flags.device)
    return torch.cummax(torch.where(flags, pos, -1), 0).values


def segmented_cumsum(values: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented sum of integers: the running sum minus the
    exclusive running sum at each segment's head. Exact, wrapping in the
    values' dtype (unsigned on the signed view of the same bits)."""
    v = twiddle.full_view(values)
    cs = torch.cumsum(v, 0, dtype=v.dtype)
    out = cs - (cs - v)[start_positions(flags)]
    return out.view(values.dtype)


def segmented_doubling(values: torch.Tensor, flags: torch.Tensor, f):
    """Inclusive segmented scan for any associative f(earlier, later): a
    flagged Hillis-Steele doubling, ceil(log2 n) steps of shift + where."""
    n = values.shape[0]
    v, fl = values, flags
    d = 1
    while d < n:
        later = v[d:]
        v = twiddle.cat([v[:d],
                         twiddle.where(fl[d:], later, f(v[:-d], later))])
        fl = torch.cat([fl[:d], fl[d:] | fl[:-d]])
        d *= 2
    return v


def segmented_scan_plain(values: torch.Tensor,
                         head_flags: torch.Tensor | None,
                         op: str = "sum") -> torch.Tensor:
    """Plain PyTorch version: integer sums by :func:`segmented_cumsum`,
    float sums and min/max by :func:`segmented_doubling` (the routes the
    JAX package takes outside Pallas). ``head_flags=None`` is all-zero
    flags."""
    _check(values, head_flags, op)
    if values.numel() == 0:
        return values.clone()
    if head_flags is None:
        flags = torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    else:
        flags = head_flags.to(torch.bool).clone()
    flags[0] = True
    if op == "sum" and values.dtype != torch.float32:
        return segmented_cumsum(values, flags)
    return segmented_doubling(values, flags, lambda a, b: combine(op, a, b))


_DTYPE_CODE = {torch.int32: 0, torch.uint32: 1, torch.float32: 2}


def segmented_scan(values: torch.Tensor, head_flags: torch.Tensor | None,
                   op: str = "sum") -> torch.Tensor:
    """Inclusive segmented scan of 1-D int32/uint32/float32 ``values`` under
    ``op`` ('sum', 'min' or 'max'), restarting where ``head_flags`` (bool
    or uint8, same length) is set; position 0 is always a head.
    ``head_flags=None`` scans with no other head, without reading flags.
    Returns a new tensor of the values' dtype. On the card it lies at the
    values' offset from a 16-B boundary, so the kernel loads and stores
    aligned vectors even for a view such as ``x[1:]``."""
    global LAUNCHES
    if values.device.type == "cpu":
        return segmented_scan_plain(values, head_flags, op)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    _check(values, head_flags, op)
    lib = build.library()
    n = values.numel()
    if n == 0:
        return torch.empty_like(values)
    dev = values.device
    phase = values.data_ptr() % 16 // 4
    out = torch.empty(n + phase, dtype=values.dtype, device=dev)
    if phase:
        out = out[phase:]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        # the tile counter and one status word per tile (the values' offset
        # from a 16-B boundary adds up to 3 rows); the entry point zeroes it
        scratch = build.stream_scratch("scan", dev, stream,
                                       1 + -(-(n + 3) // TILE), torch.int64)
        err = lib.rs_segmented_scan(
            values.data_ptr(),
            None if head_flags is None else head_flags.data_ptr(),
            out.data_ptr(), n, _DTYPE_CODE[values.dtype], OPS.index(op),
            scratch.data_ptr(), scratch.numel(), stream)
    build.check(err, "segmented_scan")
    LAUNCHES += 1
    return out
