"""CUB-shaped surface of the port: DeviceRadixSort and the rest of CUB's
device-wide suite, for callers who know ``cub::Device*``.

Counterpart of ``cuda/radixsort_tpu/cub_compat.py``:

    from cuda.radixsort_tpu_torch.cub_compat import DeviceRadixSort, DoubleBuffer

    out = DeviceRadixSort.SortKeys(keys, begin_bit=0, end_bit=32)
    k, v = DeviceRadixSort.SortPairs(keys, values)
    k, v = DeviceRadixSort.SortPairsDescending(keys, values)
    buf = DoubleBuffer(keys)
    buf = DeviceRadixSort.SortKeys(buf)          # buf.current() is sorted

Differences from CUB, as in the reference:
  * no d_temp_storage size query: the caching allocator owns scratch;
  * functional: every call returns its result; a DoubleBuffer tracks which
    buffer is current so CUB-shaped call sites keep working;
  * selecting ops return full-length outputs and a count (a 0-d int32
    tensor on the device): rows [0, count) are the result;
  * ``num_items`` must equal the input's length (slice the tensor).

``stream``: a ``torch.cuda.Stream`` runs the call on that stream (the
kernels launch on the current stream and keep their scratch per stream);
anything else (None, 0) runs it on the current stream.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
from typing import Any

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.comparator_sort import (
    _ordered, comparator_sort, less, primitive_comparator)
from cuda.radixsort_tpu_torch.ops.filter import filter_columns
from cuda.radixsort_tpu_torch.ops.histogram import (histogram_even,
                                                   histogram_range)
from cuda.radixsort_tpu_torch.ops.merge import merge_sorted, merge_sorted_pairs
from cuda.radixsort_tpu_torch.ops.scan import (plain_scan, plain_scan_fast,
                                              reduce_with, scan_by_key)
from cuda.radixsort_tpu_torch.ops.segmented import segmented_sort as _segmented
from cuda.radixsort_tpu_torch.ops.select import top_k
from cuda.radixsort_tpu_torch.ops.sort import _flatten, _unflatten, argsort
from cuda.radixsort_tpu_torch.ops.sort import sort as _sort
from cuda.radixsort_tpu_torch.ops.sort import sort_pairs as _sort_pairs
from cuda.radixsort_tpu_torch.ops.sort import sort_struct
from cuda.radixsort_tpu_torch.ops.unique import (_run_starts,
                                                non_trivial_runs,
                                                run_length_encode, unique)


def _on_stream(stream):
    if isinstance(stream, torch.cuda.Stream):
        return torch.cuda.stream(stream)
    return contextlib.nullcontext()


def _streamed(fn):
    """A static method that runs under its ``stream`` argument."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def run(*args, **kw):
        with _on_stream(sig.bind(*args, **kw).arguments.get("stream")):
            return fn(*args, **kw)

    return staticmethod(run)


class DoubleBuffer:
    """cub::DoubleBuffer compatibility selector. A functional backend has no
    ping-pong buffers; this tracks "current" so CUB-shaped call sites keep
    working. After a sort, ``current()`` is the result and ``alternate()``
    the previous current (the selector flips, as in CUB)."""

    def __init__(self, current, alternate=None):
        self._bufs = [current, alternate]
        self.selector = 0

    def current(self):
        return self._bufs[self.selector]

    def alternate(self):
        return self._bufs[1 - self.selector]

    def _flip_to(self, new_current):
        self._bufs[1 - self.selector] = self._bufs[self.selector]
        self._bufs[self.selector] = new_current
        return self


def _unwrap(x):
    return (x.current(), True) if isinstance(x, DoubleBuffer) else (x, False)


def _rewrap(out, orig, was_buffer):
    return orig._flip_to(out) if was_buffer else out


def _check_items(keys, num_items):
    if num_items is not None and num_items != keys.shape[0]:
        raise ValueError(f"num_items={num_items} != len(keys)={keys.shape[0]}"
                         " (slice the tensor)")


def _decomposed(keys, decomposer, begin_bit, end_bit, num_items):
    """The key columns a CUB decomposer maps the keys to, most significant
    first; decomposer sorts are full-width."""
    if begin_bit != 0 or end_bit is not None:
        raise ValueError("decomposer sorts are full-width lexicographic; "
                         "begin_bit/end_bit are not supported")
    cols = tuple(decomposer(keys))
    _check_items(cols[0], num_items)
    return cols


class DeviceRadixSort:
    """Parity: cub::DeviceRadixSort."""

    @_streamed
    def SortKeys(d_keys, num_items: int | None = None, begin_bit: int = 0,
                 end_bit: int | None = None, stream: Any = None, *,
                 decomposer=None, config=None):
        """``decomposer``: CUB's custom-type protocol, a callable mapping the
        keys to a tuple of arithmetic columns, most significant first; the
        sort is then the lexicographic struct sort and returns the sorted
        columns as a tuple."""
        return DeviceRadixSort._keys(d_keys, num_items, begin_bit, end_bit,
                                     decomposer, config, descending=False)

    @_streamed
    def SortKeysDescending(d_keys, num_items: int | None = None,
                           begin_bit: int = 0, end_bit: int | None = None,
                           stream: Any = None, *, decomposer=None,
                           config=None):
        return DeviceRadixSort._keys(d_keys, num_items, begin_bit, end_bit,
                                     decomposer, config, descending=True)

    @_streamed
    def SortPairs(d_keys, d_values, num_items: int | None = None,
                  begin_bit: int = 0, end_bit: int | None = None,
                  stream: Any = None, *, decomposer=None, config=None):
        return DeviceRadixSort._pairs(d_keys, d_values, num_items, begin_bit,
                                      end_bit, decomposer, config,
                                      descending=False)

    @_streamed
    def SortPairsDescending(d_keys, d_values, num_items: int | None = None,
                            begin_bit: int = 0, end_bit: int | None = None,
                            stream: Any = None, *, decomposer=None,
                            config=None):
        return DeviceRadixSort._pairs(d_keys, d_values, num_items, begin_bit,
                                      end_bit, decomposer, config,
                                      descending=True)

    @staticmethod
    def _keys(d_keys, num_items, begin_bit, end_bit, decomposer, config, *,
              descending):
        keys, wrapped = _unwrap(d_keys)
        if decomposer is not None:
            cols = _decomposed(keys, decomposer, begin_bit, end_bit,
                               num_items)
            return sort_struct(cols, descending=descending, config=config)
        _check_items(keys, num_items)
        out = _sort(keys, descending=descending, begin_bit=begin_bit,
                    end_bit=end_bit, config=config)
        return _rewrap(out, d_keys, wrapped)

    @staticmethod
    def _pairs(d_keys, d_values, num_items, begin_bit, end_bit, decomposer,
               config, *, descending):
        keys, kw = _unwrap(d_keys)
        values, vw = _unwrap(d_values)
        if decomposer is not None:
            cols = _decomposed(keys, decomposer, begin_bit, end_bit,
                               num_items)
            ok, ov = sort_struct(cols, values, descending=descending,
                                 config=config)
            return ok, _rewrap(ov, d_values, vw)
        _check_items(keys, num_items)
        ok, ov = _sort_pairs(keys, values, descending=descending,
                             begin_bit=begin_bit, end_bit=end_bit,
                             config=config)
        return _rewrap(ok, d_keys, kw), _rewrap(ov, d_values, vw)


class DeviceSegmentedRadixSort:
    """Parity: cub::DeviceSegmentedRadixSort (a stable sort per segment).
    Segments are contiguous: segment i is [begin[i], end[i]) with end[i] =
    begin[i+1]; ``d_end_offsets=None`` passes num_segments + 1 begins."""

    @staticmethod
    def _offsets(num_segments, d_begin_offsets, d_end_offsets):
        if d_end_offsets is None:
            return d_begin_offsets
        return torch.cat([d_begin_offsets[:num_segments],
                          d_end_offsets[num_segments - 1:num_segments]])

    @_streamed
    def SortKeys(d_keys, num_items: int | None = None,
                 num_segments: int | None = None, d_begin_offsets=None,
                 d_end_offsets=None, begin_bit: int = 0,
                 end_bit: int | None = None, stream: Any = None, *,
                 descending: bool = False, config=None):
        keys, wrapped = _unwrap(d_keys)
        _check_items(keys, num_items)
        ns = num_segments or (d_begin_offsets.shape[0] - 1)
        offs = DeviceSegmentedRadixSort._offsets(ns, d_begin_offsets,
                                                 d_end_offsets)
        out = _segmented(keys, offs, descending=descending,
                         num_segments_bound=ns, begin_bit=begin_bit,
                         end_bit=end_bit, config=config)
        return _rewrap(out, d_keys, wrapped)

    @_streamed
    def SortPairs(d_keys, d_values, num_items: int | None = None,
                  num_segments: int | None = None, d_begin_offsets=None,
                  d_end_offsets=None, begin_bit: int = 0,
                  end_bit: int | None = None, stream: Any = None, *,
                  descending: bool = False, config=None):
        keys, kw = _unwrap(d_keys)
        values, vw = _unwrap(d_values)
        _check_items(keys, num_items)
        ns = num_segments or (d_begin_offsets.shape[0] - 1)
        offs = DeviceSegmentedRadixSort._offsets(ns, d_begin_offsets,
                                                 d_end_offsets)
        ok, ov = _segmented(keys, offs, values, descending=descending,
                            num_segments_bound=ns, begin_bit=begin_bit,
                            end_bit=end_bit, config=config)
        return _rewrap(ok, d_keys, kw), _rewrap(ov, d_values, vw)

    @staticmethod
    def SortKeysDescending(*args, **kw):
        return DeviceSegmentedRadixSort.SortKeys(*args, descending=True,
                                                 **kw)

    @staticmethod
    def SortPairsDescending(*args, **kw):
        return DeviceSegmentedRadixSort.SortPairs(*args, descending=True,
                                                  **kw)


class DeviceSelect:
    """Parity: cub::DeviceSelect. Outputs are full length: rows [0, count)
    are selected, in input order; the rest follow in input order."""

    @_streamed
    def Flagged(d_in, d_flags, num_items: int | None = None,
                stream: Any = None, *, config=None):
        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        (out,), count = filter_columns(d_flags.to(torch.bool), (x,),
                                       config=config)
        return _rewrap(out, d_in, wrapped), count

    @_streamed
    def If(d_in, select_op, num_items: int | None = None,
           stream: Any = None, *, config=None):
        """select_op: an elementwise predicate (tensor -> bool tensor)."""
        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        (out,), count = filter_columns(select_op(x), (x,), config=config)
        return _rewrap(out, d_in, wrapped), count

    @_streamed
    def FlaggedIf(d_in, d_flags, select_op, num_items: int | None = None,
                  stream: Any = None, *, config=None):
        """Keep the items whose flag satisfies select_op (the predicate
        applies to the flag, not the item)."""
        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        (out,), count = filter_columns(select_op(d_flags).to(torch.bool),
                                       (x,), config=config)
        return _rewrap(out, d_in, wrapped), count

    @_streamed
    def Unique(d_in, num_items: int | None = None, stream: Any = None, *,
               config=None):
        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        out, count = unique(x, config=config)
        return _rewrap(out, d_in, wrapped), count

    @_streamed
    def UniqueByKey(d_keys, d_values, num_items: int | None = None,
                    stream: Any = None, *, config=None):
        k, kw = _unwrap(d_keys)
        v, vw = _unwrap(d_values)
        _check_items(k, num_items)
        (ok, ov), count = filter_columns(_run_starts(k), (k, v),
                                         config=config)
        return _rewrap(ok, d_keys, kw), _rewrap(ov, d_values, vw), count


def _rotate(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """torch.roll(t, -s) along rows for a count ``s`` that stays on the
    device: out[i] = t[(i + s) % n]."""
    n = t.shape[0]
    if n == 0:
        return t
    pos = (torch.arange(n, device=t.device) + s) % n
    return twiddle.take(t, pos)


class DevicePartition:
    """Parity: cub::DevicePartition. Stronger than CUB: the rejected rows
    at [num_selected, N) keep their input order (CUB reverses them)."""

    @_streamed
    def Flagged(d_in, d_flags, num_items: int | None = None,
                stream: Any = None, *, config=None):
        return DeviceSelect.Flagged(d_in, d_flags, num_items, stream,
                                    config=config)

    @_streamed
    def If(d_in, select_op, num_items: int | None = None,
           stream: Any = None, *, config=None):
        return DeviceSelect.If(d_in, select_op, num_items, stream,
                               config=config)

    @_streamed
    def ThreeWay(d_in, select_first_part_op, select_second_part_op,
                 num_items: int | None = None, stream: Any = None, *,
                 config=None):
        """Three-way split: the items matching the first predicate, then
        those matching the second (of the rest), then the unselected, each
        part in input order. One stable 2-bit counting pass on the part id,
        then each part is rotated to index 0 by its count on the device.

        ``d_in``: a tensor, or a tuple, list or dict of equal-length
        tensors (the predicates see the same structure). Returns
        (first_part, second_part, unselected, num_selected): each output
        full length and valid in its prefix, num_selected the (2,) int32
        counts of the first two parts."""
        x, _ = _unwrap(d_in)
        leaves: list = []
        spec = _flatten(x, leaves)
        _check_items(leaves[0], num_items)
        first = select_first_part_op(x).to(torch.bool)
        second = ~first & select_second_part_op(x).to(torch.bool)
        part = torch.where(first, 0, torch.where(second, 1, 2)).to(
            torch.int32).view(torch.uint32)
        cfg = config_lib.for_partition(config_lib.resolve(config), bits=2)
        _, out = _sort_pairs(part, x, begin_bit=0, end_bit=cfg.radix_bits,
                             config=cfg)
        n1 = first.sum(dtype=torch.int32)
        n2 = second.sum(dtype=torch.int32)
        out_leaves: list = []
        _flatten(out, out_leaves)

        def rotated(s):
            return _unflatten(spec, iter([_rotate(t, s) for t in out_leaves]))

        return out, rotated(n1), rotated(n1 + n2), torch.stack([n1, n2])


class DeviceRunLengthEncode:
    """Parity: cub::DeviceRunLengthEncode."""

    @_streamed
    def Encode(d_in, num_items: int | None = None, stream: Any = None, *,
               config=None):
        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return run_length_encode(x, config=config)

    @_streamed
    def NonTrivialRuns(d_in, num_items: int | None = None,
                       stream: Any = None, *, config=None):
        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return non_trivial_runs(x, config=config)


def _per_channel(spec, c):
    return spec[c] if isinstance(spec, (list, tuple)) else spec


def _channels(x, num_channels, num_active_channels, num_pixels):
    """(pixels, channels) samples, and the number of active channels."""
    if x.dim() == 1:
        if num_channels is None:
            raise ValueError("flat samples need num_channels=")
        x = x.reshape(-1, num_channels)
    _check_items(x, num_pixels)
    nact = x.shape[1] if num_active_channels is None else num_active_channels
    return x, nact


class DeviceHistogram:
    """Parity: cub::DeviceHistogram. num_levels follows CUB: bins =
    num_levels - 1."""

    @_streamed
    def HistogramEven(d_samples, num_levels: int, lower_level, upper_level,
                      num_samples: int | None = None, stream: Any = None):
        x, _ = _unwrap(d_samples)
        _check_items(x, num_samples)
        return histogram_even(x, num_levels - 1, lower_level, upper_level)

    @_streamed
    def HistogramRange(d_samples, num_levels: int, d_levels,
                       num_samples: int | None = None, stream: Any = None):
        x, _ = _unwrap(d_samples)
        _check_items(x, num_samples)
        return histogram_range(x, d_levels[:num_levels])

    @_streamed
    def MultiHistogramEven(d_samples, num_levels, lower_level, upper_level,
                           num_pixels: int | None = None,
                           stream: Any = None, *,
                           num_channels: int | None = None,
                           num_active_channels: int | None = None):
        """Interleaved multi-channel histograms (e.g. RGBA pixels):
        d_samples is (pixels, channels) or flat and channel-interleaved; one
        histogram per active channel, each with its own levels (a list
        gives one value a channel)."""
        x, _ = _unwrap(d_samples)
        x, nact = _channels(x, num_channels, num_active_channels, num_pixels)
        return tuple(
            histogram_even(x[:, c], _per_channel(num_levels, c) - 1,
                           _per_channel(lower_level, c),
                           _per_channel(upper_level, c))
            for c in range(nact))

    @_streamed
    def MultiHistogramRange(d_samples, num_levels, d_levels,
                            num_pixels: int | None = None,
                            stream: Any = None, *,
                            num_channels: int | None = None,
                            num_active_channels: int | None = None):
        """Range-binned form of MultiHistogramEven: d_levels holds one
        levels tensor per active channel."""
        x, _ = _unwrap(d_samples)
        x, nact = _channels(x, num_channels, num_active_channels, num_pixels)
        return tuple(
            histogram_range(x[:, c], _per_channel(d_levels, c)[
                :_per_channel(num_levels, c)])
            for c in range(nact))


class DeviceMerge:
    """Parity: cub::DeviceMerge, less-comparator semantics
    (descending=True for greater); stable: ties keep the first input's
    rows first."""

    @_streamed
    def MergeKeys(d_keys1, d_keys2, num_items1: int | None = None,
                  num_items2: int | None = None, stream: Any = None, *,
                  descending: bool = False, config=None):
        a, _ = _unwrap(d_keys1)
        b, _ = _unwrap(d_keys2)
        _check_items(a, num_items1)
        _check_items(b, num_items2)
        return merge_sorted(a, b, descending=descending, config=config)

    @_streamed
    def MergePairs(d_keys1, d_values1, d_keys2, d_values2,
                   num_items1: int | None = None,
                   num_items2: int | None = None, stream: Any = None, *,
                   descending: bool = False, config=None):
        a, _ = _unwrap(d_keys1)
        b, _ = _unwrap(d_keys2)
        _check_items(a, num_items1)
        _check_items(b, num_items2)
        return merge_sorted_pairs(a, d_values1, b, d_values2,
                                  descending=descending, config=config)


def _subtract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b, wrapping for unsigned dtypes (on their signed views)."""
    if a.dtype in twiddle.PARTIAL:
        return (twiddle.signed_view(a) - twiddle.signed_view(b)).view(a.dtype)
    return a - b


def _exclusive_sum(x: torch.Tensor) -> torch.Tensor:
    return _subtract(plain_scan_fast(x, "sum"), x)


class DeviceScan:
    """Parity: cub::DeviceScan. Sums of int32, uint32, float32, int64 and
    uint64 run on the scan kernel (integer sums wrap, bit for bit; a float sum folds left to
    right, so it differs from another summation order in the last bits);
    custom operators run the doubling scan of ``ops/scan.py``."""

    @_streamed
    def ExclusiveSum(d_in, num_items: int | None = None, stream: Any = None):
        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        return _rewrap(_exclusive_sum(x), d_in, wrapped)

    @_streamed
    def InclusiveSum(d_in, num_items: int | None = None, stream: Any = None):
        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        return _rewrap(plain_scan_fast(x, "sum"), d_in, wrapped)

    @_streamed
    def ExclusiveScan(d_in, scan_op, initial_value,
                      num_items: int | None = None, stream: Any = None):
        """scan_op: an associative binary op (e.g. torch.minimum) on
        tensors; initial_value seeds the scan (out[0])."""
        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        if x.shape[0] == 0:
            return _rewrap(x, d_in, wrapped)
        init = torch.full((1,), initial_value, dtype=x.dtype, device=x.device)
        inc = plain_scan(x, scan_op, identity=initial_value)
        out = twiddle.cat([init, scan_op(init, inc[:-1])])
        return _rewrap(out, d_in, wrapped)

    @_streamed
    def InclusiveScan(d_in, scan_op, num_items: int | None = None,
                      stream: Any = None):
        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        return _rewrap(plain_scan(x, scan_op), d_in, wrapped)

    @_streamed
    def InclusiveScanInit(d_in, scan_op, init_value,
                          num_items: int | None = None, stream: Any = None):
        """Inclusive scan with ``init_value`` folded into the first element."""
        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        init = torch.full((), init_value, dtype=x.dtype, device=x.device)
        return _rewrap(scan_op(init, plain_scan(x, scan_op)), d_in, wrapped)

    # by-key scans: segments are runs of consecutive equal keys
    # (ops/scan.py's segmented scan)

    @_streamed
    def InclusiveSumByKey(d_keys_in, d_values_in,
                          num_items: int | None = None,
                          equality_op=None, stream: Any = None):
        k, _ = _unwrap(d_keys_in)
        v, wrapped = _unwrap(d_values_in)
        _check_items(v, num_items)
        out = scan_by_key(k, v, "sum", equality_op=equality_op)
        return _rewrap(out, d_values_in, wrapped)

    @_streamed
    def ExclusiveSumByKey(d_keys_in, d_values_in,
                          num_items: int | None = None,
                          equality_op=None, stream: Any = None):
        k, _ = _unwrap(d_keys_in)
        v, wrapped = _unwrap(d_values_in)
        _check_items(v, num_items)
        out = scan_by_key(k, v, "sum", exclusive=True,
                          equality_op=equality_op)
        return _rewrap(out, d_values_in, wrapped)

    @_streamed
    def InclusiveScanByKey(d_keys_in, d_values_in, scan_op,
                           num_items: int | None = None,
                           equality_op=None, stream: Any = None):
        """scan_op: 'sum', 'prod', 'min', 'max' or an associative binary
        op."""
        k, _ = _unwrap(d_keys_in)
        v, wrapped = _unwrap(d_values_in)
        _check_items(v, num_items)
        out = scan_by_key(k, v, scan_op, equality_op=equality_op)
        return _rewrap(out, d_values_in, wrapped)

    @_streamed
    def ExclusiveScanByKey(d_keys_in, d_values_in, scan_op, init_value,
                           num_items: int | None = None,
                           equality_op=None, stream: Any = None, *,
                           identity=None):
        """init_value seeds every segment (CUB's contract). A callable
        scan_op also needs identity= (its neutral element)."""
        k, _ = _unwrap(d_keys_in)
        v, wrapped = _unwrap(d_values_in)
        _check_items(v, num_items)
        out = scan_by_key(k, v, scan_op, exclusive=True, init=init_value,
                          identity=identity, equality_op=equality_op)
        return _rewrap(out, d_values_in, wrapped)


def _extreme(x: torch.Tensor, largest: bool) -> torch.Tensor:
    o = _ordered(x)
    m = o.max() if largest else o.min()
    if o is x:
        return m
    return (m ^ twiddle.sign_min(twiddle.bit_width(x.dtype))).view(x.dtype)


def _wide_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of an unsigned tensor as uint64 (wrapping at 2^64)."""
    if x.dtype == torch.uint64:
        return twiddle.signed_view(x).sum().view(torch.uint64)
    mask = (1 << twiddle.bit_width(x.dtype)) - 1
    return (twiddle.signed_view(x).to(torch.int64) & mask).sum().view(
        torch.uint64)


def _arg_extreme(x: torch.Tensor, largest: bool):
    o = _ordered(x)
    i = torch.argmax(o) if largest else torch.argmin(o)
    return i, twiddle.full_view(x)[i].view(x.dtype)


class DeviceReduce:
    """Parity: cub::DeviceReduce."""

    @_streamed
    def Sum(d_in, num_items: int | None = None, stream: Any = None):
        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        if x.dtype in twiddle.PARTIAL:  # a uint64 sum, as numpy widens
            return _wide_sum(x)
        return torch.sum(x)

    @_streamed
    def Min(d_in, num_items: int | None = None, stream: Any = None):
        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return _extreme(x, largest=False)

    @_streamed
    def Max(d_in, num_items: int | None = None, stream: Any = None):
        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return _extreme(x, largest=True)

    @_streamed
    def ArgMin(d_in, num_items: int | None = None, stream: Any = None):
        """(index, value) of the first minimum: CUB's KeyValuePair."""
        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return _arg_extreme(x, largest=False)

    @_streamed
    def ArgMax(d_in, num_items: int | None = None, stream: Any = None):
        """(index, value) of the first maximum."""
        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return _arg_extreme(x, largest=True)

    @_streamed
    def Reduce(d_in, reduction_op, init,
               num_items: int | None = None, stream: Any = None):
        """reduction_op: an associative binary op, folded pairwise; init is
        combined from the left (CUB passes it explicitly too)."""
        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return reduce_with(x, reduction_op, init)

    @_streamed
    def TransformReduce(d_in, reduction_op, transform_op, init,
                        num_items: int | None = None, stream: Any = None):
        """transform_op elementwise, then Reduce."""
        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return reduce_with(transform_op(x), reduction_op, init)

    @_streamed
    def ReduceByKey(d_keys_in, d_values_in, reduction_op=None,
                    num_items: int | None = None, stream: Any = None, *,
                    config=None):
        """Reduce runs of consecutive equal keys (run-based, like
        thrust::reduce_by_key; not a global group-by). reduction_op: None
        (sum), 'sum', 'prod', 'min', 'max' or an associative binary op.

        Returns (unique_keys, aggregates, num_runs), padded past num_runs:
        one segmented inclusive scan (each run's total lands on its last
        row), then one stable compaction of the run-end rows."""
        k, _ = _unwrap(d_keys_in)
        v, _ = _unwrap(d_values_in)
        _check_items(v, num_items)
        op = "sum" if reduction_op is None else reduction_op
        scanned = scan_by_key(k, v, op)
        kv = twiddle.full_view(k)
        ends = torch.cat([kv[1:] != kv[:-1],
                          torch.ones(min(1, k.shape[0]), dtype=torch.bool,
                                     device=k.device)])
        (uk, agg), num_runs = filter_columns(ends, (k, scanned),
                                             config=config)
        return uk, agg, num_runs


def _segment_reduce(x, seg, num_segments, how):
    """Reduce rows of x into num_segments slots by segment id (the identity
    where a slot gets no row). how: 'sum', 'prod', 'amin' or 'amax'."""
    if x.dtype in twiddle.PARTIAL:
        if how in ("sum", "prod"):
            return _segment_reduce(twiddle.signed_view(x), seg, num_segments,
                                   how).view(x.dtype)
        sign = twiddle.sign_min(twiddle.bit_width(x.dtype))
        return (_segment_reduce(_ordered(x), seg, num_segments, how)
                ^ sign).view(x.dtype)
    if how == "sum":
        out = torch.zeros((num_segments,) + x.shape[1:], dtype=x.dtype,
                          device=x.device)
        return out.index_add_(0, seg, x)
    if how == "prod":
        ident = 1
    elif x.dtype.is_floating_point:
        ident = float("inf") if how == "amin" else float("-inf")
    else:
        info = torch.iinfo(x.dtype)
        ident = info.max if how == "amin" else info.min
    out = torch.full((num_segments,), ident, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, seg, x, how, include_self=True)


class DeviceSegmentedReduce:
    """Parity: cub::DeviceSegmentedReduce. Segment i is [begin[i], end[i]);
    end=None means end[i] = begin[i+1] (begin then has num_segments + 1
    entries). Empty segments give the op's identity."""

    @staticmethod
    def _seg(d_in, num_segments, d_begin, d_end, how):
        x, _ = _unwrap(d_in)
        n = x.shape[0]
        dev = x.device
        ns = num_segments or (d_begin.shape[0] - 1)
        if ns == 0:
            return x[:0]
        begin = d_begin[:ns].to(torch.int32)
        end = (d_begin[1:ns + 1] if d_end is None else d_end[:ns]).to(
            torch.int32)
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        # empty segments (begin >= end) share begins with real ones and must
        # not win the search: push them past every row
        key = torch.where(begin >= end, n + 1, begin)
        order = argsort(key).long()
        pos = torch.searchsorted(key[order], idx, right=True).to(
            torch.int32) - 1
        s = order[pos.clamp(0, ns - 1).long()]
        # rows before the first segment or in a gap go to slot ns
        inside = (pos >= 0) & (idx >= begin[s]) & (idx < end[s])
        seg = torch.where(inside, s, ns)
        return _segment_reduce(x, seg, ns + 1, how)[:ns]

    @_streamed
    def Sum(d_in, num_segments: int | None = None, d_begin_offsets=None,
            d_end_offsets=None, stream: Any = None):
        return DeviceSegmentedReduce._seg(d_in, num_segments, d_begin_offsets,
                                          d_end_offsets, "sum")

    @_streamed
    def Min(d_in, num_segments: int | None = None, d_begin_offsets=None,
            d_end_offsets=None, stream: Any = None):
        return DeviceSegmentedReduce._seg(d_in, num_segments, d_begin_offsets,
                                          d_end_offsets, "amin")

    @_streamed
    def Max(d_in, num_segments: int | None = None, d_begin_offsets=None,
            d_end_offsets=None, stream: Any = None):
        return DeviceSegmentedReduce._seg(d_in, num_segments, d_begin_offsets,
                                          d_end_offsets, "amax")


class DeviceSegmentedSort:
    """Parity: cub::DeviceSegmentedSort. Both it and
    DeviceSegmentedRadixSort run the segment-id sort of ``ops/segmented.py``,
    which is stable, so Sort* == StableSort*."""

    SortKeys = staticmethod(DeviceSegmentedRadixSort.SortKeys)
    SortPairs = staticmethod(DeviceSegmentedRadixSort.SortPairs)
    SortKeysDescending = staticmethod(
        DeviceSegmentedRadixSort.SortKeysDescending)
    SortPairsDescending = staticmethod(
        DeviceSegmentedRadixSort.SortPairsDescending)
    StableSortKeys = staticmethod(DeviceSegmentedRadixSort.SortKeys)
    StableSortPairs = staticmethod(DeviceSegmentedRadixSort.SortPairs)
    StableSortKeysDescending = staticmethod(
        DeviceSegmentedRadixSort.SortKeysDescending)
    StableSortPairsDescending = staticmethod(
        DeviceSegmentedRadixSort.SortPairsDescending)


class DeviceAdjacentDifference:
    """Parity: cub::DeviceAdjacentDifference, copy forms (a functional
    backend); difference_op defaults to subtraction (wrapping for unsigned
    dtypes)."""

    @_streamed
    def SubtractLeftCopy(d_in, num_items: int | None = None,
                         difference_op=None, stream: Any = None):
        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        op = difference_op or _subtract
        out = twiddle.cat([x[:1], op(x[1:], x[:-1])])
        return _rewrap(out, d_in, wrapped)

    @_streamed
    def SubtractRightCopy(d_in, num_items: int | None = None,
                          difference_op=None, stream: Any = None):
        x, wrapped = _unwrap(d_in)
        _check_items(x, num_items)
        op = difference_op or _subtract
        out = twiddle.cat([op(x[:-1], x[1:]), x[-1:]])
        return _rewrap(out, d_in, wrapped)

    SubtractLeft = SubtractLeftCopy
    SubtractRight = SubtractRightCopy


class DeviceTopK:
    """Parity: cub::DeviceTopK on the radix select (``ops/select.py``).
    Ties at the threshold go to the smallest row index; results sorted."""

    @_streamed
    def MaxKeys(d_keys_in, k: int, num_items: int | None = None,
                stream: Any = None, *, config=None):
        x, _ = _unwrap(d_keys_in)
        _check_items(x, num_items)
        vals, _ = top_k(x, k, largest=True, config=config)
        return vals

    @_streamed
    def MinKeys(d_keys_in, k: int, num_items: int | None = None,
                stream: Any = None, *, config=None):
        x, _ = _unwrap(d_keys_in)
        _check_items(x, num_items)
        vals, _ = top_k(x, k, largest=False, config=config)
        return vals

    @_streamed
    def MaxPairs(d_keys_in, d_values_in, k: int,
                 num_items: int | None = None, stream: Any = None, *,
                 config=None):
        x, _ = _unwrap(d_keys_in)
        v, _ = _unwrap(d_values_in)
        _check_items(x, num_items)
        vals, idx = top_k(x, k, largest=True, config=config)
        return vals, twiddle.take(v, idx.long())

    @_streamed
    def MinPairs(d_keys_in, d_values_in, k: int,
                 num_items: int | None = None, stream: Any = None, *,
                 config=None):
        x, _ = _unwrap(d_keys_in)
        v, _ = _unwrap(d_values_in)
        _check_items(x, num_items)
        vals, idx = top_k(x, k, largest=False, config=config)
        return vals, twiddle.take(v, idx.long())


class DeviceTransform:
    """Parity: cub::DeviceTransform over N input sequences with an
    elementwise op on tensors."""

    @_streamed
    def Transform(d_inputs, transform_op, num_items: int | None = None,
                  stream: Any = None):
        ins = d_inputs if isinstance(d_inputs, (tuple, list)) else (d_inputs,)
        xs = [_unwrap(i)[0] for i in ins]
        _check_items(xs[0], num_items)
        return transform_op(*xs)


class DeviceMergeSort:
    """Parity: cub::DeviceMergeSort, the comparison sort beside
    DeviceRadixSort: custom comparators and struct keys.

    Routing follows thrust's smart_sort: a less/greater marker on a tensor
    takes the radix engine; everything else the comparator network
    (``ops/comparator_sort.py``). ``SortKeysCopy`` / ``StableSortKeysCopy``
    alias the plain entry points (a functional backend always copies)."""

    @_streamed
    def SortKeys(d_keys, num_items: int | None = None, compare_op=None,
                 stream: Any = None, *, stable: bool = False, config=None):
        comp = less if compare_op is None else compare_op
        keys, wrapped = _unwrap(d_keys)
        prim, desc = primitive_comparator(comp)
        if prim and isinstance(keys, torch.Tensor):
            _check_items(keys, num_items)
            out = _sort(keys, descending=desc, config=config)
        else:
            out = comparator_sort(keys, comp, stable=stable)
        return _rewrap(out, d_keys, wrapped)

    @_streamed
    def StableSortKeys(d_keys, num_items: int | None = None, compare_op=None,
                       stream: Any = None, *, config=None):
        return DeviceMergeSort.SortKeys(d_keys, num_items, compare_op,
                                        stream, stable=True, config=config)

    SortKeysCopy = SortKeys
    StableSortKeysCopy = StableSortKeys

    @_streamed
    def SortPairs(d_keys, d_values, num_items: int | None = None,
                  compare_op=None, stream: Any = None, *,
                  stable: bool = False, config=None):
        comp = less if compare_op is None else compare_op
        keys, kw = _unwrap(d_keys)
        values, vw = _unwrap(d_values)
        prim, desc = primitive_comparator(comp)
        if (prim and isinstance(keys, torch.Tensor)
                and isinstance(values, torch.Tensor)):
            _check_items(keys, num_items)
            ok, ov = _sort_pairs(keys, values, descending=desc,
                                 config=config)
        else:
            ok, ov = comparator_sort(keys, comp, values=values,
                                     stable=stable)
        return _rewrap(ok, d_keys, kw), _rewrap(ov, d_values, vw)

    @_streamed
    def StableSortPairs(d_keys, d_values, num_items: int | None = None,
                        compare_op=None, stream: Any = None, *, config=None):
        return DeviceMergeSort.SortPairs(d_keys, d_values, num_items,
                                         compare_op, stream, stable=True,
                                         config=config)


class DeviceCopy:
    """Parity: cub::DeviceCopy. All source ranges live in one flat tensor,
    all destinations in another, and the batch is one gather: a
    searchsorted attributes each destination row to its buffer."""

    @_streamed
    def Batched(d_src, d_dst, src_offsets, dst_offsets, sizes,
                num_buffers: int | None = None, stream: Any = None):
        """Copy range i: src[src_offsets[i] : +sizes[i]] into
        dst[dst_offsets[i] : +sizes[i]]. Destination ranges must not
        overlap (CUB's contract too); they need not be sorted. Returns the
        updated dst."""
        src, _ = _unwrap(d_src)
        dst, wrapped = _unwrap(d_dst)
        dev = dst.device
        so, do, sz = (torch.as_tensor(a, device=dev).to(torch.int64)
                      for a in (src_offsets, dst_offsets, sizes))
        if num_buffers is not None and so.shape[0] != num_buffers:
            raise ValueError(
                f"num_buffers={num_buffers} != offsets length {so.shape[0]}")
        nb = so.shape[0]
        if nb == 0:
            return _rewrap(dst, d_dst, wrapped)
        # a zero-size buffer whose dst offset lands inside another's range
        # would shadow it: push empty buffers past every destination row
        do = torch.where(sz > 0, do, dst.shape[0])
        order = torch.argsort(do, stable=True)
        so, do, sz = so[order], do[order], sz[order]
        i = torch.arange(dst.shape[0], device=dev)
        j = torch.searchsorted(do, i, right=True) - 1
        jc = j.clamp(0, nb - 1)
        rel = i - do[jc]
        covered = (j >= 0) & (rel < sz[jc])
        src_idx = (so[jc] + rel).clamp(0, max(src.shape[0] - 1, 0))
        rows = twiddle.take(src, src_idx) if src.shape[0] else dst
        out = twiddle.where(covered.reshape((-1,) + (1,) * (dst.dim() - 1)),
                            rows, dst)
        return _rewrap(out, d_dst, wrapped)


class DeviceMemcpy:
    """Parity: cub::DeviceMemcpy: the surface of DeviceCopy.Batched, ranges
    in elements of the given tensors (view as uint8 for bytes)."""

    Batched = DeviceCopy.Batched


class DeviceFor:
    """Parity: cub::DeviceFor. CUB's op(i) writes global state; the
    functional form returns op's value per index or item, stacked
    (``torch.func.vmap``). Index ranges are made on ``device``: the card
    unless the caller asks for the CPU."""

    @_streamed
    def Bulk(shape, op, stream: Any = None, *, device="cuda"):
        """op over the indices [0, shape); returns the stacked op(i)."""
        return torch.func.vmap(op)(torch.arange(shape, device=device))

    @_streamed
    def ForEach(d_in, op, num_items: int | None = None, stream: Any = None):
        x, _ = _unwrap(d_in)
        _check_items(x, num_items)
        return torch.func.vmap(op)(x)

    @_streamed
    def ForEachN(d_in, num_items: int, op, stream: Any = None):
        x, _ = _unwrap(d_in)
        return torch.func.vmap(op)(x[:num_items])

    # CUB's Copy forms differ only in how they load items
    ForEachCopy = ForEach
    ForEachCopyN = ForEachN

    @_streamed
    def ForEachInExtents(extents, op, stream: Any = None, *, device="cuda"):
        """op(i0, i1, ...) over the index grid of ``extents`` (a tuple of
        ints); returns a tensor shaped ``extents`` (plus op's own dims)."""
        grids = torch.meshgrid(
            *[torch.arange(e, device=device) for e in extents], indexing="ij")
        flat = [g.reshape(-1) for g in grids]
        out = torch.func.vmap(op)(*flat)
        return out.reshape(tuple(extents) + out.shape[1:])
