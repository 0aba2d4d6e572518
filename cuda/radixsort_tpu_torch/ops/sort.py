"""The public sort surface of the port: LSD radix sort and the network.

Counterpart of ``cuda/radixsort_tpu/ops/sort.py`` for its radix engine
(``_sort_limbs``' Pallas branch) and its bitonic engine: keys are twiddled
into unsigned bits, one key column each (u32, or 8 bytes for 64-bit keys;
narrower keys widen to u32), and payloads become u32 or 8-byte columns.

* engine 'radix' (and 'auto'): the key columns sort least significant
  first through the histogram and stage kernels, payloads riding along.
  Always stable, so ``stable=False`` gives the stable result. An 8-byte
  column goes in and comes out as one column (no split, no join, no copy
  of unsigned keys); :data:`STAGED_BYTES` counts the copies the sort API
  makes.
* engine 'bitonic': full-range keys-only sorts, argsorts of keys up to 32
  bits, and pair sorts of at most 4 u32 planes with payloads of at most 4
  bytes run the comparison network (``kernels/bitonic.py``), routed as the
  JAX engine routes them under ``interpret=True``; the rest (bit ranges,
  8-byte payloads, more planes, keys-only struct sorts) takes the stable
  radix path, which gives the stable result the JAX engine falls back to.
* engine 'reference': the same LSD passes on the same columns in plain
  torch with CUB's tile and spine layout (:func:`plan_passes`,
  :func:`counting_pass_reference`, :func:`apply_permutation`), on the
  tensors' own device: the oracle the JAX package calls its reference
  engine. It runs only where it is named.

The network alone sorts u32 planes: it splits an 8-byte key into its (hi,
lo) words on entry and joins them on exit (:func:`_u32_planes`,
:func:`_join_u32`).

:func:`sort_large` partitions 32-bit keys by their top bits on the kernels
and sorts the buckets in batches of bounded size.

Parity: CUB DeviceRadixSort::{SortKeys, SortPairs} (+Descending) with
begin_bit/end_bit, thrust::sort_by_key for ``stable=False``, and the
decomposer protocol for struct keys.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.kernels import bitonic as kbitonic
from cuda.radixsort_tpu_torch.kernels import histogram as hist_lib
from cuda.radixsort_tpu_torch.kernels import pipeline as kpipe
from cuda.radixsort_tpu_torch.utils.profiling import sync_span, traced

# Rows are indexed in int32 (index payloads); digit counts and bucket bases
# are u32 (one digit of 2^31 keys counts 2^31). Past 2^31 rows is the
# out-of-core domain (ops/external.py), as in the JAX reference.
_DEVICE_MAX_N = 1 << 31

_FLOATS = (torch.float16, torch.bfloat16, torch.float32, torch.float64)

# Bytes read plus bytes written by the torch copies that the sort API makes
# of a key or payload column on its way into or out of an engine's passes:
# a contiguous copy, a twiddle each way and a descending complement (signed
# and float keys; torch runs the float twiddle as several elementwise ops,
# counted as one), a widen or narrow of columns under 4 bytes, and the
# network's split and join of 8-byte keys. Each counts its least traffic:
# the column read once and written once. The masked-key copy inside
# sort_limbs belongs to the LSD loop and is not counted. The benchmark's
# sort.staged_bytes_per_row reads its delta.
STAGED_BYTES = 0


def _staged(n_bytes: int) -> None:
    global STAGED_BYTES
    STAGED_BYTES += n_bytes


def _twiddle_bytes(dtype: torch.dtype, n: int, descending: bool) -> int:
    """STAGED_BYTES of twiddling n keys one way: one pass for signed and
    float keys, one more for descending order."""
    passes = (twiddle.unsigned_dtype(dtype) != dtype) + descending
    return 2 * n * dtype.itemsize * passes


def _check_device_n(n: int) -> None:
    if n > _DEVICE_MAX_N:
        raise ValueError(
            f"device sort paths are int32-indexed (max {_DEVICE_MAX_N} "
            f"rows); got {n}. Use ops.external.sort_external / "
            "sort_external_pairs for out-of-core sizes.")


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


def _to_column(p: torch.Tensor):
    """A 1-D payload column -> (its column for the engines, u32 or 8 bytes
    wide, and how to rebuild it); the copies made are counted in
    STAGED_BYTES."""
    n, size = p.shape[0], p.dtype.itemsize
    if not p.is_contiguous():
        _staged(2 * n * size)
    p = p.contiguous()
    if size == 4:
        return p.view(torch.uint32), ("view", p.dtype)
    if size == 8:
        return p, ("view", p.dtype)
    if size < 4:
        _staged(n * (size + 4))
        return _widen_u32(p), ("narrow", p.dtype)
    raise TypeError(f"unsupported payload dtype {p.dtype}")


def _from_column(col: torch.Tensor, spec) -> torch.Tensor:
    """Inverse of :func:`_to_column` (a widened column narrows back)."""
    how, dtype = spec
    if how == "view":
        return col.view(dtype)
    _staged(col.shape[0] * (4 + dtype.itemsize))
    col = col.view(torch.int32)
    if dtype in _FLOATS or dtype == torch.uint16:
        return col.to(torch.int16).view(dtype)
    return col.to(dtype)


def _sort_limbs(limbs, limb_bits, payloads, cfg, stable: bool = True,
                unique_leading_payload: bool = False):
    """Sort key columns (most significant first, limb_bits[k] the bits of
    column k that order) with payload columns of any supported dtype
    riding along. The network takes the pair sorts it can serve
    (:func:`_network_pairs`); the reference engine runs its plain passes
    (:func:`_sort_limbs_reference`); everything else is the stable LSD
    sort on the kernels. Returns fresh key columns, which nothing else
    holds, and the payloads."""
    cols, specs = [], []
    for p in payloads:
        col, spec = _to_column(p)
        cols.append(col)
        specs.append(spec)
    out = None
    if cfg.engine == "bitonic":
        tag = (unique_leading_payload and bool(payloads)
               and payloads[0].dtype == torch.uint32)
        out = _network_pairs(limbs, limb_bits, cols, cfg, stable, tag)
    if out is None:
        lsd = (_sort_limbs_reference if cfg.engine == "reference"
               else kpipe.sort_limbs)
        out = lsd(limbs, limb_bits, cols, cfg)
    return out[0], [_from_column(c, spec) for c, spec in zip(out[1], specs)]


def apply_permutation(dest: torch.Tensor, arrays):
    """Scatter each 1-D array by out[dest[i]] = a[i] (dest a bijection)."""
    dest = dest.to(torch.int64)
    out = []
    for a in arrays:
        o = torch.empty_like(a)
        twiddle.full_view(o)[dest] = twiddle.full_view(a)
        out.append(o)
    return out


# ---------------------------------------------------------------------------
# the reference engine: CUB's tile and spine layout in plain torch
# ---------------------------------------------------------------------------


def plan_passes(begin_bit: int, end_bit: int,
                radix_bits: int) -> list[tuple[int, int]]:
    """[(shift, width), ...]: the LSD passes over [begin_bit, end_bit).
    As CUB (dispatch_radix_sort.cuh, alternative smaller-radix passes),
    the passes of radix_bits - 1 bits come first so that every pass is
    radix_bits or radix_bits - 1 wide; a radix of 1, or more short passes
    than passes, gives full-width passes and a shorter last one."""
    num_bits = end_bit - begin_bit
    if num_bits <= 0:
        return []
    num_passes = -(-num_bits // radix_bits)
    alt_bits = radix_bits - 1
    num_alt = num_passes * radix_bits - num_bits
    plan, shift = [], begin_bit
    if alt_bits == 0 or num_alt > num_passes:
        while shift < end_bit:
            w = min(radix_bits, end_bit - shift)
            plan.append((shift, w))
            shift += w
        return plan
    for p in range(num_passes):
        w = alt_bits if p < num_alt else radix_bits
        plan.append((shift, w))
        shift += w
    return plan


def _tile_histogram(digit_tiles: torch.Tensor, num_bins: int) -> torch.Tensor:
    """(T, n) digits -> (T, num_bins) int32 counts of each tile (CUB's
    upsweep)."""
    t = digit_tiles.shape[0]
    dev = digit_tiles.device
    flat = (digit_tiles + torch.arange(t, device=dev)[:, None] * num_bins)
    counts = torch.zeros(t * num_bins, dtype=torch.int32, device=dev)
    counts.scatter_add_(0, flat.reshape(-1),
                        torch.ones(flat.numel(), dtype=torch.int32,
                                   device=dev))
    return counts.reshape(t, num_bins)


def spine_scan(hist: torch.Tensor) -> torch.Tensor:
    """Exclusive scan over the striped spine: hist (T, B) -> base (B, T)
    int32, base[d, t] the first output row of digit d in tile t
    (digit-major, tile-minor, CUB's spine layout)."""
    spine = hist.T.reshape(-1).to(torch.int64)
    base = torch.cumsum(spine, 0) - spine
    return base.reshape(hist.shape[1], hist.shape[0]).to(torch.int32)


def _tile_rank(digit_tiles: torch.Tensor) -> torch.Tensor:
    """Stable rank of each row among the rows of its tile with its digit
    (CUB's block rank), from a stable argsort of each tile and the start of
    each run of equal digits."""
    t, n = digit_tiles.shape
    dev = digit_tiles.device
    order = torch.argsort(digit_tiles, dim=1, stable=True)
    sd = torch.gather(digit_tiles, 1, order)
    pos = torch.arange(n, device=dev).expand(t, n)
    is_start = torch.cat([torch.ones((t, 1), dtype=torch.bool, device=dev),
                          sd[:, 1:] != sd[:, :-1]], dim=1)
    run_start = torch.cummax(torch.where(is_start, pos, 0), dim=1).values
    rank = torch.zeros((t, n), dtype=torch.int32, device=dev)
    return rank.scatter_(1, order, (pos - run_start).to(torch.int32))


def counting_pass_reference(digits: torch.Tensor, num_bins: int,
                            tile_elems: int) -> torch.Tensor:
    """One stable counting pass: digits (N,) -> each row's destination
    (N,) int32, the spine base of its (digit, tile) plus its stable rank in
    the tile (CUB's downsweep). N must be a multiple of tile_elems."""
    n = digits.shape[0]
    if n % tile_elems:
        raise ValueError(f"{n} digits are not whole tiles of {tile_elems}")
    dt = digits.reshape(n // tile_elems, tile_elems).to(torch.int64)
    base = spine_scan(_tile_histogram(dt, num_bins))
    tile_idx = torch.arange(dt.shape[0], device=dt.device)[:, None]
    return (base[dt, tile_idx] + _tile_rank(dt)).reshape(-1)


def _sort_limbs_reference(limbs, limb_bits, payloads, cfg):
    """The reference engine's LSD sort of the columns
    :func:`kpipe.sort_limbs` takes: the key columns padded with all-ones
    rows to whole tiles (the pads sort last and stay there; without pads,
    copied), then per column, least significant first, one counting pass
    per :func:`plan_passes` pass over its bit range, every column scattered
    by its destinations."""
    n = limbs[0].shape[0]
    tile = cfg.tile_elems
    pad = -(-max(n, 1) // tile) * tile - n
    dev = limbs[0].device
    if pad:
        limbs = [twiddle.cat([c, torch.full(
            (pad,), -1, dtype=twiddle.signed_dtype(c.dtype),
            device=dev).view(c.dtype)]) for c in limbs]
        payloads = [twiddle.cat([p, torch.zeros(pad, dtype=p.dtype,
                                                device=dev)])
                    for p in payloads]
    else:
        limbs = [c.clone() for c in limbs]
    for k in range(len(limbs) - 1, -1, -1):
        begin, end = limb_bits[k]
        for shift, width in plan_passes(begin, end, cfg.radix_bits):
            digits = hist_lib.digits(limbs[k], shift, width)
            dest = counting_pass_reference(digits, 1 << width, tile)
            limbs = apply_permutation(dest, limbs)
            payloads = apply_permutation(dest, payloads)
    return [c[:n] for c in limbs], [p[:n] for p in payloads]


# ---------------------------------------------------------------------------
# the network engine (kernels/bitonic.py)
# ---------------------------------------------------------------------------

_MAX_U32 = -1  # 0xFFFFFFFF through the int32 view


def _not_u32(p: torch.Tensor) -> torch.Tensor:
    return (~p.view(torch.int32)).view(torch.uint32)


def _split_work_rows(n: int, logn: int) -> float:
    """Row work of the split-sort-merge route: the leading 2^(logn-1) rows,
    the remainder at its own power of two, and about a fifth of a padded
    pass for the top merge level."""
    npad = 1 << logn
    rest = n - (npad >> 1)
    n2 = 1 << max((rest - 1).bit_length(), 10)
    return (npad >> 1) + n2 + 0.2 * npad


def _split_sort_engages(n: int, logn: int, cfg) -> bool:
    """The split route engages where its row work beats the padded sort by
    10% and the padded size is at least 2^cfg.split_sort_min_logn.
    ``chip_smoke.py`` times the FK join's sort (2^27 + 2^24 rows) on both
    routes on the card (PERF.md)."""
    npad = 1 << logn
    if npad == n:
        return False
    return (logn >= cfg.split_sort_min_logn
            and _split_work_rows(n, logn) < 0.9 * npad)


def _bitonic_planes(planes, n: int, n_cmp: int, cfg):
    """Sort n rows of u32 planes on the network. Returns fresh planes of n
    rows (views of 2^max(bitlen(n-1), 10)-row buffers); the inputs are not
    written."""
    logn = max((n - 1).bit_length(), 10)
    dev = planes[0].device
    buf = [torch.empty(1 << logn, dtype=torch.uint32, device=dev)
           for _ in planes]
    _network_sort_into(buf, planes, n, logn, n_cmp, cfg)
    return [b[:n] for b in buf]


def _network_sort_into(buf, planes, n: int, logn: int, n_cmp: int, cfg):
    """Sort n rows of planes into buf (2^logn rows each): rows [0, n) take
    the sorted rows, the rest 0xFFFFFFFF pads, which sort last.

    A heavily padded sort with n_cmp > 0 takes the split-sort-merge route:
    the leading 2^(logn-1) rows sort ascending in place, the remainder
    sorts at its own power of two on complemented comparands and goes in
    descending, behind 0xFFFFFFFF pads, and one merge level finishes (the
    stable callers' index or tag comparand keeps the merge stable)."""
    npad = 1 << logn
    if n_cmp > 0 and _split_sort_engages(n, logn, cfg):
        n1 = npad >> 1
        rest = n - n1
        _network_sort_into([b[:n1] for b in buf], [p[:n1] for p in planes],
                           n1, logn - 1, n_cmp, cfg)
        comp = [_not_u32(p[n1:]) if i < n_cmp else p[n1:]
                for i, p in enumerate(planes)]
        low = _bitonic_planes(comp, rest, n_cmp, cfg)
        for i, (b, q) in enumerate(zip(buf, low)):
            b[n1:npad - rest].view(torch.int32).fill_(_MAX_U32)
            b[npad - rest:].copy_(_not_u32(q) if i < n_cmp else q)
        kbitonic.merge_sorted_planes_bitonic(buf, log_block=logn - 1,
                                             n_cmp=n_cmp)
        return
    for b, p in zip(buf, planes):
        b[:n].copy_(p)
        b[n:].view(torch.int32).fill_(_MAX_U32)
    kbitonic.sort_planes_bitonic(
        buf, n_cmp=n_cmp, log_tile=min(kbitonic.network_log_tile(len(buf)),
                                       logn))


def _network_pairs(limbs, limb_bits, payloads, cfg, stable: bool,
                   tag: bool):
    """The network route of a pair sort of key and payload columns
    (:func:`_to_column`), or None where the JAX engine does not take it: a
    bit range, a payload wider than 4 bytes, no payload or more than 4
    planes.

    Planes: the keys' u32 planes, then (stable) an index plane, then the
    payloads. The comparands are the keys and the index, so the order is
    total and the sort stable. With ``tag`` (a unique u32 first payload,
    ``unique_leading_payload``) that payload is the tie-break comparand
    instead of an index plane. Unstable: no index plane; at a power of two
    the tie-safe rule (n_cmp < 0), else every plane compares, since the
    0xFFFFFFFF pads would tie with real max-key rows and tie-safe cannot
    order them past the pads (ties are then bit-identical rows)."""
    full = all(b == 0 and e == 8 * c.element_size()
               for c, (b, e) in zip(limbs, limb_bits))
    four_byte = all(p.element_size() == 4 for p in payloads)
    n_keys = sum(c.element_size() // 4 for c in limbs)  # u32 planes
    n_total = n_keys + (1 if stable and not tag else 0) + len(payloads)
    if not (full and four_byte and payloads and n_total <= 4):
        return None
    n = limbs[0].shape[0]
    keys, pays = _u32_planes(limbs), list(payloads)
    if stable and tag:
        planes, n_cmp = keys + pays, n_keys + 1
    elif stable:
        idx = torch.arange(n, dtype=torch.int32, device=limbs[0].device)
        planes = keys + [idx.view(torch.uint32)] + pays
        n_cmp = n_keys + 1
    else:
        planes = keys + pays
        npad = 1 << max((n - 1).bit_length(), 10)
        n_cmp = -n_keys if npad == n else len(planes)
    out = _bitonic_planes(planes, n, n_cmp, cfg)
    skip = n_keys + (1 if stable and not tag else 0)
    return _join_u32(out[:n_keys], limbs), out[skip:]


def _u32_planes(limbs) -> list[torch.Tensor]:
    """The network's u32 planes of key columns, most significant first: a
    u32 column as it is, an 8-byte column as contiguous copies of its (hi,
    lo) words."""
    planes = []
    for c in limbs:
        if c.element_size() == 4:
            planes.append(c)
            continue
        _staged(16 * c.shape[0])
        words = c.view(torch.int32).reshape(-1, 2)
        planes += [words[:, w].contiguous().view(torch.uint32) for w in (1, 0)]
    return planes


def _join_u32(planes, limbs) -> list[torch.Tensor]:
    """Inverse of :func:`_u32_planes`: the network's planes as fresh
    columns of the dtypes of ``limbs``."""
    out, planes = [], iter(planes)
    for c in limbs:
        q = next(planes)
        if c.element_size() == 8:
            _staged(16 * c.shape[0])
            q = torch.stack([next(planes).view(torch.int32),
                             q.view(torch.int32)], dim=1).view(c.dtype)
        out.append(q.reshape(-1))
    return out


def _sort_keys_bitonic(keys: torch.Tensor, descending: bool, cfg):
    """Keys-only network sort: 1 plane, or (hi, lo) for 64-bit keys."""
    limbs, _ = _key_to_limbs(keys, descending, None, None)
    planes = _u32_planes(limbs)
    out = _bitonic_planes(planes, keys.shape[0], len(planes), cfg)
    return _limbs_to_key(_join_u32(out, limbs), keys.dtype, descending)


def _argsort_bitonic(keys: torch.Tensor, descending: bool, cfg):
    """Stable argsort of keys up to 32 bits wide on the network: (key,
    index) is a total order."""
    n = keys.shape[0]
    (limb,), _ = _key_to_limbs(keys, descending, None, None)
    idx = torch.arange(n, dtype=torch.int32, device=keys.device)
    out = _bitonic_planes([limb, idx.view(torch.uint32)], n, 2, cfg)
    return out[1].view(torch.int32)


# ---------------------------------------------------------------------------
# key <-> limb columns
# ---------------------------------------------------------------------------


def full_range(dtype: torch.dtype, begin_bit, end_bit) -> bool:
    """True when [begin_bit, end_bit) asks for every bit of the key."""
    return begin_bit in (None, 0) and end_bit in (None, twiddle.bit_width(dtype))


def _key_to_limbs(keys: torch.Tensor, descending: bool, begin_bit, end_bit):
    """Twiddle keys into one key column: ([column], [(begin, end)]), the
    column u32 (keys of up to 32 bits; narrower keys widened) or int64 (the
    bits of 64-bit keys), a view of the caller's keys for unsigned keys of
    4 or 8 bytes in ascending order; the copies made are counted in
    STAGED_BYTES."""
    width = twiddle.bit_width(keys.dtype)
    begin = 0 if begin_bit is None else begin_bit
    end = width if end_bit is None else end_bit
    if not 0 <= begin <= end <= width:
        raise ValueError(f"bad bit range [{begin}, {end}) for {keys.dtype}")
    n, size = keys.shape[0], keys.dtype.itemsize
    _staged((0 if keys.is_contiguous() else 2 * n * size)
            + _twiddle_bytes(keys.dtype, n, descending))
    bits = twiddle.signed_view(twiddle.twiddle_in(keys.contiguous(), descending))
    if width < 32:
        _staged(n * (size + 4))
        bits = (bits.to(torch.int32) & ((1 << width) - 1)).view(torch.uint32)
    elif width == 32:
        bits = bits.view(torch.uint32)
    return [bits], [(begin, end)]


def _limbs_to_key(limbs, dtype: torch.dtype, descending: bool) -> torch.Tensor:
    """Inverse of :func:`_key_to_limbs` on an engine's fresh column, which
    nothing else holds: unsigned keys in ascending order come back as its
    own words (no copy)."""
    width = twiddle.bit_width(dtype)
    u = twiddle.unsigned_dtype(dtype)
    (bits,) = limbs
    n = bits.shape[0]
    if width < 32:
        _staged(n * (4 + dtype.itemsize))
        narrow = torch.int8 if width == 8 else torch.int16
        bits = bits.view(torch.int32).to(narrow)
    _staged(_twiddle_bytes(dtype, n, descending))
    return twiddle.twiddle_out(bits.view(u), dtype, descending=descending,
                               copy=False)


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


@traced
def sort(keys: torch.Tensor, *, descending: bool = False,
         begin_bit: int | None = None, end_bit: int | None = None,
         config: config_lib.SortConfig | None = None) -> torch.Tensor:
    """Sort a 1-D key tensor (keys-only, so stability is unobservable).
    Parity: DeviceRadixSort::SortKeys. With begin_bit/end_bit only those
    bits of the twiddled key order it; full-range sorts on the 'bitonic'
    engine run the network (1 plane, or (hi, lo) for 64-bit keys)."""
    cfg = config_lib.resolve(config)
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-D; got shape {tuple(keys.shape)}")
    _check_device_n(keys.shape[0])
    if keys.shape[0] == 0:
        return keys.clone()
    if cfg.engine == "bitonic" and full_range(keys.dtype, begin_bit, end_bit):
        return _sort_keys_bitonic(keys, descending, cfg)
    limbs, limb_bits = _key_to_limbs(keys, descending, begin_bit, end_bit)
    limbs, _ = _sort_limbs(limbs, limb_bits, [], cfg)
    return _limbs_to_key(limbs, keys.dtype, descending)


@traced
def sort_pairs(keys: torch.Tensor, values, *, descending: bool = False,
               begin_bit: int | None = None, end_bit: int | None = None,
               config: config_lib.SortConfig | None = None,
               stable: bool = True, unique_leading_payload: bool = False):
    """Key-value sort. ``values``: a tensor, or a list, tuple or dict of
    tensors (nested), each of leading dimension len(keys). Stable by
    default. ``stable=False`` (thrust::sort_by_key) lets the network drop
    its index plane and leave equal keys' payloads in the network's order;
    the radix engine stays stable. ``unique_leading_payload=True`` says the
    first value leaf is a unique u32 row tag, never 0xFFFFFFFF: the network
    then orders ties by that tag instead of an index plane, which is the
    stable result whenever the tag increases in input order (the radix
    engine gives the stable result). Parity: DeviceRadixSort::SortPairs."""
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
    limbs, out = _sort_limbs(limbs, limb_bits, leaves, cfg, stable=stable,
                             unique_leading_payload=unique_leading_payload)
    return (_limbs_to_key(limbs, keys.dtype, descending),
            _unflatten(spec, iter(out)))


@traced
def argsort(keys: torch.Tensor, *, descending: bool = False,
            begin_bit: int | None = None, end_bit: int | None = None,
            config: config_lib.SortConfig | None = None) -> torch.Tensor:
    """Stable argsort (int32 positions) through an index payload; keys of
    up to 32 bits over their full range run the network's (key, index)
    sort on the 'bitonic' engine."""
    cfg = config_lib.resolve(config)
    if (cfg.engine == "bitonic" and full_range(keys.dtype, begin_bit, end_bit)
            and twiddle.bit_width(keys.dtype) <= 32
            and keys.dim() == 1 and keys.shape[0] > 0):
        _check_device_n(keys.shape[0])
        return _argsort_bitonic(keys, descending, cfg)
    idx = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    _, perm = sort_pairs(keys, idx, descending=descending,
                         begin_bit=begin_bit, end_bit=end_bit, config=config)
    return perm


@traced
def sort_struct(key_columns, values=None, *, descending: bool = False,
                config: config_lib.SortConfig | None = None,
                stable: bool = True):
    """Lexicographic sort by several key columns, most significant first
    (each any supported key dtype); stable by default, ``stable=False`` as
    in :func:`sort_pairs`. Returns the sorted key columns as a tuple, or
    (that tuple, sorted values) when values is given."""
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
        limbs, limb_bits = [], []
        for col in cols:
            (limb,), (bits,) = _key_to_limbs(col, descending, None, None)
            limbs.append(limb)
            limb_bits.append(bits)
        limbs, out = _sort_limbs(limbs, limb_bits, leaves, cfg,
                                 stable=stable)
        out_cols = tuple(_limbs_to_key([limb], col.dtype, descending)
                         for limb, col in zip(limbs, cols))
    if values is None:
        return out_cols
    return out_cols, _unflatten(spec, iter(out))


# ---------------------------------------------------------------------------
# sort_large: one MSD partition on the kernels, then bucket sorts in batches
# ---------------------------------------------------------------------------

_SIGN = -(1 << 31)          # the sign bit of the int32 view
_FLIPPED_MAX = (1 << 31) - 1  # 0xFFFFFFFF with its sign bit flipped
_BATCH_KEYS = 1 << 26       # keys of one bucket batch, about


def _hybrid_partition(keys: torch.Tensor, *, descending: bool, msd_bits: int,
                      config: config_lib.SortConfig):
    """Phase A: twiddle the keys and partition them, stably, by their top
    ``msd_bits`` bits: one histogram launch and one stage pass through
    ``kernels/pipeline.py::sort_limbs``, with the digit width of the
    smallest one-pass partition (2, 4 or 8 bits: a width-aligned pass for
    msd_bits 2, 4 and 8). Returns (the partitioned u32 bits, the bucket
    bounds (2^msd_bits + 1,) int64: bucket d is rows [bounds[d],
    bounds[d + 1]))."""
    width = next((w for w in (2, 4, 8) if w >= msd_bits), 8)
    cfg = config.replace(engine="radix", radix_bits=width)
    bits = twiddle.twiddle_in(keys.contiguous(), descending)
    (pb,), _ = kpipe.sort_limbs([bits], [(32 - msd_bits, 32)], [], cfg)
    # the rows are in order of their top bits, so each bucket's first row
    # is a binary search away; searched on the sign-flipped int32 view,
    # whose order is the u32 order (torch on the card has no u32 search)
    dev = pb.device
    tops = (torch.arange(1 << msd_bits, dtype=torch.int64, device=dev)
            << (32 - msd_bits)) + _SIGN
    first = torch.searchsorted(pb.view(torch.int32) ^ _SIGN,
                               tops.to(torch.int32))
    n = torch.full((1,), pb.shape[0], dtype=torch.int64, device=dev)
    return pb, torch.cat([first, n])


def _hybrid_bucket_sort(pb: torch.Tensor, bounds: torch.Tensor, *, cap: int,
                        group: int) -> torch.Tensor:
    """Phase B: sort each bucket of the partitioned u32 bits ``pb``.

    ``group`` buckets at a time are gathered into one (group, cap) batch
    by one index tensor made from the bounds, the slots past each bucket's
    count filled with the largest key; each row is sorted, and only its
    first count slots go back. A real 0xFFFFFFFF key cannot be told from a
    fill, but the first count slots still hold the bucket's keys (a
    keys-only sort). The JAX package sorts the batch with ``jnp.sort``,
    XLA's own sort outside any Pallas kernel; here ``torch.sort`` of the
    sign-flipped int32 view does the same. cap must hold the largest
    bucket and group divide the number of buckets."""
    npad = pb.shape[0]
    nb = bounds.shape[0] - 1
    dev = pb.device
    bounds = bounds.to(device=dev, dtype=torch.int64)
    counts = bounds[1:] - bounds[:-1]
    # reads past the last row land in fills, as JAX's padded source
    src = torch.cat([pb.view(torch.int32) ^ _SIGN,
                     torch.full((cap,), _FLIPPED_MAX, dtype=torch.int32,
                                device=dev)])
    out = torch.empty(npad + 1, dtype=torch.int32, device=dev)  # + a sink
    lane = torch.arange(cap, device=dev)
    for d0 in range(0, nb, group):
        idx = bounds[d0:d0 + group, None] + lane
        live = lane < counts[d0:d0 + group, None]
        batch = torch.where(live, src[idx], _FLIPPED_MAX)
        batch = torch.sort(batch, dim=-1).values
        out[torch.where(live, idx, npad)] = batch
    return (out[:npad] ^ _SIGN).view(torch.uint32)


def _round_cap_fine(c: int) -> int:
    """A bucket capacity rounded up with at most 1/16 slack (16 sizes an
    octave), at least 256."""
    c = max(int(c), 256)
    q = 1 << max((c - 1).bit_length() - 4, 8)
    return -(-c // q) * q


@traced
def sort_large(keys: torch.Tensor, *, descending: bool = False,
               msd_bits: int | None = None,
               config: config_lib.SortConfig | None = None) -> torch.Tensor:
    """Keys-only sort of 32-bit keys in two phases, bit for bit the result
    of :func:`sort`: one stable partition by the top ``msd_bits`` bits on
    the histogram and stage kernels, then the 2^msd_bits buckets sorted in
    batches of about 2^26 keys, whatever the skew (the memory-bounded
    form). The largest bucket is read to the host once, to size the
    batches (the two-phase protocol of CUB's temp-storage query).

    Keys that are not 32 bits wide, and fewer than 2^22 keys when
    ``msd_bits`` is None, go to :func:`sort`. An explicit ``msd_bits``
    (1-16) forces the two phases; by default it is 4 below 2^28 keys and 8
    from there. No gain over :func:`sort` is claimed (PERF.md)."""
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-D; got shape {tuple(keys.shape)}")
    n = keys.shape[0]
    if twiddle.bit_width(keys.dtype) != 32 or n == 0:
        return sort(keys, descending=descending, config=config)
    if msd_bits is None:
        if n < (1 << 22):
            return sort(keys, descending=descending, config=config)
        msd_bits = 4 if n < (1 << 28) else 8
    if not 1 <= msd_bits <= 16:
        raise ValueError(f"msd_bits must be in [1, 16]; got {msd_bits}")
    _check_device_n(n)
    pb, bounds = _hybrid_partition(keys, descending=descending,
                                   msd_bits=msd_bits,
                                   config=config_lib.resolve(config))
    nb = 1 << msd_bits
    largest = (bounds[1:] - bounds[:-1]).max()
    with sync_span("bucket_cap"):
        cap = _round_cap_fine(int(largest))
    group = max(1, min(nb, _BATCH_KEYS // cap))
    while nb % group:
        group -= 1
    out_bits = _hybrid_bucket_sort(pb, bounds, cap=cap, group=group)
    return twiddle.twiddle_out(out_bits, keys.dtype, descending=descending)
