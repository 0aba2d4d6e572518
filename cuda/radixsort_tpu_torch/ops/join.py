"""Equality join: the sort-coalesce formulation.

Counterpart of ``cuda/radixsort_tpu/ops/join.py``:

  1. concatenate build rows then probe rows (build first);
  2. stable radix sort by key: equal keys group together with build rows
     first (stability replaces a composite (key, side) sort key);
  3. scans carry each build row's value forward; a probe row matches iff its
     key group holds a build row;
  4. the output rows are compacted with the filter operator.

Duplicate build keys resolve to the last duplicate in ``join``;
``join_expand`` fans them out (1:N) into a fixed capacity, sized by
``join_count``. Counts are 0-d int32 tensors on the device (no host sync).
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.filter import filter_columns
from cuda.radixsort_tpu_torch.ops.scan import (_full, _identity_of,
                                               plain_scan_fast, segmented_scan)
from cuda.radixsort_tpu_torch.ops.sort import sort_pairs, sort_struct
from cuda.radixsort_tpu_torch.utils.profiling import traced

_HOWS = ("inner", "left", "semi", "anti", "right", "full")


def _fill_from_marks(marked, x, fill=-1):
    """Forward-fill x's value at marked rows to all following rows. Needs x
    non-decreasing at marked rows; rows before the first mark get fill."""
    return plain_scan_fast(torch.where(marked, x, fill), "max")


def _fill_value_from_marks(marked, values):
    """Forward-fill any values from marked rows (rows before the first mark
    get the dtype's minimum): a segmented max, restarting at each mark, of
    the values seeded at the marks."""
    ident = _full((), _identity_of("max", values.dtype), values.dtype,
                  values.device)
    return segmented_scan(twiddle.where(marked, values, ident), marked, "max")


def _monotone_at_group_end(is_end, x, big):
    """x's value at the last row of each group, over the whole group. Needs
    x non-decreasing: a running min of the end marks on the reversed axis."""
    return twiddle.flip(plain_scan_fast(
        torch.where(twiddle.flip(is_end), twiddle.flip(x), big), "min"))


def _starts_of(key_cols):
    """Group starts of sorted key columns, comparing twiddled bits (equal
    bits, one group: same-pattern NaNs stay together)."""
    n = key_cols[0].shape[0]
    is_start = torch.zeros(n, dtype=torch.bool, device=key_cols[0].device)
    is_start[0] = True
    for col in key_cols:
        bits = twiddle.signed_view(twiddle.twiddle_in(col))
        is_start[1:] |= bits[1:] != bits[:-1]
    return is_start


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32)


def _with_probe_zeros(build_vals: torch.Tensor, np_: int) -> torch.Tensor:
    """The value column of (build ++ probe): the probe rows hold zeros."""
    return twiddle.cat([build_vals, torch.zeros(np_, dtype=build_vals.dtype,
                                                device=build_vals.device)])


@traced
def join(build_keys, build_vals: torch.Tensor, probe_keys, *,
         how: str = "inner", build_valid: torch.Tensor | None = None,
         probe_valid: torch.Tensor | None = None,
         config: config_lib.SortConfig | None = None):
    """Join probe rows against build rows (the last of duplicate build keys
    wins).

    build_keys / probe_keys may each be one tensor or a tuple of key
    columns (a composite key): the sides then ride a lexicographic struct
    sort and group boundaries compare every column. Keys come back in the
    same single/tuple shape.

    Returns, for how='inner', (keys, vals, probe_idx, count):
      keys[:count]      probe keys that matched, key-sorted
      vals[:count]      the matched build value per probe row
      probe_idx[:count] the original probe row (int32)
    how='left' returns every probe row and a 5th element, the matched mask
    (unmatched rows carry vals of no meaning). how='semi'/'anti' return
    (keys, probe_idx, count): probe rows with / without a match.
    how='right' emits inner matches plus build rows whose key matched no
    probe row; how='full' the left join plus those build rows. Both return
    (keys, vals, probe_idx, count, matched): build-only rows carry
    probe_idx == -1, their own build value and matched False; unmatched
    probe rows carry vals 0.

    build_valid / probe_valid: optional bool masks; False rows take part in
    neither side.
    """
    if how not in _HOWS:
        raise ValueError(how)
    cfg = config_lib.resolve(config)
    multi = isinstance(build_keys, (tuple, list))
    bcols = tuple(build_keys) if multi else (build_keys,)
    pcols = (tuple(probe_keys) if isinstance(probe_keys, (tuple, list))
             else (probe_keys,))
    if len(bcols) != len(pcols):
        raise ValueError("build/probe key column counts differ")
    nb, np_ = bcols[0].shape[0], pcols[0].shape[0]
    dev = bcols[0].device

    key_cols = tuple(twiddle.cat([b, p]) for b, p in zip(bcols, pcols))
    vals = _with_probe_zeros(build_vals, np_)
    # one companion column instead of (side, vals, orig): the concat
    # position encodes the side (pos < nb: build) and the probe row
    # (pos - nb); bit 31 flags invalid rows
    ntot = nb + np_
    posflag = torch.arange(ntot, dtype=torch.int32, device=dev)
    if build_valid is not None or probe_valid is not None:
        valid = torch.ones(ntot, dtype=torch.bool, device=dev)
        if build_valid is not None:
            valid[:nb] = build_valid
        if probe_valid is not None:
            valid[nb:] = probe_valid
        posflag = torch.where(valid, posflag, posflag | -(1 << 31))
    posflag = posflag.view(torch.uint32)

    if multi:
        skey_cols, (sposflag, svals) = sort_struct(key_cols, (posflag, vals),
                                                   config=cfg)
    else:
        sk0, (sposflag, svals) = sort_pairs(key_cols[0], (posflag, vals),
                                            config=cfg,
                                            unique_leading_payload=True)
        skey_cols = (sk0,)
    skeys = skey_cols if multi else skey_cols[0]
    sposflag = sposflag.view(torch.int32)
    spos = sposflag & 0x7FFFFFFF
    sinvalid = sposflag < 0
    sorig = torch.clamp_min(spos - nb, 0)

    is_build = ~sinvalid & (spos < nb)
    is_probe = ~sinvalid & (spos >= nb)
    # matched iff my key group holds a build row (builds sort first in each
    # group): the group's build count from running sums, no gathers
    is_start = _starts_of(skey_cols)
    cb_incl = plain_scan_fast(_i32(is_build), "sum")
    cb_at_start = _fill_from_marks(is_start, cb_incl - _i32(is_build))
    matched = (cb_incl - cb_at_start) > 0
    # carried value = svals at the last build row so far (inside my group
    # whenever matched)
    cv = _fill_value_from_marks(is_build, svals)

    if how == "inner":
        (ok, ov, oi), count = filter_columns(is_probe & matched,
                                             (skeys, cv, sorig), config=cfg)
        return ok, ov, oi, count
    if how in ("semi", "anti"):
        keep = is_probe & (matched if how == "semi" else ~matched)
        (ok, oi), count = filter_columns(keep, (skeys, sorig), config=cfg)
        return ok, oi, count
    if how in ("right", "full"):
        # a build row is unmatched iff its key group holds no valid probe
        # row: the group's running probe count at its end vs at its start
        is_end = torch.cat([is_start[1:],
                            torch.ones(1, dtype=torch.bool, device=dev)])
        cp_incl = plain_scan_fast(_i32(is_probe), "sum")
        cp_at_start = _fill_from_marks(is_start, cp_incl - _i32(is_probe))
        cp_at_end = _monotone_at_group_end(is_end, cp_incl, ntot + 1)
        build_only = is_build & ((cp_at_end - cp_at_start) <= 0)
        keep = (is_probe & matched if how == "right" else is_probe) | build_only
        # unmatched probe rows zero-fill their build value (cv would carry
        # the last build row of an unrelated smaller key)
        zero = torch.zeros((), dtype=svals.dtype, device=dev)
        out_v = twiddle.where(is_probe, twiddle.where(matched, cv, zero), svals)
        out_i = torch.where(is_probe, sorig, -1)
        (ok, ov, oi, om), count = filter_columns(
            keep, (skeys, out_v, out_i, is_probe & matched), config=cfg)
        return ok, ov, oi, count, om
    (ok, ov, oi, om), count = filter_columns(
        is_probe, (skeys, cv, sorig, matched), config=cfg)
    return ok, ov, oi, count, om


# ---------------------------------------------------------------------------
# 1:N expanding join, two-phase
# ---------------------------------------------------------------------------


def _sorted_merge_state(build_keys, build_vals, probe_keys, cfg):
    """One stable sort of (build ++ probe), then scans only. For every probe
    row p, the build rows of its key sit at sorted positions
    [grp_start[p], grp_start[p] + n_build[p])."""
    nb, np_ = build_keys.shape[0], probe_keys.shape[0]
    dev = build_keys.device
    keys = twiddle.cat([build_keys, probe_keys])
    vals = _with_probe_zeros(build_vals, np_)
    n = nb + np_
    posc = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    skeys, (sposc, svals) = sort_pairs(keys, (posc, vals), config=cfg,
                                       unique_leading_payload=True)
    spos = sposc.view(torch.int32)
    sorig = torch.clamp_min(spos - nb, 0)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    is_build = spos < nb
    is_start = _starts_of((skeys,))
    cb_incl = plain_scan_fast(_i32(is_build), "sum")
    # position 0 is a start, so no row keeps the -1 fill
    grp_start = _fill_from_marks(is_start, pos)
    cb_at_start = _fill_from_marks(is_start, cb_incl - _i32(is_build))
    n_build = cb_incl - cb_at_start  # at probe rows: builds in my key group
    return skeys, svals, sorig, ~is_build, grp_start, n_build


@traced
def join_count(build_keys: torch.Tensor, probe_keys: torch.Tensor, *,
               config: config_lib.SortConfig | None = None) -> torch.Tensor:
    """Phase one of the expanding join: the number of inner-join output
    rows (0-d int32). Use it to pick ``capacity`` for :func:`join_expand`."""
    cfg = config_lib.resolve(config)
    vals = torch.zeros(build_keys.shape[0], dtype=torch.int32,
                       device=build_keys.device)
    _, _, _, is_probe, _, n_build = _sorted_merge_state(build_keys, vals,
                                                        probe_keys, cfg)
    return torch.where(is_probe, n_build, 0).sum(dtype=torch.int32)


@traced
def join_expand(build_keys: torch.Tensor, build_vals: torch.Tensor,
                probe_keys: torch.Tensor, *, capacity: int,
                how: str = "inner",
                config: config_lib.SortConfig | None = None):
    """1:N equality join: every probe row emits one output row per matching
    build row (duplicate build keys fan out).

    ``capacity`` is the output length (size it with join_count). Returns
    (keys, vals, probe_idx, matched, count): rows [0, count) are the output
    in (key, build-run offset) order, later rows are padding. If count >
    capacity the output is truncated to the first ``capacity`` rows (count
    still reports the true total). For how='left', unmatched probe rows
    emit one row with matched False and vals 0.
    """
    if how not in ("inner", "left"):
        raise ValueError(how)
    cfg = config_lib.resolve(config)
    skeys, svals, sorig, is_probe, grp_start, n_build = _sorted_merge_state(
        build_keys, build_vals, probe_keys, cfg)
    n = skeys.shape[0]
    dev = skeys.device
    lens = torch.where(is_probe, n_build if how == "inner"
                       else torch.clamp_min(n_build, 1), 0)
    total = lens.sum(dtype=torch.int32)
    starts = plain_scan_fast(lens, "sum") - lens  # exclusive, non-decreasing

    # scatter each emitting row's sorted position into its first output
    # slot (rows with no output, or a slot past capacity, go to the spare
    # slot c and are dropped), forward-fill, then gather the row state
    c = capacity
    slot = torch.where(lens > 0, starts, c).clamp_max(c).to(torch.int64)
    rowpos = torch.arange(n, dtype=torch.int32, device=dev)
    first = torch.full((c + 1,), -1, dtype=torch.int32, device=dev)
    first.scatter_(0, slot, rowpos)
    safe = plain_scan_fast(first[:c].contiguous(), "max").clamp(0, n - 1).long()
    f_start = starts[safe]
    f_nb = n_build[safe]

    out_pos = torch.arange(c, dtype=torch.int32, device=dev)
    matched = f_nb > 0
    build_pos = (grp_start[safe] + out_pos - f_start).clamp(0, n - 1).long()
    valid = out_pos < torch.clamp_max(total, c)
    out_val = twiddle.where(valid & matched, twiddle.take(svals, build_pos),
                            torch.zeros((), dtype=svals.dtype, device=dev))
    out_key = twiddle.where(valid, twiddle.take(skeys, safe),
                            torch.zeros((), dtype=skeys.dtype, device=dev))
    out_idx = torch.where(valid, sorig[safe], -1)
    return out_key, out_val, out_idx, matched & valid, total
