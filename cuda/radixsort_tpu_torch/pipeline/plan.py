"""Declarative query plans over Table: the engine's logical-plan driver.

Counterpart of ``cuda/radixsort_tpu/pipeline/plan.py``, single GPU. A
Query is an immutable list of stages over a source Table; ``run()``
executes them in order on the source's device, threading the validity
protocol (rows [0, count) valid) through every stage. Compacted tables
carry real-but-dropped rows in their tails, so every stage masks by row
position, never by a sentinel key.

    q = (Query(orders)
         .where(lambda t: t["amount"] > 100)
         .join(parts, on="part", value="price")
         .groupby("part", "amount", agg="sum")
         .order_by("amount", descending=True)
         .limit(10))
    out, count, stats = q.run()
    print(q.explain())

Counts stay 0-d int32 tensors on the device between stages; the plan adds
no host sync of its own unless ``run(timed=True)``. Every stage's count
lands in ``stats``. ``run(mesh=...)`` waits for the distributed layer
(ROADMAP A.11).
"""

from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.aggregate import (groupby, groupby_multi,
                                                    groupby_quantile)
from cuda.radixsort_tpu_torch.ops.join import _HOWS
from cuda.radixsort_tpu_torch.ops.join import join as join_op
from cuda.radixsort_tpu_torch.ops.sort import sort_struct
from cuda.radixsort_tpu_torch.ops.window import window_table
from cuda.radixsort_tpu_torch.table import Table


class _Stage(NamedTuple):
    op: str
    args: tuple
    kwargs: dict


class Query:
    """Immutable logical plan over a source Table (or a (Table, count)
    pair whose tail rows are already invalid)."""

    def __init__(self, source: Table, *, _count=None, _stages=()):
        self._source = source
        self._count = _count
        self._stages = tuple(_stages)

    def _with(self, op: str, *args, **kwargs) -> "Query":
        return Query(self._source, _count=self._count,
                     _stages=self._stages + (_Stage(op, args, kwargs),))

    # -- plan builders -------------------------------------------------------
    def where(self, pred: Callable[[Table], torch.Tensor]) -> "Query":
        """Keep rows where pred(table) is True (stable compaction)."""
        return self._with("where", pred)

    def select(self, *names: str) -> "Query":
        """Project to the named columns."""
        return self._with("select", tuple(names))

    def with_column(self, name: str,
                    fn: Callable[[Table], torch.Tensor]) -> "Query":
        """Add a computed column (elementwise over the table)."""
        return self._with("with_column", name, fn)

    def join(self, build: Table, *, on, value: str | None = None,
             how: str = "inner", build_count=None) -> "Query":
        """Join against ``build[on]``. ``on`` is one column name or a tuple
        of names (a composite key). how: "inner" (brings ``build[value]``
        across), "left" (every row plus a bool ``matched`` column),
        "semi"/"anti" (probe rows with/without a match; no value),
        "right"/"full" (also the unmatched build rows, their probe columns
        zero-filled and matched False). ``build_count`` marks a compacted
        build side's valid prefix."""
        if how not in _HOWS:
            raise ValueError(how)
        if how in ("inner", "left", "right", "full") and value is None:
            raise ValueError(f"how={how!r} needs value=")
        on = tuple(on) if isinstance(on, (tuple, list)) else on
        return self._with("join", build, on, value, build_count, how)

    def groupby(self, key: str, value: str, *, agg: str = "sum") -> "Query":
        """Group by ``key``, reduce ``value`` (sum/count/min/max/mean/var/
        std/median). Output columns: key, value, or key, ``agg`` when value
        names the key itself (groupby("x", "x", agg="count") gives columns
        x, count)."""
        return self._with("groupby", key, value, agg)

    def groupby_agg(self, keys, aggs: dict) -> "Query":
        """Multi-key, multi-aggregate group-by: ``keys`` is a sequence of
        grouping columns, ``aggs`` maps out_name -> (value_column, agg),
        agg in sum/count/min/max/mean/var/std/median."""
        return self._with("groupby_agg", tuple(keys),
                          tuple((n, v, a) for n, (v, a) in aggs.items()))

    def quantiles(self, key: str, value: str, qs=(0.25, 0.5, 0.75), *,
                  names=None, max_groups: int | None = None) -> "Query":
        """Per-group quantiles of ``value`` grouped by ``key`` (linear
        interpolation; all qs share one sort). Output columns: key plus one
        per q, ``names`` or "q25"-style defaults. ``max_groups`` is the
        reference's hint for its distributed route; a single-GPU run
        ignores it."""
        qs = tuple(float(q) for q in (qs if isinstance(qs, (tuple, list))
                                      else (qs,)))
        if names is None:
            names = tuple(f"q{round(q * 100)}" for q in qs)
        names = tuple(names)
        if len(names) != len(qs):
            raise ValueError(f"{len(names)} names for {len(qs)} qs")
        if len(set(names)) != len(names) or key in names:
            raise ValueError(f"quantile output names collide: {names}")
        return self._with("quantiles", key, value, qs, names, max_groups)

    def distinct(self, *keys: str) -> "Query":
        """Deduplicate rows by the named columns (all when none given);
        output rows are the distinct key tuples, key-ascending, projected
        to those columns."""
        return self._with("distinct", tuple(keys))

    def window(self, partition_by: str, order_by: str, outputs: dict, *,
               descending: bool = False) -> "Query":
        """Append window columns over ``OVER (PARTITION BY partition_by
        ORDER BY order_by)``: ``outputs`` maps out_name -> fn for
        row_number/rank/dense_rank, or out_name -> (value_column, fn) for
        cumsum/cummin/cummax/lag/lead. Rows are reordered to (partition,
        order); the valid prefix is unchanged."""
        spec = tuple((n, None, v) if isinstance(v, str) else (n, v[0], v[1])
                     for n, v in outputs.items())
        return self._with("window", partition_by, order_by, spec, descending)

    def order_by(self, *keys: str, key: str | None = None,
                 descending: bool = False) -> "Query":
        """Stable lexicographic sort by one or more columns (most
        significant first); invalid tail rows stay in the tail. ``key=`` is
        the single-column form."""
        if key is not None:
            keys = keys + (key,)
        if not keys:
            raise ValueError("order_by needs at least one column")
        return self._with("order_by", keys, descending)

    def limit(self, k: int) -> "Query":
        """Truncate the valid prefix to at most k rows."""
        return self._with("limit", k)

    # -- introspection -------------------------------------------------------
    def explain(self) -> str:
        lines = [f"scan {self._source!r}"
                 + ("" if self._count is None else "  [pre-counted]")]
        for st in self._stages:
            if st.op == "where":
                lines.append("where <predicate>")
            elif st.op == "select":
                lines.append(f"select {list(st.args[0])}")
            elif st.op == "with_column":
                lines.append(f"with_column {st.args[0]!r}")
            elif st.op == "join":
                b, on, value, _, how = st.args
                lines.append(f"join[{how}] build={b!r} on={on!r}"
                             + (f" value={value!r}" if value else ""))
            elif st.op == "groupby":
                key, value, agg = st.args
                lines.append(f"groupby key={key!r} value={value!r} "
                             f"agg={agg!r}")
            elif st.op == "groupby_agg":
                keys, aggs = st.args
                lines.append(f"groupby_agg keys={list(keys)} aggs="
                             + str({n: (v, a) for n, v, a in aggs}))
            elif st.op == "quantiles":
                key, value, qs, names, mg = st.args
                lines.append(f"quantiles key={key!r} value={value!r} "
                             f"qs={list(qs)}"
                             + (f" max_groups={mg}" if mg else ""))
            elif st.op == "distinct":
                ks = st.args[0]
                lines.append("distinct" + (f" {list(ks)}" if ks else ""))
            elif st.op == "window":
                part, okey, spec, desc = st.args
                lines.append(
                    f"window partition_by={part!r} order_by={okey!r}"
                    + (" desc" if desc else "") + " outputs="
                    + str({n: (fn if s is None else (s, fn))
                           for n, s, fn in spec}))
            elif st.op == "order_by":
                lines.append(f"order_by {st.args[0]!r}"
                             + (" desc" if st.args[1] else ""))
            elif st.op == "limit":
                lines.append(f"limit {st.args[0]}")
        return "\n -> ".join(lines)

    # -- execution -----------------------------------------------------------
    def run(self, *, mesh=None, axis_name: str = "x", timed: bool = False,
            config: config_lib.SortConfig | None = None):
        """Execute the plan on the source table's device. Returns (table,
        count, stats): rows [0, count) of every column are the result;
        stats maps "i:op" to the 0-d count after stage i. timed=True also
        records each stage's wall-clock time as "i:op:ms", waiting for the
        device after each stage (for profiling: it syncs with the host)."""
        if mesh is not None:
            raise NotImplementedError(
                "Query.run(mesh=...) is distributed work, not ported yet "
                "(ROADMAP A.11)")
        t = self._source
        count = torch.as_tensor(t.num_rows if self._count is None
                                else self._count, dtype=torch.int32,
                                device=t.device)
        stats: dict[str, Any] = {}
        for i, st in enumerate(self._stages):
            t0 = time.perf_counter()
            t, count = _EXEC[st.op](t, count, st, config)
            if timed:
                if t.device.type == "cuda":
                    torch.cuda.synchronize(t.device)
                stats[f"{i}:{st.op}:ms"] = round(
                    (time.perf_counter() - t0) * 1e3, 3)
            stats[f"{i}:{st.op}"] = count
        return t, count, stats


def _valid_mask(t: Table, count) -> torch.Tensor:
    return torch.arange(t.num_rows, dtype=torch.int32, device=t.device) < count


def _cols(t: Table) -> dict:
    return {k: t[k] for k in t.column_names}


def _exec_where(t: Table, count, st: _Stage, config):
    mask = st.args[0](t) & _valid_mask(t, count)
    return t.filter(mask, config=config)


def _exec_select(t: Table, count, st: _Stage, config):
    return t.select(st.args[0]), count


def _exec_with_column(t: Table, count, st: _Stage, config):
    name, fn = st.args
    return t.with_column(name, fn(t)), count


def _join_impl(cols: dict, count, st: _Stage, build_cols: dict, config):
    """The join stage over column dicts."""
    _, on, value, build_count, how = st.args
    on_cols = on if isinstance(on, tuple) else (on,)
    dev = count.device
    rows = next(iter(cols.values())).shape[0]
    bk = tuple(build_cols[k] for k in on_cols)
    pk = tuple(cols[k] for k in on_cols)
    if len(on_cols) == 1:
        bk, pk = bk[0], pk[0]
    nb = build_cols[on_cols[0]].shape[0]
    bv = (build_cols[value] if value is not None
          else torch.zeros(nb, dtype=torch.int32, device=dev))
    bvalid = (None if build_count is None else
              torch.arange(nb, dtype=torch.int32, device=dev)
              < torch.as_tensor(build_count, dtype=torch.int32, device=dev))
    pvalid = torch.arange(rows, dtype=torch.int32, device=dev) < count

    def key_out(ok):
        return (dict(zip(on_cols, ok)) if len(on_cols) > 1
                else {on_cols[0]: ok})

    if how in ("semi", "anti"):
        ok, oi, cnt = join_op(bk, bv, pk, how=how, build_valid=bvalid,
                              probe_valid=pvalid, config=config)
        out = key_out(ok)
    elif how in ("left", "right", "full"):
        if "matched" in cols:
            raise ValueError(f"{how} join adds a 'matched' column; rename "
                             "the probe's existing 'matched' column first")
        ok, ov, oi, cnt, om = join_op(bk, bv, pk, how=how,
                                      build_valid=bvalid,
                                      probe_valid=pvalid, config=config)
        out = key_out(ok)
        out[value] = ov
        out["matched"] = om
    else:
        ok, ov, oi, cnt = join_op(bk, bv, pk, how="inner",
                                  build_valid=bvalid, probe_valid=pvalid,
                                  config=config)
        out = key_out(ok)
        out[value] = ov
    fill_build = how in ("right", "full")
    rows_of = torch.clamp_min(oi, 0).long()
    for name, col in cols.items():
        if name not in out:
            g = twiddle.take(col, rows_of)
            # build-only rows (oi == -1) have no probe columns: zero-fill
            out[name] = (twiddle.where(oi >= 0, g, torch.zeros(
                (), dtype=col.dtype, device=dev)) if fill_build else g)
    return out, cnt


def _exec_join(t: Table, count, st: _Stage, config):
    out, cnt = _join_impl(_cols(t), count, st, _cols(st.args[0]), config)
    return Table(out), cnt


def _exec_groupby(t: Table, count, st: _Stage, config):
    key, value, agg = st.args
    gk, gv, cnt = groupby(t[key], t[value], agg=agg,
                          valid=_valid_mask(t, count), config=config)
    return Table({key: gk, (value if value != key else agg): gv}), cnt


def _groupby_agg_cols(cols, keys, aggs, valid, config):
    """The multi-aggregate stage over column dicts: the decomposable and
    moment aggregates in one groupby_multi, each median value column in
    one groupby_quantile. Both compact the same distinct key tuples in the
    same ascending order, so the columns align by position."""
    normal = tuple((n, v, a) for n, v, a in aggs if a != "median")
    med = tuple((n, v) for n, v, a in aggs if a == "median")
    out, cnt = {}, None
    if normal or not med:
        kc, vc, cnt = groupby_multi(
            tuple(cols[k] for k in keys), tuple(cols[v] for _, v, _ in normal),
            tuple(a for _, _, a in normal), valid=valid, config=config)
        out = dict(zip(keys, kc))
        out.update({n: c for (n, _, _), c in zip(normal, vc)})
    # one quantile sort per distinct value column; with no other aggregate
    # the first supplies the keys and the count
    by_vcol: dict[str, list] = {}
    for n_, v in med:
        by_vcol.setdefault(v, []).append(n_)
    for v, names_ in by_vcol.items():
        kq, (mcol,), cq = groupby_quantile(
            tuple(cols[k] for k in keys), cols[v], (0.5,), valid=valid,
            config=config)
        for n_ in names_:
            out[n_] = mcol
        if cnt is None:
            out.update(dict(zip(keys, kq)))
            cnt = cq
    return out, cnt


def _exec_groupby_agg(t: Table, count, st: _Stage, config):
    keys, aggs = st.args
    out, cnt = _groupby_agg_cols(_cols(t), keys, aggs, _valid_mask(t, count),
                                 config)
    return Table(out), cnt


def _exec_quantiles(t: Table, count, st: _Stage, config):
    key, value, qs, names, _ = st.args  # max_groups is distributed-only
    gk, qcols, cnt = groupby_quantile(t[key], t[value], qs,
                                      valid=_valid_mask(t, count),
                                      config=config)
    out = {key: gk}
    out.update(zip(names, qcols))
    return Table(out), cnt


def _exec_distinct(t: Table, count, st: _Stage, config):
    keys = st.args[0] or t.column_names
    kc, _, cnt = groupby_multi(tuple(t[k] for k in keys), (), (),
                               valid=_valid_mask(t, count), config=config)
    return Table(dict(zip(keys, kc))), cnt


def _exec_window(t: Table, count, st: _Stage, config):
    part, okey, spec, desc = st.args
    out, cnt = window_table(_cols(t), part, okey, spec,
                            valid=_valid_mask(t, count), descending=desc,
                            config=config)
    return Table(out), cnt


def _exec_order_by(t: Table, count, st: _Stage, config):
    keys, descending = st.args
    keys = (keys,) if isinstance(keys, str) else tuple(keys)
    # validity limb: flipped with `descending`, so the struct-wide order
    # still sinks the invalid tail rows (real dropped rows) last
    valid = _valid_mask(t, count)
    flag = (valid if descending else ~valid).to(torch.uint8)
    others = tuple(n for n in t.column_names if n not in keys)
    (_, *sk), sv = sort_struct((flag,) + tuple(t[k] for k in keys),
                               tuple(t[n] for n in others),
                               descending=descending, config=config)
    out = dict(zip(others, sv))
    out.update(zip(keys, sk))
    return Table(out), count


def _exec_limit(t: Table, count, st: _Stage, config):
    return t, torch.clamp_max(count, st.args[0])


_EXEC = {
    "where": _exec_where,
    "select": _exec_select,
    "with_column": _exec_with_column,
    "join": _exec_join,
    "groupby": _exec_groupby,
    "groupby_agg": _exec_groupby_agg,
    "quantiles": _exec_quantiles,
    "distinct": _exec_distinct,
    "window": _exec_window,
    "order_by": _exec_order_by,
    "limit": _exec_limit,
}
