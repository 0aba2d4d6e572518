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
lands in ``stats``.

``run(mesh=...)`` runs the whole plan on every rank over its block of a
sharded source table (``Table.shard``; a full table is sharded first):
filters stay local, joins probe a replicated build side (or hash-localise
a large one), group-bys are two-phase (``parallel/shuffle.py``), and
``order_by`` / ``limit`` gather the running result to every rank.
"""

from __future__ import annotations

import time
import warnings
from typing import Any, Callable, NamedTuple

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.aggregate import (groupby, groupby_multi,
                                                    groupby_quantile)
from cuda.radixsort_tpu_torch.ops.filter import filter_columns
from cuda.radixsort_tpu_torch.ops.join import _HOWS
from cuda.radixsort_tpu_torch.ops.join import join as join_op
from cuda.radixsort_tpu_torch.ops.sort import sort_struct
from cuda.radixsort_tpu_torch.ops.window import window_table
from cuda.radixsort_tpu_torch.parallel.shuffle import JOIN_BROADCAST_ROWS
from cuda.radixsort_tpu_torch.table import Table, _sharded
from cuda.radixsort_tpu_torch.utils.profiling import traced


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
    @traced
    def run(self, *, mesh=None, axis_name: str = "x", timed: bool = False,
            config: config_lib.SortConfig | None = None):
        """Execute the plan on the source table's device. Returns (table,
        count, stats): rows [0, count) of every column are the result;
        stats maps "i:op" to the 0-d count after stage i. timed=True also
        records each stage's wall-clock time as "i:op:ms", waiting for the
        device after each stage (for profiling: it syncs with the host).

        Distributed (mesh=..., a DeviceMesh; every rank runs the same
        plan): returns this rank's (table, counts, stats). While the
        result is sharded, rank d's rows [0, counts[d]) are valid and
        counts is (ndev,); once an order_by/limit has gathered, the table
        and the 0-d count are the same on every rank. stats values are
        global row counts."""
        if mesh is not None:
            return _run_distributed(self, mesh, axis_name, config)
        t = self._source
        t._whole("Query.run without mesh=")
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


@traced
def _exec_where(t: Table, count, st: _Stage, config):
    mask = st.args[0](t) & _valid_mask(t, count)
    return t.filter(mask, config=config)


@traced
def _exec_select(t: Table, count, st: _Stage, config):
    return t.select(st.args[0]), count


@traced
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


@traced
def _exec_join(t: Table, count, st: _Stage, config):
    out, cnt = _join_impl(_cols(t), count, st, _cols(st.args[0]), config)
    return Table(out), cnt


@traced
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


@traced
def _exec_groupby_agg(t: Table, count, st: _Stage, config):
    keys, aggs = st.args
    out, cnt = _groupby_agg_cols(_cols(t), keys, aggs, _valid_mask(t, count),
                                 config)
    return Table(out), cnt


@traced
def _exec_quantiles(t: Table, count, st: _Stage, config):
    key, value, qs, names, _ = st.args  # max_groups is distributed-only
    gk, qcols, cnt = groupby_quantile(t[key], t[value], qs,
                                      valid=_valid_mask(t, count),
                                      config=config)
    out = {key: gk}
    out.update(zip(names, qcols))
    return Table(out), cnt


@traced
def _exec_distinct(t: Table, count, st: _Stage, config):
    keys = st.args[0] or t.column_names
    kc, _, cnt = groupby_multi(tuple(t[k] for k in keys), (), (),
                               valid=_valid_mask(t, count), config=config)
    return Table(dict(zip(keys, kc))), cnt


@traced
def _exec_window(t: Table, count, st: _Stage, config):
    part, okey, spec, desc = st.args
    out, cnt = window_table(_cols(t), part, okey, spec,
                            valid=_valid_mask(t, count), descending=desc,
                            config=config)
    return Table(out), cnt


@traced
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


@traced
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


# ---------------------------------------------------------------------------
# distributed execution: the whole plan on every rank's block
# ---------------------------------------------------------------------------

# build tables above this row count are hash-localised instead of probed
# replicated
_JOIN_BROADCAST_ROWS = JOIN_BROADCAST_ROWS

_AUTO_QUANTILE_GROUPS = 64

# an order_by/limit gather that replicates more than this many bytes per
# rank warns: order a large table with parallel.dsort instead
_GATHER_WARN_BYTES = 256 << 20


def _auto_route_quantiles(stages, src, n, mesh, axis_name):
    """Fill in a missing ``max_groups`` hint of a quantiles stage when
    every stage before it only filters rows or adds or projects columns,
    its key and value columns are unrewritten source columns of at most 32
    bits, and a capped distinct count of the source key column proves at
    most 64 groups: the stage then refines histograms (no row moves)."""
    from cuda.radixsort_tpu_torch.parallel.dselect import (
        distinct_count_capped)

    out = []
    safe = True
    rewritten: set = set()
    for st in stages:
        if st.op == "quantiles" and st.args[4] is None and safe:
            key, value, qs, names, _ = st.args
            if (key in src.column_names and value in src.column_names
                    and key not in rewritten and value not in rewritten
                    and twiddle.bit_width(src[key].dtype) <= 32
                    and twiddle.bit_width(src[value].dtype) <= 32):
                ng = int(distinct_count_capped(
                    src[key], cap=_AUTO_QUANTILE_GROUPS, mesh=mesh,
                    axis_name=axis_name, n=n))
                if ng <= _AUTO_QUANTILE_GROUPS:
                    st = _Stage("quantiles", (key, value, qs, names,
                                              _AUTO_QUANTILE_GROUPS),
                                st.kwargs)
        if st.op == "with_column":
            rewritten.add(st.args[0])
        elif st.op not in ("where", "select"):
            safe = False
        out.append(st)
    return out


@traced
def _run_distributed(q: Query, mesh, axis_name, config):
    from cuda.radixsort_tpu_torch.parallel import comm
    from cuda.radixsort_tpu_torch.parallel.dsort import _gather_counts

    ax = comm.Axis(mesh, axis_name)
    ndev = ax.size
    src, n = _sharded(q._source, mesh, axis_name)
    s = src.num_rows
    cols = _cols(src)
    plan_stages = _auto_route_quantiles(q._stages, src, n, mesh, axis_name)
    cnt = torch.tensor(min(max(n - ax.index * s, 0), s), dtype=torch.int32,
                       device=src.device)
    rep = False  # True once a stage gathered to a replicated view
    stats: dict[str, Any] = {}
    for i, st in enumerate(plan_stages):
        if st.op == "join":
            # two reasons to hash-localise instead of probing the whole
            # build: outer joins (right/full) must emit each unmatched
            # build row once, and a large build is better dealt to its
            # hash owners
            st.args[0]._whole("a distributed plan's join build")
            bt = _cols(st.args[0])
            nbuild = st.args[0].num_rows
            if not rep and (st.args[4] in ("right", "full")
                            or nbuild > _JOIN_BROADCAST_ROWS):
                cols, cnt = _dist_join_hash(cols, cnt, st, bt, ax, mesh,
                                            axis_name, config)
            else:
                cols, cnt = _join_impl(cols, cnt, st, bt, config)
        elif rep or st.op in ("select", "with_column"):
            t2, cnt = _EXEC[st.op](Table(cols), cnt, st, config)
            cols = _cols(t2)
        elif st.op == "where":
            cols, cnt = _dist_where(cols, cnt, st.args[0], config)
        elif st.op == "groupby":
            cols, cnt = _dist_groupby(cols, cnt, st, ax, mesh, axis_name,
                                      config)
        elif st.op == "groupby_agg":
            cols, cnt = _dist_groupby_agg(cols, cnt, st, ax, mesh, axis_name,
                                          config)
        elif st.op == "quantiles":
            cols, cnt = _dist_quantiles(cols, cnt, st, ax, mesh, axis_name,
                                        config)
        elif st.op == "distinct":
            cols, cnt = _dist_distinct(cols, cnt, st, ax, mesh, axis_name,
                                       config)
        elif st.op == "window":
            cols, cnt = _dist_window(cols, cnt, st, ax, mesh, axis_name,
                                     config)
        elif st.op in ("order_by", "limit"):
            if not rep:
                cols, cnt = _dist_gather(cols, cnt, ax)
                rep = True
            t2, cnt = _EXEC[st.op](Table(cols), cnt, st, config)
            cols = _cols(t2)
        stats[f"{i}:{st.op}"] = cnt if rep else comm.psum(cnt, ax)
    if rep:
        return Table(cols), cnt, stats
    return (Table(cols, global_rows=_rows(cols) * ndev),
            _gather_counts(cnt, mesh, axis_name), stats)


def _rows(cols) -> int:
    return next(iter(cols.values())).shape[0]


def _first_rows(x: torch.Tensor, cnt) -> torch.Tensor:
    """True for rows [0, cnt) of x."""
    return torch.arange(x.shape[0], dtype=torch.int32, device=x.device) < cnt


def _prefix(cols, cnt) -> torch.Tensor:
    return _first_rows(next(iter(cols.values())), cnt)


@traced
def _dist_where(cols, cnt, pred, config):
    """Shard-local stable compaction by pred & positional validity."""
    mask = pred(Table(cols)) & _prefix(cols, cnt)
    return filter_columns(mask, cols)


def _exchange_by(cols, names, dest, ax, mesh, axis_name):
    """Exchange the named columns' rows to dest; (received cols, valid)."""
    from cuda.radixsort_tpu_torch.parallel.shuffle import exchange_rows

    recv, rvalid = exchange_rows([cols[k] for k in names], dest, ax.size,
                                 axis_name, _rows(cols), mesh=mesh)
    return dict(zip(names, recv)), rvalid


@traced
def _dist_groupby(cols, cnt, st, ax, mesh, axis_name, config):
    """The single-key group-by as the multi form with one key and one
    aggregate; a median cannot travel as a partial, so its raw rows
    hash-exchange and each group's values land on one rank."""
    from cuda.radixsort_tpu_torch.parallel.shuffle import _owner_of_keys

    key, value, agg = st.args
    out_name = value if value != key else agg
    if agg == "median":
        dest = torch.where(_prefix(cols, cnt),
                           _owner_of_keys(cols[key], ax.size), ax.size)
        recv, rvalid = _exchange_by(cols, list(dict.fromkeys((key, value))),
                                    dest, ax, mesh, axis_name)
        gk, gv, c2 = groupby(recv[key], recv[value], agg="median",
                             valid=rvalid, config=config)
        return {key: gk, out_name: gv}, c2
    st2 = _Stage("groupby_agg", ((key,), ((out_name, value, agg),)), {})
    return _dist_groupby_agg(cols, cnt, st2, ax, mesh, axis_name, config)


@traced
def _dist_join_hash(cols, cnt, st, build, ax, mesh, axis_name, config):
    """Hash-localised join: probe rows hash-exchange and each rank keeps
    the build rows it owns, so every key lives on one rank and the local
    join is right for every ``how``."""
    from cuda.radixsort_tpu_torch.parallel.shuffle import _owner_of_key_tuple

    _, on, value, build_count, how = st.args
    on_cols = on if isinstance(on, tuple) else (on,)
    dev = cnt.device

    def owner(table_cols):
        return _owner_of_key_tuple([table_cols[k] for k in on_cols], ax.size)

    dest = torch.where(_prefix(cols, cnt), owner(cols), ax.size)
    recv, rvalid = _exchange_by(cols, list(cols), dest, ax, mesh, axis_name)
    rcols, rcnt = filter_columns(rvalid, recv)
    nb = build[on_cols[0]].shape[0]
    mine = owner(build) == ax.index
    if build_count is not None:
        mine = mine & (torch.arange(nb, dtype=torch.int32, device=dev)
                       < torch.as_tensor(build_count, dtype=torch.int32,
                                         device=dev))
    blocal, bcnt = filter_columns(mine, build)
    st2 = _Stage("join", (None, on, value, bcnt, how), {})
    return _join_impl(rcols, rcnt, st2, blocal, config)


@traced
def _dist_quantiles(cols, cnt, st, ax, mesh, axis_name, config):
    """Quantiles cannot travel as partials: the raw (key, value) rows
    hash-exchange. With a ``max_groups`` hint no row moves: histogram
    refinement resolves every (group, q) target, and the replicated result
    is dealt round-robin over the ranks."""
    from cuda.radixsort_tpu_torch.parallel.dselect import (
        quantile_refine_shard)
    from cuda.radixsort_tpu_torch.parallel.dsort import _keys_of_bits, _bits_of
    from cuda.radixsort_tpu_torch.parallel.shuffle import _owner_of_keys

    key, value, qs, names, max_groups = st.args
    valid0 = _prefix(cols, cnt)
    if max_groups is not None:
        if (twiddle.bit_width(cols[key].dtype) > 32
                or twiddle.bit_width(cols[value].dtype) > 32):
            raise NotImplementedError(
                "quantiles max_groups hint: <=32-bit key/value dtypes")
        gkb, qstack, n_groups = quantile_refine_shard(
            _bits_of(cols[key]), _bits_of(cols[value]), valid0, qs, max_groups,
            cols[value].dtype, axis_name, mesh=mesh)
        gk = _keys_of_bits(gkb, cols[key].dtype, False)
        slot = torch.arange(max_groups, dtype=torch.int32, device=cnt.device)
        mine = ((slot % ax.size) == ax.index) & (
            slot < torch.clamp_max(n_groups, max_groups))
        out = {key: gk}
        out.update(zip(names, qstack))
        return filter_columns(mine, out)
    dest = torch.where(valid0, _owner_of_keys(cols[key], ax.size), ax.size)
    recv, rvalid = _exchange_by(cols, list(dict.fromkeys((key, value))),
                                dest, ax, mesh, axis_name)
    gk, qcols, c2 = groupby_quantile(recv[key], recv[value], qs, valid=rvalid,
                                     config=config)
    out = {key: gk}
    out.update(zip(names, qcols))
    return out, c2


@traced
def _dist_distinct(cols, cnt, st, ax, mesh, axis_name, config):
    """Two-phase dedup: local distinct, hash-of-key-tuple exchange of the
    survivors, final distinct per rank."""
    from cuda.radixsort_tpu_torch.parallel.shuffle import (
        _owner_of_key_tuple, exchange_rows)

    keys = st.args[0] or tuple(sorted(cols))
    kc, _, c1 = groupby_multi(tuple(cols[k] for k in keys), (), (),
                              valid=_prefix(cols, cnt), config=config)
    dest = torch.where(_first_rows(kc[0], c1),
                       _owner_of_key_tuple(kc, ax.size), ax.size)
    recv, rvalid = exchange_rows(list(kc), dest, ax.size, axis_name,
                                 kc[0].shape[0], mesh=mesh)
    k2, _, c2 = groupby_multi(tuple(recv), (), (), valid=rvalid,
                              config=config)
    return dict(zip(keys, k2)), c2


@traced
def _dist_window(cols, cnt, st, ax, mesh, axis_name, config):
    """Whole rows hash-exchange by partition key (every partition lands on
    one rank), then the single-GPU window runs per rank."""
    from cuda.radixsort_tpu_torch.parallel.shuffle import _owner_of_keys

    part, okey, spec, desc = st.args
    dest = torch.where(_prefix(cols, cnt),
                       _owner_of_keys(cols[part], ax.size), ax.size)
    recv, rvalid = _exchange_by(cols, list(cols), dest, ax, mesh, axis_name)
    return window_table(recv, part, okey, spec, valid=rvalid,
                        descending=desc, config=config)


@traced
def _dist_groupby_agg(cols, cnt, st, ax, mesh, axis_name, config):
    """Two-phase multi-key multi-aggregate group-by: local partials, a
    hash-of-key-tuple exchange, a final re-aggregation. A count partial
    re-reduces as a sum, a mean travels as (sum, count), var/std as (sum,
    sum of squares, count), each assembled after the final phase; a median
    moves the raw rows instead."""
    from cuda.radixsort_tpu_torch.ops.aggregate import (_mean_dtype,
                                                        _moments_to_var)
    from cuda.radixsort_tpu_torch.parallel.shuffle import (
        _owner_of_key_tuple, exchange_rows)

    keys, aggs = st.args
    if any(a == "median" for _, _, a in aggs):
        dest = torch.where(_prefix(cols, cnt), _owner_of_key_tuple(
            [cols[k] for k in keys], ax.size), ax.size)
        need = list(dict.fromkeys(list(keys) + [v for _, v, _ in aggs]))
        recv, rvalid = _exchange_by(cols, need, dest, ax, mesh, axis_name)
        return _groupby_agg_cols(recv, keys, aggs, rvalid, config)
    part_arrays, part_aggs, assemble = [], [], []
    for n_, v, a in aggs:
        col = cols[v]
        i = len(part_arrays)
        if a == "mean":
            assemble.append((n_, a, (i, i + 1), col.dtype))
            part_arrays += [col, col]
            part_aggs += ["sum", "count"]
        elif a in ("var", "std"):
            md = _mean_dtype(col.dtype)
            assemble.append((n_, a, (i, i + 1, i + 2), col.dtype))
            part_arrays += [col, col.to(md) * col.to(md), col]
            part_aggs += ["sum", "sum", "count"]
        else:
            assemble.append((n_, a, (i,), None))
            part_arrays.append(col)
            part_aggs.append(a)
    kc, vc, c1 = groupby_multi(tuple(cols[k] for k in keys),
                               tuple(part_arrays), tuple(part_aggs),
                               valid=_prefix(cols, cnt), config=config)
    dest = torch.where(_first_rows(kc[0], c1),
                       _owner_of_key_tuple(kc, ax.size), ax.size)
    recv, rvalid = exchange_rows(list(kc) + list(vc), dest, ax.size,
                                 axis_name, kc[0].shape[0], mesh=mesh)
    nk = len(keys)
    re_aggs = tuple("sum" if a == "count" else a for a in part_aggs)
    k2, v2, c2 = groupby_multi(tuple(recv[:nk]), tuple(recv[nk:]), re_aggs,
                               valid=rvalid, config=config)
    out = dict(zip(keys, k2))
    for n_, a, idx, vdtype in assemble:
        if a == "mean":
            md = _mean_dtype(vdtype)
            out[n_] = v2[idx[0]].to(md) / v2[idx[1]].to(md)
        elif a in ("var", "std"):
            out[n_] = _moments_to_var(v2[idx[0]], v2[idx[1]], v2[idx[2]], a,
                                      vdtype)
        else:
            out[n_] = v2[idx[0]]
    return out, c2


@traced
def _dist_gather(cols, cnt, ax):
    """Gather the sharded running result to a replicated, compacted view
    (order_by/limit need the global view; meant for small, aggregated
    results)."""
    from cuda.radixsort_tpu_torch.parallel import comm

    gathered = _rows(cols) * sum(v.dtype.itemsize for v in cols.values())
    if gathered > _GATHER_WARN_BYTES:
        warnings.warn(
            f"distributed plan order_by/limit gathers ~{gathered >> 20}"
            " MiB per shard to EVERY device (replicated view); order large"
            " tables with parallel.dsort before the plan, or move order_by"
            " after the aggregation", stacklevel=3)
    gvalid = comm.all_gather(_prefix(cols, cnt), ax, tiled=True)
    gcols = {k: comm.all_gather(v, ax, tiled=True) for k, v in cols.items()}
    out, _ = filter_columns(gvalid, gcols)
    return out, comm.psum(cnt, ax)
