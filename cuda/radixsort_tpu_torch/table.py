"""Column-batch tables: named, equal-length 1-D columns on one device.

Counterpart of ``cuda/radixsort_tpu/table.py``. A Table is an immutable
mapping of names to columns; every method lowers onto the ported
operators (``ops/*.py``). Operators that drop rows (filter, join) return
(table, count) with rows [0, count) valid: the tail holds real dropped
rows, which later operators of a Table do not mask (``pipeline/plan.py``
threads the count). It is a plain class: the reference's pytree protocol
has no counterpart.

Sharding is SPMD, in two forms. Positional: every rank calls
``Table.shard`` with the same full table and keeps its own padded block,
which records the global row count; the distributed operators below take
such a table (or shard a full one) and return this rank's block with the
(ndev,) counts and the statistics every rank shares (``parallel/*.py``).
Partitioned: every rank calls ``Table.from_partition`` with its own rows
only, of any number (a hash partition, as a warehouse holds it); the block
records this rank's count, and ``Query.run(mesh=)`` runs on it, sizing
each exchange by the rows it moves. A block stays marked as one:
``select`` and ``with_column`` keep the mark, the distributed operators
mark the blocks they return, and the one-device operators, which would
see only this rank's rows, refuse a block.
"""

from __future__ import annotations

from typing import Iterable, Mapping

import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch import twiddle
from cuda.radixsort_tpu_torch.ops.aggregate import groupby, groupby_multi
from cuda.radixsort_tpu_torch.ops.filter import filter_columns
from cuda.radixsort_tpu_torch.ops.join import join
from cuda.radixsort_tpu_torch.ops.partition import partition
from cuda.radixsort_tpu_torch.ops.sort import sort_pairs, sort_struct
from cuda.radixsort_tpu_torch.ops.window import window_table

class Table:
    """Immutable named-column batch. Columns: equal-length 1-D tensors."""

    def __init__(self, columns: Mapping[str, torch.Tensor], *,
                 global_rows: int | None = None, count=None):
        """``global_rows``: set on one rank's block of a sharded table, the
        whole table's row count (on a block a plan returns, its length
        times the ranks). ``count``: set on a block of a partitioned table,
        this rank's valid rows [0, count) (an int or a 0-d tensor)."""
        cols = dict(columns)
        if not cols:
            raise ValueError("Table needs at least one column")
        lens = {k: v.shape[0] for k, v in cols.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"column lengths differ: {lens}")
        if count is not None and global_rows is None:
            raise ValueError("count= marks a block: give global_rows= too")
        self._cols = cols
        self._global_rows = global_rows
        self._count = count

    @classmethod
    def from_partition(cls, columns: Mapping[str, torch.Tensor], mesh,
                       axis_name: str = "x", *, count: int | None = None
                       ) -> "Table":
        """This rank's block of a table that is spread over the mesh axis
        as the ranks hold it: its own rows, any number of them (rows [0,
        count) valid; all by default), none of another rank's and no
        padding to the largest block. The columns are kept, not copied.
        Every rank calls it: the ranks' counts are gathered once (the host
        waits for them), and their sum is the global row count.
        ``Query.run(mesh=)`` runs on such a block, or joins it as a build
        side, with every exchange sized by the rows it moves."""
        from cuda.radixsort_tpu_torch.parallel import comm
        from cuda.radixsort_tpu_torch.utils.profiling import sync_span

        t = cls(columns)
        count = t.num_rows if count is None else int(count)
        if not 0 <= count <= t.num_rows:
            raise ValueError(f"count {count} outside a block of "
                             f"{t.num_rows} rows")
        counts = comm.all_gather(torch.full((), count, dtype=torch.int64,
                                            device=t.device),
                                 comm.Axis(mesh, axis_name))
        with sync_span("partition_counts"):
            total = int(counts.sum())
        return cls(t._cols, global_rows=total, count=count)

    def _whole(self, what: str) -> None:
        """Refuse one rank's block of a sharded table: ``what`` sees only
        this rank's rows."""
        if self._global_rows is not None:
            raise ValueError(
                f"{what}: the table is one rank's block of a sharded table "
                f"({self._global_rows} rows in all); run it through the "
                "distributed operators or Query.run(mesh=)")

    # -- basics ------------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return next(iter(self._cols.values())).shape[0]

    @property
    def device(self) -> torch.device:
        return next(iter(self._cols.values())).device

    @property
    def column_names(self) -> tuple[str, ...]:
        return tuple(sorted(self._cols))

    def column(self, name: str) -> torch.Tensor:
        return self._cols[name]

    __getitem__ = column

    def select(self, names: Iterable[str]) -> "Table":
        return Table({k: self._cols[k] for k in names},
                     global_rows=self._global_rows, count=self._count)

    def with_column(self, name: str, col: torch.Tensor) -> "Table":
        """The table with ``col`` added or replaced (on a block, this
        rank's rows of the column)."""
        d = dict(self._cols)
        d[name] = col
        return Table(d, global_rows=self._global_rows, count=self._count)

    def __repr__(self):
        return (f"Table({self.num_rows} rows, "
                f"{{{', '.join(self.column_names)}}})")

    def shard(self, mesh, axis_name: str = "x") -> "Table":
        """This rank's block of the table over the mesh axis: rows
        [d*s, (d+1)*s) of every column zero-padded to s*ndev rows (s =
        ceil(num_rows / ndev)), with the global row count recorded. Every
        rank calls it with the same full table."""
        from cuda.radixsort_tpu_torch.parallel import comm
        from cuda.radixsort_tpu_torch.parallel.shuffle import _pad_to

        self._whole("Table.shard")
        ax = comm.Axis(mesh, axis_name)
        n = self.num_rows
        s = -(-n // ax.size)
        d = ax.index
        return Table({k: _pad_to(v, s * ax.size)[d * s:(d + 1) * s]
                      for k, v in self._cols.items()}, global_rows=n)

    # -- operators ---------------------------------------------------------
    def _others(self, keys) -> tuple[str, ...]:
        return tuple(sorted(k for k in self._cols if k not in keys))

    def sort_by(self, key: str, *, descending: bool = False,
                config: config_lib.SortConfig | None = None) -> "Table":
        """Stable sort of all columns by one key column."""
        self._whole("Table.sort_by")
        names = self._others((key,))
        sk, sv = sort_pairs(self._cols[key],
                            tuple(self._cols[k] for k in names),
                            descending=descending, config=config)
        out = dict(zip(names, sv))
        out[key] = sk
        return Table(out)

    def sort_by_columns(self, keys: Iterable[str], *,
                        descending: bool = False,
                        config: config_lib.SortConfig | None = None
                        ) -> "Table":
        """Lexicographic stable sort by several key columns."""
        keys = list(keys)
        self._whole("Table.sort_by_columns")
        names = self._others(keys)
        out_keys, sv = sort_struct(tuple(self._cols[k] for k in keys),
                                   tuple(self._cols[k] for k in names),
                                   descending=descending, config=config)
        out = dict(zip(names, sv))
        out.update(zip(keys, out_keys))
        return Table(out)

    def filter(self, mask: torch.Tensor, *,
               config: config_lib.SortConfig | None = None):
        """Compact rows where mask is True. Returns (table, count): rows
        [0, count) valid (the stable 2-bit pass of the filter operator)."""
        self._whole("Table.filter")
        names = self.column_names
        cols, count = filter_columns(
            mask, tuple(self._cols[k] for k in names), config=config)
        return Table(dict(zip(names, cols))), count

    def partition_by(self, key: str, *, bits: int, by_hash: bool = False,
                     config: config_lib.SortConfig | None = None):
        """Stable partition into 2^bits buckets by the key column's top
        bits (or its hash). Returns (table, offsets)."""
        self._whole("Table.partition_by")
        names = self._others((key,))
        sk, sv, offsets = partition(
            self._cols[key], tuple(self._cols[k] for k in names),
            bits=bits, by_hash=by_hash, config=config)
        out = dict(zip(names, sv))
        out[key] = sk
        return Table(out), offsets

    def groupby(self, key: str, value: str, *, agg: str = "sum",
                config: config_lib.SortConfig | None = None):
        """Group by one column, reduce another. Returns (table[key, value],
        count)."""
        self._whole("Table.groupby")
        gk, gv, count = groupby(self._cols[key], self._cols[value], agg=agg,
                                config=config)
        return Table({key: gk, value: gv}), count

    def groupby_agg(self, keys: Iterable[str],
                    aggs: Mapping[str, tuple[str, str]], *,
                    config: config_lib.SortConfig | None = None):
        """Multi-key, multi-aggregate group-by. ``keys``: grouping columns
        (lexicographic); ``aggs``: out_name -> (value_column, agg), agg in
        sum/count/min/max/mean/var/std. Returns (table[keys...,
        out_names...], count)."""
        keys = list(keys)
        names = list(aggs)
        self._whole("Table.groupby_agg")
        clash = set(keys) & set(names)
        if clash:
            raise ValueError(f"aggregate names clash with keys: {clash}")
        kc, vc, cnt = groupby_multi(
            tuple(self._cols[k] for k in keys),
            tuple(self._cols[aggs[n][0]] for n in names),
            tuple(aggs[n][1] for n in names), config=config)
        out = dict(zip(keys, kc))
        out.update(zip(names, vc))
        return Table(out), cnt

    def distinct(self, *keys: str, config=None):
        """Distinct rows by the named columns (all when none are given),
        key-ascending. Returns (table[keys...], count)."""
        self._whole("Table.distinct")
        keys = keys or self.column_names
        kc, _, cnt = groupby_multi(tuple(self._cols[k] for k in keys), (), (),
                                   config=config)
        return Table(dict(zip(keys, kc))), cnt

    def window(self, partition_by: str, order_by: str,
               outputs: Mapping[str, object], *, descending: bool = False,
               config: config_lib.SortConfig | None = None) -> "Table":
        """Append window columns over OVER (PARTITION BY .. ORDER BY ..):
        ``outputs`` maps out_name -> fn (row_number/rank/dense_rank) or
        out_name -> (value_column, fn) (cumsum/cummin/cummax/lag/lead).
        Rows are reordered to (partition, order)."""
        self._whole("Table.window")
        spec = tuple((n, None, v) if isinstance(v, str) else (n, v[0], v[1])
                     for n, v in outputs.items())
        out, _ = window_table(dict(self._cols), partition_by, order_by, spec,
                              descending=descending, config=config)
        return Table(out)

    def join(self, build: "Table", *, on: str, value: str,
             config: config_lib.SortConfig | None = None):
        """Inner FK join: probe (self) rows against build's ``on`` column;
        brings build's ``value`` column across. Returns (table, count) with
        columns on, value and every other self column (gathered by probe
        row)."""
        self._whole("Table.join")
        build._whole("Table.join's build")
        ok, ov, oi, count = join(build[on], build[value], self._cols[on],
                                 how="inner", config=config)
        out = {on: ok, value: ov}
        rows = oi.long()
        for k, v in self._cols.items():
            if k != on:
                out[k] = twiddle.take(v, rows)
        return Table(out), count


def table(**columns) -> Table:
    """Convenience constructor: table(a=..., b=...)."""
    return Table(columns)


def _sharded(t: Table, mesh, axis_name):
    """(this rank's block, global rows) of a sharded table; a table without
    the mark is the whole table, the same on every rank, and is sharded."""
    if t._global_rows is None:
        t = t.shard(mesh, axis_name)
    return t, t._global_rows


def _block(columns, mesh, axis_name) -> Table:
    """A distributed operator's output block, marked as one: every rank
    holds as many rows."""
    from cuda.radixsort_tpu_torch.parallel import comm

    rows = next(iter(columns.values())).shape[0]
    return Table(columns, global_rows=rows * comm.Axis(mesh, axis_name).size)


def groupby_distributed(t: Table, key: str, value: str, *, mesh,
                        axis_name: str = "x", agg: str = "sum"):
    """Sized two-phase distributed group-by of a sharded table. Returns
    (this rank's Table[key, value], (ndev,) counts, stats)."""
    from cuda.radixsort_tpu_torch.parallel.shuffle import (
        groupby_distributed_sized)

    t, n = _sharded(t, mesh, axis_name)
    gk, gv, cnt, _cap, st = groupby_distributed_sized(
        t[key], t[value], mesh=mesh, axis_name=axis_name, agg=agg, n=n)
    return _block({key: gk, value: gv}, mesh, axis_name), cnt, st


def join_distributed(probe: Table, build: Table, *, on: str, value: str,
                     mesh, axis_name: str = "x",
                     broadcast_threshold: int | None = None):
    """Distributed inner join of a sharded probe table against a build
    table (the whole table on every rank), routed by build size
    (``parallel/shuffle.py::join_distributed``). Returns (this rank's
    Table[on, value, probe_row], (ndev,) counts, stats); probe_row is the
    global probe row."""
    from cuda.radixsort_tpu_torch.parallel import shuffle

    build._whole("join_distributed's build")
    probe, n = _sharded(probe, mesh, axis_name)
    ok, ov, oi, cnt, st = shuffle.join_distributed(
        build[on], build[value], probe[on], mesh=mesh, axis_name=axis_name,
        broadcast_threshold=broadcast_threshold, n=n)
    return _block({on: ok, value: ov, "probe_row": oi}, mesh,
                  axis_name), cnt, st


def sort_distributed(t: Table, key: str, *, mesh, axis_name: str = "x",
                     descending: bool = False):
    """Distributed keys-only sort of one column of a sharded table.
    Returns (this rank's sorted block, counts, stats): see
    ``parallel/dsort.py``."""
    from cuda.radixsort_tpu_torch.parallel.dsort import sort_distributed as ds

    t, n = _sharded(t, mesh, axis_name)
    return ds(t[key], mesh=mesh, axis_name=axis_name, descending=descending,
              n=n)


def concat_tables(tables, counts=None):
    """UNION ALL of tables with one column set. With ``counts`` (one per
    table), each table gives rows [0, count_i), compacted to the front by
    one stable filter pass: returns (table, total_count). Without, a plain
    concatenation (every row valid)."""
    tables = list(tables)
    if not tables:
        raise ValueError("concat_tables needs at least one table")
    for t in tables:
        t._whole("concat_tables")
    names = tables[0].column_names
    for t in tables[1:]:
        if t.column_names != names:
            raise ValueError(f"column sets differ: {names} vs "
                             f"{t.column_names}")
    cols = {k: twiddle.cat([t[k] for t in tables]) for k in names}
    if counts is None:
        return Table(cols)
    if len(counts) != len(tables):
        raise ValueError(f"{len(counts)} counts for {len(tables)} tables")
    dev = tables[0].device
    mask = torch.cat([
        torch.arange(t.num_rows, dtype=torch.int32, device=dev)
        < torch.as_tensor(c, dtype=torch.int32, device=dev)
        for t, c in zip(tables, counts)])
    out, total = filter_columns(mask, tuple(cols[k] for k in names))
    return Table(dict(zip(names, out))), total
