"""Flagship pipelines: the engine's end-to-end configurations.

Counterpart of ``cuda/radixsort_tpu/models/flagships.py``. Each recipe
returns ``(fn, args)``: ``fn(*args)`` runs the pipeline through the public
entry points. The args are made on ``device`` from the caller's seeded
``torch.Generator``, which must live on that device. The two frameworks'
generators differ, so the same seed gives other numbers than the JAX
recipes; the shapes and the key distributions are theirs.
"""

from __future__ import annotations

import torch

from cuda.radixsort_tpu_torch.ops.aggregate import groupby
from cuda.radixsort_tpu_torch.ops.join import join
from cuda.radixsort_tpu_torch.ops.sort import sort, sort_pairs, sort_struct
from cuda.radixsort_tpu_torch.ops.window import window
from cuda.radixsort_tpu_torch.pipeline.query import filter_sort_join
from cuda.radixsort_tpu_torch.table import Table


def _check_generator(generator: torch.Generator, device) -> torch.device:
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"recipe's data on {device}")
    return device


def _rng_u32(n: int, generator: torch.Generator, device) -> torch.Tensor:
    """n uniform u32 values, as a signed int64 in [0, 2^32)."""
    return torch.randint(0, 1 << 32, (n,), dtype=torch.int64, device=device,
                         generator=generator)


def _as_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> torch.uint32 with the same values."""
    return x.to(torch.int32).view(torch.uint32)


def _arange_u32(n: int, device, step: int = 1) -> torch.Tensor:
    return _as_u32(torch.arange(n, dtype=torch.int64, device=device) * step)


def sort_u32(n: int = 1 << 20, *, generator: torch.Generator,
             device="cuda"):
    """Keys-only u32 sort."""
    device = _check_generator(generator, device)
    return sort, (_as_u32(_rng_u32(n, generator, device)),)


def sort_pairs_u64(n: int = 1 << 18, *, generator: torch.Generator,
                   device="cuda"):
    """Stable (u64 as a (hi, lo) struct key, i32 payload) pair sort."""
    device = _check_generator(generator, device)

    def fn(hi, lo, pay):
        (ohi, olo), op = sort_struct((hi, lo), pay)
        return ohi, olo, op

    hi = _as_u32(_rng_u32(n, generator, device))
    lo = _as_u32(_rng_u32(n, generator, device))
    return fn, (hi, lo, torch.arange(n, dtype=torch.int32, device=device))


def sort_pairs_u32(n: int = 1 << 18, *, generator: torch.Generator,
                   device="cuda"):
    """Stable (u32 key, u32 payload) pairs."""
    device = _check_generator(generator, device)
    keys = _as_u32(_rng_u32(n, generator, device))
    pay = _as_u32(_rng_u32(n, generator, device))
    return sort_pairs, (keys, pay)


def fk_join(n_probe: int = 1 << 18, n_build: int = 1 << 14, *,
            generator: torch.Generator, device="cuda"):
    """FK inner join: probe rows against a unique-key build table."""
    device = _check_generator(generator, device)

    def fn(build_keys, build_vals, probe_keys):
        return join(build_keys, build_vals, probe_keys, how="inner")

    bk = _arange_u32(n_build, device)
    pk = _as_u32(_rng_u32(n_probe, generator, device) % n_build)
    return fn, (bk, bk.view(torch.int32).clone(), pk)


def groupby_zipf(n: int = 1 << 18, *, generator: torch.Generator,
                 device="cuda"):
    """Group-by sum over skewed keys: half the rows share one key, the rest
    spread over 1000 keys."""
    device = _check_generator(generator, device)

    def fn(keys, vals):
        return groupby(keys, vals, agg="sum")

    k = _rng_u32(n, generator, device)
    k = _as_u32(torch.where(k < (1 << 31), 42, k % 1000))
    return fn, (k, torch.arange(n, dtype=torch.int32, device=device))


def outer_join_agg(n_probe: int = 1 << 18, n_build: int = 1 << 14, *,
                   generator: torch.Generator, device="cuda"):
    """A full outer join feeding a grouped mean: build keys are the even
    numbers below 2 n_build, probe keys uniform below 2 n_build."""
    device = _check_generator(generator, device)

    def fn(build_keys, build_vals, probe_keys):
        ok, ov, _, cnt, _ = join(build_keys, build_vals, probe_keys,
                                 how="full")
        valid = torch.arange(ok.shape[0], dtype=torch.int32,
                             device=ok.device) < cnt
        return groupby(ok, ov, agg="mean", valid=valid)

    bk = _arange_u32(n_build, device, step=2)
    pk = _as_u32(_rng_u32(n_probe, generator, device) % (2 * n_build))
    return fn, (bk, bk.view(torch.int32).clone(), pk)


PROBE_VALUE_RANGE = 1 << 20  # filter_sort_join_query's probe values


def filter_sort_join_query(n_probe: int = 1 << 18, n_build: int = 1 << 14,
                           *, generator: torch.Generator, device="cuda"):
    """The pipelined query: filter -> join -> compact, with stats. Probe
    values are uniform in [0, PROBE_VALUE_RANGE) and the threshold is half
    the range, so about half the probe rows pass at any size."""
    device = _check_generator(generator, device)
    threshold = PROBE_VALUE_RANGE // 2

    def fn(probe_keys, probe_vals, build_keys, build_vals):
        return filter_sort_join(probe_keys, probe_vals, build_keys,
                                build_vals, threshold)

    bk = _arange_u32(n_build, device)
    pk = _as_u32(_rng_u32(n_probe, generator, device) % n_build)
    pv = (_rng_u32(n_probe, generator, device)
          % PROBE_VALUE_RANGE).to(torch.int32)
    return fn, (pk, pv, bk, bk.view(torch.int32).clone())


def table_query(n: int = 1 << 18, n_build: int = 1 << 14, *,
                generator: torch.Generator, device="cuda"):
    """Column-batch Table pipeline: filter -> join -> groupby. As in the
    reference, the Table methods pass no count along: the join and the
    group-by see the filter's dropped tail rows and the join's tail (the
    build rows) too."""
    device = _check_generator(generator, device)

    def fn(k, v, bk, bv):
        t = Table({"k": k, "v": v})
        f, _ = t.filter(v > 0)
        j, _ = f.join(Table({"k": bk, "bval": bv}), on="k", value="bval")
        g, gcnt = j.groupby("k", "bval", agg="sum")
        return g["k"], g["bval"], gcnt

    bk = _arange_u32(n_build, device)
    k = _as_u32(_rng_u32(n, generator, device) % n_build)
    v = (_rng_u32(n, generator, device) % 200).to(torch.int32) - 100
    return fn, (k, v, bk, bk.view(torch.int32).clone())


def window_pipeline(n: int = 1 << 18, *, generator: torch.Generator,
                    device="cuda"):
    """Analytics window pipeline: row_number, rank and a running total per
    partition, in one struct sort (1024 partitions, order keys below
    2^20)."""
    device = _check_generator(generator, device)

    def fn(part, order, vals):
        sp, _, _, wc, cnt = window(
            part, order, {"v": vals},
            (("rn", None, "row_number"), ("rk", None, "rank"),
             ("cs", "v", "cumsum")))
        return sp, wc["rn"], wc["rk"], wc["cs"], cnt

    part = _as_u32(_rng_u32(n, generator, device) % (1 << 10))
    order = _as_u32(_rng_u32(n, generator, device) % (1 << 20))
    vals = (_rng_u32(n, generator, device) % 99).to(torch.int32)
    return fn, (part, order, vals)


REGISTRY = {
    "sort_u32": sort_u32,
    "sort_pairs_u64": sort_pairs_u64,
    "sort_pairs_u32": sort_pairs_u32,
    "fk_join": fk_join,
    "groupby_zipf": groupby_zipf,
    "filter_sort_join_query": filter_sort_join_query,
    "table_query": table_query,
    "window_pipeline": window_pipeline,
    "outer_join_agg": outer_join_agg,
}
