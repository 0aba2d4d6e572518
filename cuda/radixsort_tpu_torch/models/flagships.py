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


REGISTRY = {
    "sort_u32": sort_u32,
    "sort_pairs_u64": sort_pairs_u64,
    "sort_pairs_u32": sort_pairs_u32,
    "fk_join": fk_join,
    "groupby_zipf": groupby_zipf,
    "outer_join_agg": outer_join_agg,
}
