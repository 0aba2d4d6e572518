#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py              # from the root of the repository
    python3 chip_smoke.py --profile    # also: phase 7 below

Phases, each of which fails loudly (non-zero exit, no result line):
  1. device: a CUDA card must be present; its name and power limit are printed;
  2. build: the three CUDA kernels are built from the repository's own sources;
  3. kernels: digit_histograms and partition_stage on the card against their
     plain PyTorch versions on the same inputs, bit for bit (tolerance 0), and
     segmented_scan against its plain version: integers and min/max bit for
     bit, a float32 sum within SCAN_F32_TOL of its segment's sum of |x|;
  4. slice: sort (2^24 u32 keys) and stable sort_pairs (2^28 u64 keys + u32
     payload) and smaller cases against a torch.sort oracle on the card, bit
     for bit, with the kernels' launch counters read around each path;
  5. operators: the FK inner join (probe 2^27 x build 2^24), the group-by sum
     and count over Zipf-like keys (2^26 rows) and a full outer join feeding
     a grouped mean (probe 2^22 x build 2^20), each through its recipe in
     models/flagships.py, against oracles built from torch.sort,
     torch.searchsorted, torch.unique and index_add_: bit for bit, the mean
     within MEAN_TOL; launch counters read around each path;
  6. times: CUDA-event medians of every path and of its torch oracle, and of
     each kernel beside its plain version and its one-call torch yardstick;
  7. (--profile only) a torch.profiler breakdown of every path with the
     device's idle share, and a sweep of radix_bits and items_per_thread.

The last line is {"ok": true, "device": {...}}; the line before it holds the
kernels' JSON record. The JAX package is never imported.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

N_KEYS = 1 << 24    # BASELINE.json config 1: LSD sort of 16M u32 keys
N_PAIRS = 1 << 28   # BASELINE.json config 2: 256M (u64 key, payload) pairs
N_SMALL = 1 << 20
N_PROBE, N_BUILD = 1 << 27, 1 << 24   # FK join: 151M rows through the sort
N_GROUP = 1 << 26                      # group-by over Zipf-like keys
N_OPROBE, N_OBUILD = 1 << 22, 1 << 20  # full outer join -> grouped mean
SEED = 20261016
RUNS = 5
SCAN_F32_TOL = 1e-5  # of the segment's running sum of |x|
MEAN_TOL = 1e-6      # relative, of a grouped mean (a mean of 0 exactly)
FK = "FK inner join 2^27 x 2^24"
GROUPBY = "group-by sum and count 2^26"
OUTER = "full outer join -> mean 2^22 x 2^20"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12      # float32 outside the tensor cores, same source


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def log(*args) -> None:
    print(*args, flush=True)


def sv(t: torch.Tensor) -> torch.Tensor:
    """Signed view of the same bits (CUDA torch compares signed ints)."""
    from cuda.radixsort_tpu_torch.twiddle import signed_view

    return signed_view(t)


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    expect(got.shape == want.shape, f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((sv(got).to(torch.int64) - sv(want).to(torch.int64)).abs().max())


def rand_bits(n: int, dtype: torch.dtype, gen: torch.Generator) -> torch.Tensor:
    """n random values of a 4- or 8-byte dtype, made on the card."""
    words = n * dtype.itemsize // 4
    w = torch.randint(-2**31, 2**31, (words,), dtype=torch.int64,
                      device="cuda", generator=gen).to(torch.int32)
    return w.view(dtype)


def oracle_order(bits_u: torch.Tensor) -> torch.Tensor:
    """Stable order of unsigned twiddled bits (u32 or u64) by torch.sort on a
    signed int64 view whose order equals the unsigned order."""
    if bits_u.dtype.itemsize == 4:
        k = bits_u.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    else:
        k = bits_u.view(torch.int64) ^ (-(1 << 63))
    return torch.sort(k, stable=True).indices


KERNELS = ("digit_histograms", "partition_stage", "segmented_scan")
SORT_KERNELS = KERNELS[:2]


def kernel_modules() -> dict:
    from cuda.radixsort_tpu_torch.kernels import histogram, scan, stage

    return dict(zip(KERNELS, (histogram, stage, scan)))


def run_counted(path: str, fn, needs, launches: dict):
    """Run one main path with every launch counter set to 0 just before it
    and read just after it; fail if a kernel in ``needs`` never launched.
    Adds the counts to ``launches`` (kernel -> sum over the paths)."""
    mods = kernel_modules()
    torch.cuda.synchronize()
    for m in mods.values():
        m.LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {k: m.LAUNCHES for k, m in mods.items()}
    log(f"[launches] {path}: {counts}")
    expect(all(counts[k] > 0 for k in needs),
           f"{path}: a kernel of the path was never launched: {counts}")
    for k, c in counts.items():
        launches[k] = launches.get(k, 0) + c
    return out


def u32_to_i64(t: torch.Tensor) -> torch.Tensor:
    """u32 values as int64 (torch orders and indexes these on the card)."""
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def wrap_i32(s: torch.Tensor) -> torch.Tensor:
    """int64 sums -> the int32 sums that wrap, as JAX's and the port's do."""
    return (((s + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def bound_ms(n_bytes: float, n_ops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    log(f"[device] {torch.cuda.get_device_name(0)} sm_{cap[0]}{cap[1]} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    return torch.cuda.get_device_name(0), smi


def load_port():
    """Import cuda.radixsort_tpu_torch from this checkout.

    Where cuda-python is installed, a startup hook of its (a .pth file) binds
    the top-level name `cuda` to cuda-python's namespace package before this
    script runs, which hides the checkout's `cuda/` package. Then the port is
    loaded from its path and registered under its usual name."""
    name = "cuda.radixsort_tpu_torch"
    pkg_dir = os.path.join(HERE, "cuda", "radixsort_tpu_torch")
    if not os.path.isfile(os.path.join(pkg_dir, "__init__.py")):
        raise ImportError(f"{name} not found under {HERE}: run this script "
                          "from a checkout of the repository")
    parent = sys.modules.get("cuda")
    parent_file = getattr(parent, "__file__", None) or ""
    if parent is None or os.path.dirname(parent_file) == os.path.join(HERE, "cuda"):
        return importlib.import_module(name)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    setattr(parent, "radixsort_tpu_torch", mod)
    log(f"[device] `cuda` is {parent!r}; loaded the port from {pkg_dir}")
    return mod


def phase_build() -> float:
    from cuda.radixsort_tpu_torch.utils import build

    t0 = time.perf_counter()
    build.library()
    secs = time.perf_counter() - t0
    log(f"[build] {len(build.sources())} sources -> {build.BUILD_DIR} in "
        f"{secs:.1f} s")
    return secs


def make_keys(case: str, n: int, gen: torch.Generator) -> torch.Tensor:
    keys = rand_bits(n, torch.uint32, gen)
    if case == "constant":
        keys = torch.full((n,), 0x5A5A1234, dtype=torch.int32,
                          device="cuda").view(torch.uint32)
    elif case == "skew90":
        hot = torch.rand(n, device="cuda", generator=gen) < 0.9
        k = keys.view(torch.int32).clone()
        k[hot] = 0x12345678
        keys = k.view(torch.uint32)
    return keys


def phase_kernels(gen: torch.Generator) -> dict:
    from cuda.radixsort_tpu_torch.kernels import histogram as hist
    from cuda.radixsort_tpu_torch.kernels import stage

    errs = {"digit_histograms": 0, "partition_stage": 0}
    keys = rand_bits(N_KEYS, torch.uint32, gen)
    for width in (8, 4, 2):
        got = hist.digit_histograms(keys, n_stages=32 // width, width=width)
        torch.cuda.synchronize()
        want = hist.digit_histograms_plain(keys, n_stages=32 // width, width=width)
        e = max_abs_err(got, want)
        expect(e == 0, f"digit_histograms width {width}: max err {e}")
        errs["digit_histograms"] = max(errs["digit_histograms"], e)
    log(f"[kernels] digit_histograms == plain at N=2^24, widths 8/4/2")

    n_cases = 0
    shapes = [(n, p) for n in (N_KEYS, N_KEYS - 777) for p in (1, 3)]
    shapes.append((N_SMALL + 5, 10))  # more planes than one scatter launch takes
    for n, n_planes in shapes:
        for case in ("random", "constant", "skew90"):
            keys = make_keys(case, n, gen)
            planes = [keys] + [rand_bits(n, torch.uint32, gen)
                               for _ in range(n_planes - 1)]
            for width in (8, 4, 2):
                for shift in (0, 24):
                    if n_planes == 10 and (width, shift) != (8, 0):
                        continue
                    h = hist.digit_histograms_plain(keys, n_stages=32 // width,
                                                    width=width)
                    gbase = hist.stage_bases(h)[shift // width].contiguous()
                    got = stage.partition_stage(planes, gbase, shift=shift,
                                                width=width)
                    torch.cuda.synchronize()
                    want = stage.partition_stage_plain(planes, gbase,
                                                       shift=shift, width=width)
                    for q, (g, w) in enumerate(zip(got, want)):
                        e = max_abs_err(g, w)
                        expect(e == 0, f"partition_stage n={n} planes={n_planes} "
                               f"{case} width={width} shift={shift} plane {q}: "
                               f"max err {e}")
                        errs["partition_stage"] = max(errs["partition_stage"], e)
                    n_cases += 1
    log(f"[kernels] partition_stage == plain on {n_cases} cases "
        f"(N=2^24 and 2^24-777, 1/3 planes, widths 8/4/2, shifts 0/24, "
        f"random/constant/90%-one-key; 10 planes at 2^20+5)")
    del keys, planes, got, want

    # Config 2's shapes: both kernels at 2^28 keys, width 8, on the low key
    # limb with the high limb and the u32 payload riding along (3 planes).
    planes = [rand_bits(N_PAIRS, torch.uint32, gen) for _ in range(3)]
    got = hist.digit_histograms(planes[0], n_stages=4, width=8)
    torch.cuda.synchronize()
    h = hist.digit_histograms_plain(planes[0], n_stages=4, width=8)
    e = max_abs_err(got, h)
    expect(e == 0, f"digit_histograms 2^28 width 8: max err {e}")
    errs["digit_histograms"] = max(errs["digit_histograms"], e)
    for shift in (0, 24):
        gbase = hist.stage_bases(h)[shift // 8].contiguous()
        got = stage.partition_stage(planes, gbase, shift=shift, width=8)
        torch.cuda.synchronize()
        want = stage.partition_stage_plain(planes, gbase, shift=shift, width=8)
        for q, (g, w) in enumerate(zip(got, want)):
            e = max_abs_err(g, w)
            expect(e == 0, f"partition_stage 2^28 3 planes shift={shift} "
                   f"plane {q}: max err {e}")
            errs["partition_stage"] = max(errs["partition_stage"], e)
        del got, want
    del planes
    torch.cuda.empty_cache()
    log("[kernels] digit_histograms (width 8, 4 stages) and partition_stage "
        "(width 8, 3 planes, shifts 0/24) == plain at N=2^28")
    return errs


def check_sort(name, got_keys, keys, descending=False, end_bit=None,
               got_vals=(), vals=()):
    """Bit-exact check against the oracle: torch.sort(stable) of the twiddled
    bits (restricted to [0, end_bit)), with every column gathered by it. The
    sort returns -0.0 as +0.0 (as the JAX reference does), so the expected
    keys are the twiddle round trip of the input."""
    from cuda.radixsort_tpu_torch import twiddle

    bits = twiddle.twiddle_in(keys, descending=descending)
    canon = twiddle.twiddle_out(bits, keys.dtype, descending=descending)
    if end_bit is not None:
        bits = (sv(bits) & ((1 << end_bit) - 1)).view(bits.dtype)
    order = oracle_order(bits)
    e = max_abs_err(got_keys, sv(canon)[order])
    for g, v in zip(got_vals, vals):
        e = max(e, max_abs_err(g, sv(v)[order]))
    expect(e == 0, f"{name}: differs from the torch.sort oracle (max err {e})")
    return e


def phase_slice(gen: torch.Generator) -> dict:
    import cuda.radixsort_tpu_torch as rt
    from cuda.radixsort_tpu_torch import twiddle

    keys1 = rand_bits(N_KEYS, torch.uint32, gen)
    keys2 = rand_bits(N_PAIRS, torch.uint64, gen)
    pay2 = rand_bits(N_PAIRS, torch.uint32, gen)
    torch.cuda.synchronize()

    launches: dict = {}
    out1 = run_counted("config 1 sort 2^24 u32", lambda: rt.sort(keys1),
                       SORT_KERNELS, launches)
    out2k, out2v = run_counted("config 2 sort_pairs 2^28 u64+u32",
                               lambda: rt.sort_pairs(keys2, pay2),
                               SORT_KERNELS, launches)

    expect(out1.dtype == torch.uint32 and out1.shape == keys1.shape,
           "config 1 output dtype/shape")
    check_sort("sort 2^24 u32", out1, keys1)
    del out1
    expect(out2k.dtype == torch.uint64 and out2v.dtype == torch.uint32,
           "config 2 output dtypes")
    check_sort("sort_pairs 2^28 u64+u32", out2k, keys2, got_vals=[out2v],
               vals=[pay2])
    del out2k, out2v, keys2, pay2
    torch.cuda.empty_cache()
    log("[slice] sort (2^24 u32) and stable sort_pairs (2^28 u64 + u32) == oracle")

    # smaller cases with many ties, so stability shows through an index
    idx = torch.arange(N_SMALL, dtype=torch.int32, device="cuda")
    ku = (rand_bits(N_SMALL, torch.uint32, gen).view(torch.int32)
          & 0xFFF0FFFF).view(torch.uint32)
    k, (i,) = rt.sort_pairs(ku, [idx], descending=True)
    check_sort("descending pairs", k, ku, descending=True, got_vals=[i], vals=[idx])
    k, i = rt.sort_pairs(ku, idx, end_bit=16)
    check_sort("end_bit=16 pairs", k, ku, end_bit=16, got_vals=[i], vals=[idx])
    kf = rand_bits(N_SMALL, torch.float32, gen).clone()
    kf[:4] = torch.tensor([0.0, -0.0, float("nan"), -float("nan")],
                          device="cuda")
    # half the keys from a few values, both zeros among them: ties
    few = torch.tensor([-1.0, -0.0, 0.0, 1.0, 2.0], device="cuda")
    kf[4:N_SMALL // 2] = few[torch.randint(0, 5, (N_SMALL // 2 - 4,),
                                           device="cuda", generator=gen)]
    k, i = rt.sort_pairs(kf, idx)
    check_sort("f32 pairs with -0.0/NaN", k, kf, got_vals=[i], vals=[idx])
    a = rt.argsort(kf, descending=True)
    want = oracle_order(twiddle.twiddle_in(kf, descending=True))
    expect(torch.equal(a, want.to(torch.int32)), "argsort f32 descending")
    log("[slice] descending, end_bit=16, f32 -0.0/NaN pairs and argsort == oracle "
        "at 2^20")
    return launches


def _scan_case(values, flags, op) -> float:
    """segmented_scan on the card against its plain version on the same
    inputs. Integers and min/max bit for bit (NaN where the plain version
    has NaN); a float32 sum within SCAN_F32_TOL of the running sum of |x|
    over its segment. Returns the largest absolute difference."""
    from cuda.radixsort_tpu_torch.kernels import scan as kscan

    got = kscan.segmented_scan(values, flags, op)
    torch.cuda.synchronize()
    want = kscan.segmented_scan_plain(values, flags, op)
    what = f"segmented_scan {op} {values.dtype} n={values.numel()}"
    if values.dtype != torch.float32:
        e = max_abs_err(got, want)
        expect(e == 0, f"{what}: max err {e}")
        return float(e)
    g_nan, w_nan = torch.isnan(got), torch.isnan(want)
    expect(torch.equal(g_nan, w_nan), f"{what}: NaN at other rows")
    diff = torch.where(w_nan, 0.0, (got.double() - want.double()).abs())
    if op == "sum":
        heads = flags.to(torch.bool).clone()
        heads[0] = True
        scale = kscan.segmented_doubling(values.double().abs(), heads, torch.add)
        ok = w_nan | (diff <= SCAN_F32_TOL * scale)
    else:  # bit for bit, NaN aside
        ok = w_nan | (sv(got) == sv(want))
    expect(bool(ok.all()), f"{what}: max err {float(diff.max())} beyond "
           "its tolerance")
    return float(diff.max())


def phase_scan_kernel(gen: torch.Generator) -> dict:
    """Returns the largest difference of the exact cases (integers, min/max)
    and, apart, of the float32 sums, which have a tolerance."""
    errs = {"exact": 0.0, "f32_sum": 0.0}
    n_cases = 0

    def case(values, flags, op):
        nonlocal n_cases
        kind = "f32_sum" if (values.dtype, op) == (torch.float32, "sum") else "exact"
        errs[kind] = max(errs[kind], _scan_case(values, flags, op))
        n_cases += 1

    for n in (N_KEYS, N_KEYS + 12345):
        flags = torch.rand(n, device="cuda", generator=gen) < 0.01
        for dtype in (torch.int32, torch.uint32, torch.float32):
            if dtype == torch.float32:
                values = torch.randn(n, device="cuda", generator=gen) * 100
                values[torch.randint(0, n, (64,), device="cuda",
                                     generator=gen)] = float("nan")
            else:
                values = rand_bits(n, dtype, gen)
            for op in ("sum", "min", "max"):
                case(values, flags, op)
    n = N_KEYS + 12345
    edge_flags = {"tile-boundary heads": torch.arange(n, device="cuda") % 4096 == 0,
                  "one segment over every tile": torch.zeros(n, dtype=torch.bool,
                                                             device="cuda"),
                  "every row a head": torch.ones(n, dtype=torch.bool,
                                                 device="cuda")}
    for flags in edge_flags.values():
        for dtype, op in ((torch.int32, "sum"), (torch.float32, "sum"),
                          (torch.uint32, "max"), (torch.float32, "min")):
            values = (torch.randn(n, device="cuda", generator=gen)
                      if dtype == torch.float32 else rand_bits(n, dtype, gen))
            case(values, flags, op)
    log(f"[kernels] segmented_scan == plain on {n_cases} cases (sum/min/max x "
        f"int32/uint32/float32 at 2^24 and 2^24+12345 with 1% heads and NaNs "
        f"among the floats; {', '.join(edge_flags)}); max abs err {errs['exact']} "
        f"(integers, min/max), {errs['f32_sum']} (float32 sums, within "
        f"{SCAN_F32_TOL} of the segment's sum of |x|)")
    torch.cuda.empty_cache()
    return errs


def oracle_fk_join(bk, bv, pk):
    """Inner join by torch.sort + torch.searchsorted: each probe row meets
    the last build row of its key; rows in key order, ties in probe order.
    Returns (keys as int32 bits, vals, probe_idx, count, sorted build)."""
    bs = torch.sort(u32_to_i64(bk), stable=True)
    pk64 = u32_to_i64(pk)
    idx = torch.searchsorted(bs.values, pk64, right=True) - 1
    safe = idx.clamp_min(0)
    matched = (idx >= 0) & (bs.values[safe] == pk64)
    val = bv[bs.indices[safe]]
    order = torch.sort(pk64, stable=True).indices
    sel = order[matched[order]]
    return (pk.view(torch.int32)[sel], val[sel], sel.to(torch.int32),
            int(matched.sum()), bs)


def oracle_groupby(keys, vals):
    """Group sums (int32, wrapping) and counts by torch.unique + index_add_."""
    uniq, inv = torch.unique(u32_to_i64(keys), sorted=True,
                             return_inverse=True)
    sums = torch.zeros(uniq.numel(), dtype=torch.int64, device=keys.device)
    sums.index_add_(0, inv, vals.to(torch.int64))
    counts = torch.bincount(inv, minlength=uniq.numel())
    return uniq.to(torch.int32), wrap_i32(sums), counts.to(torch.int32)


def oracle_outer_mean(bk, bv, pk):
    """The full outer join's rows (probe rows with their build value or 0,
    build rows no probe row meets with their own), then the grouped mean as
    float32(int32 sum) / float32(count)."""
    bs = torch.sort(u32_to_i64(bk), stable=True)
    pk64 = u32_to_i64(pk)
    idx = torch.searchsorted(bs.values, pk64, right=True) - 1
    safe = idx.clamp_min(0)
    matched = (idx >= 0) & (bs.values[safe] == pk64)
    pval = torch.where(matched, bv[bs.indices[safe]], 0)
    ps = torch.sort(pk64).values
    j = torch.searchsorted(ps, u32_to_i64(bk)).clamp_max(ps.numel() - 1)
    build_only = ps[j] != u32_to_i64(bk)
    rows_k = torch.cat([pk.view(torch.int32), bk.view(torch.int32)[build_only]])
    rows_v = torch.cat([pval, bv[build_only]])
    gk, sums, counts = oracle_groupby(rows_k.view(torch.uint32), rows_v)
    return gk, sums.to(torch.float32) / counts.to(torch.float32)


def operator_paths(gen: torch.Generator) -> dict:
    """name -> (fn, args, rows, oracle) of the three operator paths."""
    from cuda.radixsort_tpu_torch.models import flagships

    fk = flagships.fk_join(N_PROBE, N_BUILD, generator=gen, device="cuda")
    gz_fn, gz_args = flagships.groupby_zipf(N_GROUP, generator=gen,
                                            device="cuda")

    def groupby_sum_and_count(keys, vals):
        import cuda.radixsort_tpu_torch as rt

        return gz_fn(keys, vals), rt.groupby(keys, agg="count")

    oj = flagships.outer_join_agg(N_OPROBE, N_OBUILD, generator=gen,
                                  device="cuda")
    return {
        FK: (*fk, N_PROBE + N_BUILD, oracle_fk_join),
        GROUPBY: (groupby_sum_and_count, gz_args, N_GROUP, oracle_groupby),
        OUTER: (*oj, N_OPROBE + N_OBUILD, oracle_outer_mean),
    }


def phase_operators(gen: torch.Generator, launches: dict) -> dict:
    """Each operator path once, counted, against its oracle. Returns the
    largest relative error of the grouped mean."""
    paths = operator_paths(gen)
    errs = {}

    name = FK
    fn, args, _, oracle = paths[name]
    ok, ov, oi, count = run_counted(name, lambda: fn(*args), KERNELS, launches)
    wk, wv, wi, wcount, bs = oracle(*args)
    expect(count.dim() == 0 and count.dtype == torch.int32
           and int(count) == wcount, f"{name}: count {int(count)} != {wcount}")
    c = wcount
    for what, g, w in (("keys", ok[:c], wk), ("vals", ov[:c], wv),
                       ("probe_idx", oi[:c], wi)):
        e = max_abs_err(g, w)
        expect(e == 0, f"{name}: {what} differ from the oracle (max err {e})")
    # every probe row matches, so the tail holds the build rows in key order
    expect(c == N_PROBE, f"{name}: {c} of {N_PROBE} probe rows matched")
    tail_ok = (torch.equal(ok[c:].view(torch.int32), bs.values.to(torch.int32))
               and torch.equal(ov[c:], args[1][bs.indices])
               and not bool(oi[c:].any()))
    expect(tail_ok, f"{name}: the tail is not the build rows in key order")
    log(f"[operators] {name}: ok, ov, oi, count == oracle bit for bit "
        f"(count {c}, tail included)")
    del ok, ov, oi, wk, wv, wi, bs, paths[name]
    torch.cuda.empty_cache()

    name = GROUPBY
    fn, args, _, oracle = paths[name]
    (gk, gs, gc), (ck, cc, ccount) = run_counted(name, lambda: fn(*args),
                                                 KERNELS, launches)
    wk, ws, wc = oracle(*args)
    c = wk.numel()
    expect(int(gc) == c and int(ccount) == c,
           f"{name}: {int(gc)} / {int(ccount)} groups, oracle {c}")
    for what, g, w in (("sum keys", gk[:c], wk), ("sums", gs[:c], ws),
                       ("count keys", ck[:c], wk), ("counts", cc[:c], wc)):
        e = max_abs_err(g, w)
        expect(e == 0, f"{name}: {what} differ from the oracle (max err {e})")
    log(f"[operators] {name}: keys, int32 sums (wrapping) and counts == "
        f"oracle bit for bit ({c} groups; the largest holds "
        f"{int(wc.max())} rows)")
    del gk, gs, ck, cc, wk, ws, wc, paths[name]
    torch.cuda.empty_cache()

    name = OUTER
    fn, args, _, oracle = paths[name]
    gk, gm, gcount = run_counted(name, lambda: fn(*args), KERNELS, launches)
    wk, wm = oracle(*args)
    c = wk.numel()
    expect(int(gcount) == c, f"{name}: {int(gcount)} groups, oracle {c}")
    e = max_abs_err(gk[:c], wk)
    expect(e == 0, f"{name}: keys differ from the oracle (max err {e})")
    diff = (gm[:c] - wm).abs()
    expect(bool((diff <= MEAN_TOL * wm.abs()).all()),
           f"{name}: a mean is off by more than {MEAN_TOL} relative")
    rel = float((diff / wm.abs().clamp_min(1e-30)).max())
    errs["mean_rel_err"] = rel
    errs["mean_abs_err"] = float((gm[:c] - wm).abs().max())
    log(f"[operators] {name}: keys and count == oracle bit for bit, mean "
        f"within {rel} relative ({c} groups)")
    torch.cuda.empty_cache()
    return errs


def phase_times(gen: torch.Generator) -> dict:
    import cuda.radixsort_tpu_torch as rt
    from cuda.radixsort_tpu_torch.kernels import histogram as hist
    from cuda.radixsort_tpu_torch.kernels import scan as kscan
    from cuda.radixsort_tpu_torch.kernels import stage
    from cuda.radixsort_tpu_torch.utils.profiling import cuda_time_ms

    t = {}
    keys1 = rand_bits(N_KEYS, torch.uint32, gen)
    t["sort_ms"] = cuda_time_ms(lambda: rt.sort(keys1), runs=RUNS)
    # baseline: torch.sort of an int32 view whose order is the u32 order
    k32 = keys1.view(torch.int32) ^ (-(1 << 31))
    t["torch_sort_ms"] = cuda_time_ms(lambda: torch.sort(k32, stable=True),
                                      runs=RUNS)

    t["hist_ms"] = cuda_time_ms(
        lambda: hist.digit_histograms(keys1, n_stages=4, width=8), runs=RUNS)
    t["hist_plain_ms"] = cuda_time_ms(
        lambda: hist.digit_histograms_plain(keys1, n_stages=4, width=8),
        runs=RUNS)
    gbase = hist.stage_bases(hist.digit_histograms(keys1, n_stages=4,
                                                   width=8))[0].contiguous()
    for n_planes in (1, 3):
        planes = [keys1] + [rand_bits(N_KEYS, torch.uint32, gen)
                            for _ in range(n_planes - 1)]
        out = [torch.empty_like(p) for p in planes]
        t[f"stage{n_planes}_ms"] = cuda_time_ms(
            lambda: stage.partition_stage(planes, gbase, shift=0, width=8,
                                          out=out), runs=RUNS)
        t[f"stage{n_planes}_plain_ms"] = cuda_time_ms(
            lambda: stage.partition_stage_plain(planes, gbase, shift=0,
                                                width=8, out=out), runs=RUNS)
    del keys1, k32, planes, out

    keys2 = rand_bits(N_PAIRS, torch.uint64, gen)
    pay2 = rand_bits(N_PAIRS, torch.uint32, gen)
    t["pairs_ms"] = cuda_time_ms(lambda: rt.sort_pairs(keys2, pay2), runs=RUNS)
    s64 = keys2.view(torch.int64) ^ (-(1 << 63))
    t["torch_pairs_ms"] = cuda_time_ms(
        lambda: pay2.view(torch.int32)[torch.sort(s64, stable=True).indices],
        runs=RUNS)
    del keys2, pay2, s64
    torch.cuda.empty_cache()

    # the scan: int32 sums with 1% heads, and the unsegmented sum and max
    # (plain_scan_fast) beside their one-call torch counterparts
    values = rand_bits(N_KEYS, torch.int32, gen)
    heads = torch.rand(N_KEYS, device="cuda", generator=gen) < 0.01
    none = torch.zeros(N_KEYS, dtype=torch.bool, device="cuda")
    t["scan_ms"] = cuda_time_ms(
        lambda: kscan.segmented_scan(values, heads, "sum"), runs=RUNS)
    t["scan_plain_ms"] = cuda_time_ms(
        lambda: kscan.segmented_scan_plain(values, heads, "sum"), runs=RUNS)
    t["scan_sum_noheads_ms"] = cuda_time_ms(
        lambda: kscan.segmented_scan(values, none, "sum"), runs=RUNS)
    t["scan_max_noheads_ms"] = cuda_time_ms(
        lambda: kscan.segmented_scan(values, none, "max"), runs=RUNS)
    t["cumsum_ms"] = cuda_time_ms(
        lambda: torch.cumsum(values, 0, dtype=torch.int32), runs=RUNS)
    t["cummax_ms"] = cuda_time_ms(lambda: torch.cummax(values, 0), runs=RUNS)
    del values, heads, none

    for name, (fn, args, rows, oracle) in operator_paths(gen).items():
        t[name] = (cuda_time_ms(lambda: fn(*args), runs=RUNS),
                   cuda_time_ms(lambda: oracle(*args), runs=RUNS), rows)
        torch.cuda.empty_cache()
    t["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return t


def _device_events(prof) -> list:
    """The device-side events (kernels, copies, sets) of a profiler run."""
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _busy_us(events) -> float:
    """Microseconds in which at least one device event ran (interval union)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, f in spans:
        if f > end:
            busy += f - max(s, end)
            end = f
    return busy


def phase_profile(gen: torch.Generator) -> None:
    """--profile: where the device time of each path goes (torch.profiler,
    one call after a warm-up), the device's idle share against the call's
    CUDA-event time, and, for the sorts, a sweep of the digit width and the
    tile geometry."""
    import cuda.radixsort_tpu_torch as rt
    from cuda.radixsort_tpu_torch import config as config_lib
    from cuda.radixsort_tpu_torch.utils.profiling import cuda_time_ms
    from torch.profiler import ProfilerActivity, profile

    keys1 = rand_bits(N_KEYS, torch.uint32, gen)
    keys2 = rand_bits(N_PAIRS, torch.uint64, gen)
    pay2 = rand_bits(N_PAIRS, torch.uint32, gen)
    calls = {"config 1 sort 2^24 u32": lambda cfg=None: rt.sort(keys1, config=cfg),
             "config 2 sort_pairs 2^28 u64+u32":
                 lambda cfg=None: rt.sort_pairs(keys2, pay2, config=cfg)}
    ops = {name: (lambda fn=fn, args=args: fn(*args))
           for name, (fn, args, _, _) in operator_paths(gen).items()}
    for name, fn in {**calls, **ops}.items():
        wall_ms = cuda_time_ms(fn, runs=RUNS)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = _device_events(prof)
        expect(events, f"profile {name}: the profiler saw no device event")
        busy_ms = _busy_us(events) / 1e3
        by_name: dict[str, list] = {}
        for e in events:
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += (e.time_range.end - e.time_range.start) / 1e3
            row[1] += 1
        log(f"[profile] {name}: CUDA-event median {wall_ms:.3f} ms, device "
            f"busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
        for ev, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
            log(f"[profile]   {ms:9.3f} ms {ms / busy_ms:6.1%} x{count:<3d} {ev[:90]}")

    base = config_lib.preset()
    for name, fn in calls.items():
        for rb in (4, 8):
            ms = cuda_time_ms(lambda: fn(base.replace(radix_bits=rb)), runs=RUNS)
            log(f"[sweep] {name}: radix_bits={rb}: {ms:.3f} ms")
    for ipt in (8, 16, 32):
        ms = cuda_time_ms(
            lambda: calls["config 1 sort 2^24 u32"](
                base.replace(items_per_thread=ipt)), runs=RUNS)
        log(f"[sweep] config 1 sort 2^24 u32: items_per_thread={ipt}: {ms:.3f} ms")
    del keys1, keys2, pay2, ops
    torch.cuda.empty_cache()


def main() -> int:
    profile_run = "--profile" in sys.argv[1:]
    kind, smi = phase_device()
    load_port()
    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    errs = phase_kernels(gen)
    errs["segmented_scan"] = phase_scan_kernel(gen)
    launches = phase_slice(gen)
    op_errs = phase_operators(gen, launches)
    t = phase_times(gen)
    if profile_run:
        phase_profile(gen)

    log(f"[times] config 1 sort 2^24 u32: {t['sort_ms']:.3f} ms = "
        f"{N_KEYS / t['sort_ms'] * 1e3:.4g} keys/s "
        f"(torch.sort of the int32 view, stable: {t['torch_sort_ms']:.3f} ms)")
    log(f"[times] config 2 sort_pairs 2^28 u64+u32: {t['pairs_ms']:.3f} ms = "
        f"{N_PAIRS / t['pairs_ms'] * 1e3:.4g} pairs/s "
        f"(torch.sort int64 stable + gather: {t['torch_pairs_ms']:.3f} ms)")
    for name in (FK, GROUPBY, OUTER):
        ms, oracle_ms, rows = t[name]
        log(f"[times] {name}: {ms:.3f} ms = {rows / ms * 1e3:.4g} rows/s "
            f"(its torch oracle: {oracle_ms:.3f} ms)")
    log(f"[times] digit_histograms 2^24 width 8: kernel {t['hist_ms']:.4f} ms, "
        f"plain {t['hist_plain_ms']:.4f} ms")
    for p in (1, 3):
        log(f"[times] partition_stage 2^24 width 8, {p} plane(s): kernel "
            f"{t[f'stage{p}_ms']:.4f} ms, plain {t[f'stage{p}_plain_ms']:.4f} ms")
    log(f"[times] segmented_scan 2^24 int32 sum, 1% heads: kernel "
        f"{t['scan_ms']:.4f} ms, plain {t['scan_plain_ms']:.4f} ms; no heads: "
        f"sum {t['scan_sum_noheads_ms']:.4f} ms (torch.cumsum "
        f"{t['cumsum_ms']:.4f} ms), max {t['scan_max_noheads_ms']:.4f} ms "
        f"(torch.cummax {t['cummax_ms']:.4f} ms)")
    log(f"[times] peak device memory {t['peak_gib']:.2f} GiB; card: {smi}")

    hist_bound = bound_ms(4 * N_KEYS + 4 * 256 * 4, 4 * N_KEYS)
    stage_bound = bound_ms(8 * N_KEYS + 4 * 256, N_KEYS)
    scan_bound = bound_ms(9 * N_KEYS, N_KEYS)
    record = {"kernels": [
        {"name": "digit_histograms", "route": "cuda",
         "source": "cuda/radixsort_tpu_torch/csrc/histogram.cu",
         "replaces": "cuda/radixsort_tpu/kernels/histogram.py:71",
         "launches": launches["digit_histograms"],
         "max_abs_err": errs["digit_histograms"],
         "ms": t["hist_ms"], "plain_ms": t["hist_plain_ms"],
         "bound_ms": hist_bound[0], "bound_by": hist_bound[1],
         "library_ms": None,
         "shape": "2^24 u32 keys, width 8, 4 stages"},
        {"name": "partition_stage", "route": "cuda",
         "source": "cuda/radixsort_tpu_torch/csrc/stage.cu",
         "replaces": "cuda/radixsort_tpu/kernels/stage.py:267",
         "launches": launches["partition_stage"],
         "max_abs_err": errs["partition_stage"],
         "ms": t["stage1_ms"], "plain_ms": t["stage1_plain_ms"],
         "bound_ms": stage_bound[0], "bound_by": stage_bound[1],
         "library_ms": None,
         "ms_3_planes": t["stage3_ms"], "plain_ms_3_planes": t["stage3_plain_ms"],
         "shape": "2^24 u32 keys, width 8, shift 0"},
        {"name": "segmented_scan", "route": "cuda",
         "source": "cuda/radixsort_tpu_torch/csrc/scan.cu",
         "replaces": "cuda/radixsort_tpu/kernels/scan.py:155",
         "launches": launches["segmented_scan"],
         "max_abs_err": errs["segmented_scan"]["exact"],
         "f32_sum_max_abs_err": errs["segmented_scan"]["f32_sum"],
         "f32_sum_tol": f"{SCAN_F32_TOL} of the segment's sum of |x|",
         "ms": t["scan_ms"], "plain_ms": t["scan_plain_ms"],
         "bound_ms": scan_bound[0], "bound_by": scan_bound[1],
         "library_ms": t["cumsum_ms"], "library_call": "torch.cumsum int32, no heads",
         "ms_max_no_heads": t["scan_max_noheads_ms"],
         "library_ms_cummax": t["cummax_ms"],
         "shape": "2^24 int32 values, sum, 1% heads"},
    ], "sort_keys_per_s": N_KEYS / t["sort_ms"] * 1e3,
        "sort_pairs_per_s": N_PAIRS / t["pairs_ms"] * 1e3,
        "rows_per_s": {name: t[name][2] / t[name][0] * 1e3
                       for name in (FK, GROUPBY, OUTER)},
        "mean_rel_err": op_errs["mean_rel_err"]}
    log(smi)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
