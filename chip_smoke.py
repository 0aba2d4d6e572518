#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's sort path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py              # from the root of the repository
    python3 chip_smoke.py --profile    # also: phase 6 below

Phases, each of which fails loudly (non-zero exit, no result line):
  1. device: a CUDA card must be present; its name and power limit are printed;
  2. build: both CUDA kernels are built from the repository's own sources;
  3. kernels: digit_histograms and partition_stage on the card against their
     plain PyTorch versions on the same inputs, bit for bit (tolerance 0);
  4. slice: sort (2^24 u32 keys) and stable sort_pairs (2^28 u64 keys + u32
     payload) and smaller cases against a torch.sort oracle on the card, bit
     for bit, with the kernels' launch counters read around the main path;
  5. times: CUDA-event medians of the slice, of each kernel beside its plain
     version, and of torch.sort as a baseline;
  6. (--profile only) a torch.profiler breakdown of both configs with the
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
SEED = 20261016
RUNS = 5


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
    from cuda.radixsort_tpu_torch.kernels import histogram as hist
    from cuda.radixsort_tpu_torch.kernels import stage

    keys1 = rand_bits(N_KEYS, torch.uint32, gen)
    keys2 = rand_bits(N_PAIRS, torch.uint64, gen)
    pay2 = rand_bits(N_PAIRS, torch.uint32, gen)
    torch.cuda.synchronize()

    hist.LAUNCHES = 0
    stage.LAUNCHES = 0
    out1 = rt.sort(keys1)
    out2k, out2v = rt.sort_pairs(keys2, pay2)
    torch.cuda.synchronize()
    launches = {"digit_histograms": hist.LAUNCHES,
                "partition_stage": stage.LAUNCHES}
    log(f"[slice] main path launches: {launches}")
    expect(all(v > 0 for v in launches.values()),
           f"a kernel of the path was never launched: {launches}")

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


def phase_times(gen: torch.Generator) -> dict:
    import cuda.radixsort_tpu_torch as rt
    from cuda.radixsort_tpu_torch.kernels import histogram as hist
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
    """--profile: where the device time of each config goes (torch.profiler,
    one call after a warm-up), the device's idle share against the call's
    CUDA-event time, and a sweep of the digit width and the tile geometry."""
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
    for name, fn in calls.items():
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
    del keys1, keys2, pay2
    torch.cuda.empty_cache()


def main() -> int:
    profile_run = "--profile" in sys.argv[1:]
    kind, smi = phase_device()
    load_port()
    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    errs = phase_kernels(gen)
    launches = phase_slice(gen)
    t = phase_times(gen)
    if profile_run:
        phase_profile(gen)

    log(f"[times] config 1 sort 2^24 u32: {t['sort_ms']:.3f} ms = "
        f"{N_KEYS / t['sort_ms'] * 1e3:.4g} keys/s "
        f"(torch.sort of the int32 view, stable: {t['torch_sort_ms']:.3f} ms)")
    log(f"[times] config 2 sort_pairs 2^28 u64+u32: {t['pairs_ms']:.3f} ms = "
        f"{N_PAIRS / t['pairs_ms'] * 1e3:.4g} pairs/s "
        f"(torch.sort int64 stable + gather: {t['torch_pairs_ms']:.3f} ms)")
    log(f"[times] digit_histograms 2^24 width 8: kernel {t['hist_ms']:.4f} ms, "
        f"plain {t['hist_plain_ms']:.4f} ms")
    for p in (1, 3):
        log(f"[times] partition_stage 2^24 width 8, {p} plane(s): kernel "
            f"{t[f'stage{p}_ms']:.4f} ms, plain {t[f'stage{p}_plain_ms']:.4f} ms")
    log(f"[times] peak device memory {t['peak_gib']:.2f} GiB; card: {smi}")

    record = {"kernels": [
        {"name": "digit_histograms", "route": "cuda",
         "source": "cuda/radixsort_tpu_torch/csrc/histogram.cu",
         "replaces": "cuda/radixsort_tpu/kernels/histogram.py:71",
         "launches": launches["digit_histograms"],
         "max_abs_err": errs["digit_histograms"],
         "ms": t["hist_ms"], "plain_ms": t["hist_plain_ms"],
         "shape": "2^24 u32 keys, width 8, 4 stages"},
        {"name": "partition_stage", "route": "cuda",
         "source": "cuda/radixsort_tpu_torch/csrc/stage.cu",
         "replaces": "cuda/radixsort_tpu/kernels/stage.py:267",
         "launches": launches["partition_stage"],
         "max_abs_err": errs["partition_stage"],
         "ms": t["stage1_ms"], "plain_ms": t["stage1_plain_ms"],
         "ms_3_planes": t["stage3_ms"], "plain_ms_3_planes": t["stage3_plain_ms"],
         "shape": "2^24 u32 keys, width 8, shift 0"},
    ], "sort_keys_per_s": N_KEYS / t["sort_ms"] * 1e3,
        "sort_pairs_per_s": N_PAIRS / t["pairs_ms"] * 1e3}
    log(smi)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
