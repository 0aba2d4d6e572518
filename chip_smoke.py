#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py              # from the root of the repository
    python3 chip_smoke.py --profile    # also: phase 7 below
    python3 chip_smoke.py --parent DIR # also: phase 9 below
    python3 chip_smoke.py --only-scan  # phases 1, 2 and the scan's part of 3

Phases, each of which fails loudly (non-zero exit, no result line):
  1. device: a CUDA card must be present; its name and power limit are printed;
  2. build: the five CUDA kernels are built from the repository's own sources;
     then `python -m cuda.radixsort_tpu_torch` (its self-test) must pass;
  2a. card_ops: ``tests/torch_surface.py::probe_card_ops`` tries 46 torch
     ops on uint16/32/64 tensors on the card; the ones it refuses must be
     the committed CARD_UNSIGNED_GAPS (the CPU tests hold the port to them);
  2b. surface: every case of ``tests/torch_surface.py`` (every public
     function and method of the swept modules: the sort family over 12 key
     and 10 payload dtypes, both orders, bit ranges, the radix, network and
     reference engines; the operators over u32, i32 and f32 columns; the
     query layer, the comparators, every CUB and thrust entry point and the
     flagships) at each of its sizes (1, 7, the stage tile +- 1, 2^16 + 3,
     2^19 + 5) on the card and, on the same inputs, through the port on the
     CPU: bit for bit but float sums and moments (within F32_TOL of the
     input's sum of |x|, of the largest x^2) and NaN in min, max and
     quantiles (by value); every result tensor on the card and each case's
     kernels launched (counters zeroed just before the card's call). Every
     case runs; the failures are listed together. The coverage rule: every
     public name is in a case or in EXCLUDED with a reason;
  3. kernels: digit_histograms and partition_stage on the card against their
     plain PyTorch versions on the same inputs, bit for bit (tolerance 0); the
     histogram also on random, constant, 90%-one-key and Zipf-like keys at
     widths 8/4/2, at sizes around a block's step and at element offsets
     1-3, and as limb_histograms of u64 keys' two limbs with
     aligned and unaligned bit ranges (2^24 and 2^28); segmented_scan against
     its plain version: integers and min/max bit for bit, a float32 sum within
     SCAN_F32_TOL of its segment's sum of |x|, at 2^24, around one tile, over
     many tiles, with values and flags at offsets 1-3, without flags (bit for
     bit the same as all-zero flags), and three runs of one 2^24 input give
     the same bits (float32 sums with and without heads, int32 sums); its
     int64 and uint64 instances bit for bit at 2^24 and 2^28 rows, with and
     without heads, at element phases 0 and 1, on values near +-2^63; its
     reverse direction (segmented_scan_reverse) on every dtype x op against
     its plain version and against flip -> forward kernel -> flip (bit for
     bit but float32 sums, within SCAN_F32_TOL of the rest of the segment's
     |x|, and bit for bit at reversed phase 0) at 2^24 + 1/2/3 and 2^28 + 3
     rows, around one tile and over many, at offsets 0-3, every row a head,
     only the first and no flags, then timed beside the forward pass at
     2^27 + 2^24 int64 rows; the
     network's tile kernel (sort and merge modes) and cross kernel, alone and
     as whole network sorts and merges, against the plain network bit for
     bit (1-4 planes, n_cmp 1, 2, 3, -1, -2 and all-compare, 2^10..2^28 rows,
     the main path's 2^28 shapes included, heavy ties on the tie-safe
     cases, tile geometries of each stride class: registers only, registers
     and shuffles, all three; the tile kernel's entry point refuses a phase
     list or block its geometry cannot run); the stage kernel also below
     one tile, at whole tiles, with 10 planes (a second launch), on a
     ragged last tile whose valid keys all have digit 0 (no lane past the
     end joins their peers), on a one-digit 2^28 key plane (one bucket
     whose lookback carries every tile) and three times on one 2^24 input
     (the same bits); each
     kernel's registers, spills and stack frame as ptxas reports them;
  3a. paired: partition_stage and limb_histograms on 8-byte columns (the
     sort API's 64-bit keys and 8-byte payloads) against their plain
     versions on the same columns, bit for bit: an 8-byte key's digit in
     either word, a u32 or a masked 8-byte key beside the column, 8-byte
     payloads, second launches, n = 1 to 2^24 - 777 and 2^28, the e0201
     cell's keys (the AND of 5 words) at 2^24, histograms of
     columns 0 or 8 bytes past a 16-byte boundary over aligned, unaligned
     and empty 64-bit ranges; then config 2's pass and histograms on the
     column timed beside the same work on contiguous u32 planes;
  4. slice: sort (2^24 u32 keys) and stable sort_pairs (2^28 u64 keys + u32
     payload) and smaller cases against a torch.sort oracle on the card, bit
     for bit, with the kernels' launch counters read around each path; and
     the largest device sort, 2^31 u32 keys whose top byte is one value (that
     digit counts 2^31: its pass must be skipped), checked without torch.sort
     (ordered, equal byte histograms, u64 sums and xors);
  5. operators: the FK inner join (probe 2^27 x build 2^24), the group-by sum
     and count over Zipf-like keys (2^26 rows) and a full outer join feeding
     a grouped mean (probe 2^22 x build 2^20), each through its recipe in
     models/flagships.py, against oracles built from torch.sort,
     torch.searchsorted, torch.unique and index_add_: bit for bit, the mean
     within MEAN_TOL; launch counters read around each path;
  5b. plan: the query layer through the entry points a user calls, each
     path counted and against an oracle of plain torch calls: P1
     filter_sort_join_query (probe 2^27 x build 2^24), P2 table_query
     (2^26 x 2^22), P3 window_pipeline (2^26 rows, 1024 partitions), P4
     three Query plans over 2^26 orders and 2^22 parts (the README's where
     -> join -> groupby -> order_by -> limit; where -> join -> window ->
     groupby_agg with sum, mean, median and maxima; where -> distinct), and
     P5 the operators at 2^26 keys (partition by range and by hash,
     distinct and unique, top_k 1000 with threshold ties, digit_histogram
     at widths 8 and 4, histogram_even); integers and medians bit for bit,
     means within MEAN_TOL; the stage kernel on every path that sorts, the
     scan kernel on P1-P4 and top_k, the histogram kernel on every path;
  6. network: the same entry points with SortConfig(engine="bitonic"): (a)
     sort 2^24 u32, (b) stable sort_pairs 2^28 u64+u32, (c) the same with
     stable=False (keys bit for bit, (key, payload) multiset equal; a 2^24
     heavy-tie case bit for bit against the plain network), (d) the FK join
     (must take the split-sort-merge route with the tag comparand), (e)
     merge_sorted_pairs of two 2^27-row runs
     (against the rank-scatter route and a stable torch.sort), (f)
     segmented_sort of 2^24 keys in 4096 ragged segments; tile and cross
     launches must be > 0 on each, partition_stage 0 on the pure-sort paths;
  6a. sort_large and measurement: sort_large L1-L5 through the public
     entry point (2^28 and 2^27 random u32 at the default msd_bits 8 and 4,
     2^27 u32 with 90% of the keys in one top byte, whose batches must hold
     one bucket each, 2^24 f32 descending with msd_bits=4, 2^24 u32 with
     0xFFFFFFFF keys), each counted (phase A: one histogram launch and one
     stage pass) and bit for bit against the torch.sort oracle and rt.sort,
     then timed beside both; sort and sort_pairs with engine="reference" at
     2^20 (plain torch: no kernel may launch) bit for bit against rt.sort
     and rt.sort_pairs, timed once; a utils/profiling.py trace of config 2
     must hold the sort_pairs range; after phase 8, bitonic_passes(24, 1)
     must equal path (a)'s tile and cross launches, and speed_of_light of
     the 2^24 stage pass the share bound_ms gives (one memory rate, the
     package's HBM_BYTES_PER_S);
  6b. compat: the CUB- and thrust-shaped surfaces (cub_compat.py,
     thrust_compat.py), C1-C14, each counted, bit for bit against a
     plain-torch oracle on the card, then timed: DeviceRadixSort.SortPairs
     on config 2's input (the same bits as rt.sort_pairs, both timed),
     SortKeysDescending over bits [4, 20) at 2^24, DeviceSegmentedRadixSort
     .SortPairs (2^24 keys, 4096 segments as begin and end offsets),
     DeviceMergeSort.StableSortPairs with a struct comparator at 2^24 (the
     comparator network, plain torch), thrust.stable_sort_by_key with an
     (N, 3) float32 value at 2^26, DevicePartition.ThreeWay,
     DeviceSelect.UniqueByKey, DeviceRunLengthEncode.Encode,
     DeviceReduce.ReduceByKey, DeviceScan.ExclusiveScan with torch.maximum,
     DeviceSegmentedReduce.Sum (2^16 segments), DeviceHistogram
     .MultiHistogramEven (4 channels) and DeviceTopK.MaxPairs (k = 1024) at
     2^26, and thrust.lower_bound of 2^24 queries into 2^26 sorted keys;
  6c. external: the out-of-core sorts (ops/external.py, the host merge in
     csrc/hostutils.cpp built with g++): sort_external of 2^30 u32 keys
     (BASELINE.json's "1B uint32") in 2^27-row chunks against torch.sort on
     the card, sort_external_pairs of 2^28 pairs with the row index as
     payload (stable), the two disk-spill forms at 2^28 under build/ (files
     removed), join_external at BASELINE's 2^30 probe x 10^8 build (count
     and checksum against a searchsorted oracle) and materialized at 2^26 x
     2^22 (row for row); each with its seconds split into copies, card and
     host merge, the host's RAM and the peak RSS (2^29 and a `reduced` line
     where the host has too little RAM for 2^30);
  6d. distributed: the parallel/ layer through its public entry points on a
     one-rank NCCL mesh (one card holds one NCCL rank), each counted, bit
     for bit against a plain-torch oracle (quantiles within MEAN_TOL) and
     timed beside its single-GPU call: D1 sort_distributed 2^28 u32 (two
     exchange rounds), D2 stable sort_pairs_distributed 2^27, D3
     groupby_distributed sum and count over 2^26 Zipf-like keys, D4
     join_distributed 2^27 x 2^24 by the hash and the broadcast routes, D5
     scan_by_key_distributed 2^26, D6 kth_value, top_k 1000, distinct and
     groupby_quantile at 2^26, D7 filter_sort_join_distributed 2^27 x 2^24
     and Query.run(mesh=) of P4's README plan; then D1, D3, D4 and D7's plan
     at 2^24 rows on 4 ranks over gloo with CUDA tensors of the same card
     (tests/torch_world.py, a hard time limit; D4 and the plan's join take
     the hash route, which moves rows between the ranks), each rank
     against the oracle;
  7. (--profile only) a torch.profiler breakdown of every path (the network
     and D paths included) with the device's idle share, and a sweep of
     radix_bits, block_threads and items_per_thread on configs 1 and 2;
  8. times: CUDA-event medians of every path (P1-P4 included) and of its
     torch oracle (the
     network paths also beside the radix engine), of (d)'s sort on the
     split-sort-merge route beside the padded network, and of each kernel
     beside its plain version and its one-call torch yardstick: a kernel's
     time is the card's alone (utils/profiling.py device_time_ms: batches
     queued behind a spin kernel), beside one call as a caller waits for it
     (the stage pass also at config 2's 2^28 x 3 planes, the histogram at
     2^28 with one and two limbs and on skewed keys, the scan at the
     FK join's 2^27 + 2^24 rows, the tile kernel's sort and merge passes at
     path (b)'s 2^28 x 4 planes, the 2^24 network also on tiles twice the
     preset's, one block an SM; the 1-plane tile pass beside its library
     call, torch.sort(view(-1, 2^log_t), dim=-1));
  9. (--parent DIR only) the port of another commit, unpacked under DIR
     (`git archive`), built and imported beside this one: its histogram and
     scan kernels and the five radix paths against this checkout's on the
     same inputs (they must agree), timed in turns parent, this, this,
     parent (the paths in AB_ROUNDS such rounds).

The last line is {"ok": true, "device": {...}}; the line before it holds the
kernels' JSON record. The JAX package is never imported.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
import shutil
import statistics
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
AB_ROUNDS = 4  # rounds of parent, this, this, parent for a path's A/B
SCAN_F32_TOL = 1e-5  # of the segment's running sum of |x|
MEAN_TOL = 1e-6      # relative, of a grouped mean (a mean of 0 exactly)
FK = "FK inner join 2^27 x 2^24"
GROUPBY = "group-by sum and count 2^26"
OUTER = "full outer join -> mean 2^22 x 2^20"
N_SEGMENTS = 4096
NET_A = "(a) network sort 2^24 u32"
NET_B = "(b) network stable sort_pairs 2^28 u64+u32"
NET_C = "(c) network sort_pairs stable=False 2^28 u64+u32"
NET_D = "(d) network FK inner join 2^27 x 2^24"
NET_E = "(e) network merge_sorted_pairs 2^27 + 2^27 u32+u32"
NET_F = "(f) network segmented_sort 2^24 u32, 4096 segments"
NET_PATHS = (NET_A, NET_B, NET_C, NET_D, NET_E, NET_F)
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, NVIDIA's H100 SXM
#                        data sheet; the memory rate is the package's table
#                        (utils/profiling.py::HBM_BYTES_PER_S)


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


KERNELS = ("digit_histograms", "partition_stage", "segmented_scan",
           "bitonic_tile", "bitonic_cross")
SORT_KERNELS = KERNELS[:2]
NETWORK = KERNELS[3:]
RADIX_OPERATOR = KERNELS[:3]
PEAK_BYTES = [0]  # the largest device-memory peak seen by run_counted
PATH_LAUNCHES: dict = {}  # path -> its launch counts, from run_counted


def kernel_modules() -> dict:
    """kernel -> (module, name of its launch counter)."""
    from cuda.radixsort_tpu_torch.kernels import bitonic, histogram, scan, stage

    return {"digit_histograms": (histogram, "LAUNCHES"),
            "partition_stage": (stage, "LAUNCHES"),
            "segmented_scan": (scan, "LAUNCHES"),
            "bitonic_tile": (bitonic, "TILE_LAUNCHES"),
            "bitonic_cross": (bitonic, "CROSS_LAUNCHES")}


def run_counted(path: str, fn, needs, launches: dict, forbid=()):
    """Run one main path with every launch counter set to 0 just before it
    and read just after it; fail if a kernel in ``needs`` never launched or
    one in ``forbid`` did. Adds the counts to ``launches`` (kernel -> sum
    over the paths) and logs the path's peak device memory."""
    mods = kernel_modules()
    torch.cuda.synchronize()
    PEAK_BYTES[0] = max(PEAK_BYTES[0], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    for m, attr in mods.values():
        setattr(m, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    counts = {k: getattr(m, attr) for k, (m, attr) in mods.items()}
    peak = torch.cuda.max_memory_allocated()
    PEAK_BYTES[0] = max(PEAK_BYTES[0], peak)
    PATH_LAUNCHES[path] = counts
    log(f"[launches] {path}: {counts}; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    expect(all(counts[k] > 0 for k in needs),
           f"{path}: a kernel of the path was never launched: {counts}")
    expect(all(counts[k] == 0 for k in forbid),
           f"{path}: launched {[k for k in forbid if counts[k]]}, which the "
           f"path must not reach: {counts}")
    for k, c in counts.items():
        launches[k] = launches.get(k, 0) + c
    return out


def u32_to_i64(t: torch.Tensor) -> torch.Tensor:
    """u32 values as int64 (torch orders and indexes these on the card)."""
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def wrap_i32(s: torch.Tensor) -> torch.Tensor:
    """int64 sums -> the int32 sums that wrap, as JAX's and the port's do."""
    return (((s + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def hbm_bytes_per_s() -> float:
    """The card's memory rate from the package's table, which has no
    default: a card it does not list stops the script."""
    from cuda.radixsort_tpu_torch.utils.profiling import HBM_BYTES_PER_S

    name = torch.cuda.get_device_name(0)
    expect(name in HBM_BYTES_PER_S, f"no memory rate for {name!r} in "
           "utils/profiling.py::HBM_BYTES_PER_S")
    return HBM_BYTES_PER_S[name]


def bound_ms(n_bytes: float, n_ops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / hbm_bytes_per_s(), n_ops / F32_OPS_PER_S
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


def ptxas_kernels(report: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes, stack frame
    bytes) for each entry function of one source's ``ptxas -v`` report."""
    rows, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            rows.append([name, None, None, None, None])
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and rows and rows[-1][0] == name:
            rows[-1][2:] = [int(m.group(2)), int(m.group(3)), int(m.group(1))]
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1][0] == name:
            rows[-1][1] = int(m.group(1))
    return [tuple(r) for r in rows]


def phase_build() -> float:
    from cuda.radixsort_tpu_torch.utils import build

    t0 = time.perf_counter()
    build.library()
    secs = time.perf_counter() - t0
    log(f"[build] {len(build.sources())} sources -> {build.BUILD_DIR} in "
        f"{secs:.1f} s")
    if not build.PTXAS_REPORT:
        log("[build] library loaded from an earlier build: no ptxas report")
    for src, report in sorted(build.PTXAS_REPORT.items()):
        rows = ptxas_kernels(report)
        expect(rows and all(None not in r for r in rows),
               f"ptxas report of {src}: no registers or spills read")
        log(f"[build] ptxas {src}: {len(rows)} kernels, at most "
            f"{max(r[1] for r in rows)} registers, spill stores "
            f"{sum(r[2] for r in rows)} / loads {sum(r[3] for r in rows)} "
            f"bytes in all")
        if src in ("bitonic.cu", "stage.cu"):
            for name, regs, st, ld, frame in rows:
                log(f"[build]   {name}: {regs} registers, spill stores {st} "
                    f"/ loads {ld} bytes, stack frame {frame} bytes")
    return secs


def phase_self_test() -> None:
    """``python -m cuda.radixsort_tpu_torch`` on the card, in a process of
    its own with the checkout first on its path (so the checkout's `cuda`
    package, not cuda-python's, is the one a startup hook imports): its
    sort and query checks must pass."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "cuda.radixsort_tpu_torch"],
                          cwd=HERE, env=env, capture_output=True, text=True,
                          timeout=600)
    expect(proc.returncode == 0, f"python -m cuda.radixsort_tpu_torch: rc "
           f"{proc.returncode}: {proc.stderr[-2000:]}")
    status = json.loads(proc.stdout.strip().splitlines()[-1])
    expect(status["sort_1M_ok"] and status["query_plan_ok"],
           f"python -m cuda.radixsort_tpu_torch: {status}")
    log(f"[self-test] python -m cuda.radixsort_tpu_torch: {status}")


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


def _stage_case(planes, width: int, shift: int, what: str) -> int:
    """partition_stage on the card against its plain version, bit for bit;
    gbase from the key plane's own histogram. Returns the max error."""
    from cuda.radixsort_tpu_torch.kernels import histogram as hist
    from cuda.radixsort_tpu_torch.kernels import stage

    h = hist.digit_histograms_plain(planes[0], n_stages=32 // width,
                                    width=width)
    gbase = hist.stage_bases(h)[shift // width].contiguous()
    got = stage.partition_stage(planes, gbase, shift=shift, width=width)
    torch.cuda.synchronize()
    want = stage.partition_stage_plain(planes, gbase, shift=shift, width=width)
    e = max(max_abs_err(g, w) for g, w in zip(got, want))
    expect(e == 0, f"partition_stage {what} width={width} shift={shift}: "
           f"max err {e}")
    return e


def phase_kernels(gen: torch.Generator) -> dict:
    from cuda.radixsort_tpu_torch import config as config_lib
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

    # the onesweep kernel's edges: less than one tile, whole tiles, the
    # second launch (planes 9-10), and lookback determinism
    tile = config_lib.preset().tile_elems
    edges = [(1, 1), (31, 3), (tile - 1, 2), (tile, 1), (tile * 1000, 3),
             (tile - 1, 10), (tile * 37 + 5, 10)]
    for n, n_planes in edges:
        planes = [rand_bits(n, torch.uint32, gen) for _ in range(n_planes)]
        for width, shift in ((8, 0), (4, 28), (2, 14)):
            errs["partition_stage"] = max(errs["partition_stage"], _stage_case(
                planes, width, shift, f"n={n} planes={n_planes}"))
    # a ragged last tile whose valid keys all have digit 0: the lanes past
    # the end hold no key and must not join digit 0's peers
    n = tile * 37 + 5
    for width, shift in ((8, 0), (4, 28), (2, 14)):
        clear = ~(((1 << width) - 1) << shift) & 0xFFFFFFFF
        keys = (rand_bits(n, torch.uint32, gen).view(torch.int32)
                & (clear - (1 << 32) if clear >> 31 else clear))
        keys = keys.view(torch.uint32)
        errs["partition_stage"] = max(errs["partition_stage"], _stage_case(
            [keys, rand_bits(n, torch.uint32, gen)], width, shift,
            f"n={n} every key in digit 0"))
    keys = rand_bits(N_KEYS, torch.uint32, gen)
    planes = [keys, rand_bits(N_KEYS, torch.uint32, gen)]
    gbase = hist.stage_bases(hist.digit_histograms_plain(
        keys, n_stages=4, width=8))[0].contiguous()
    runs = [stage.partition_stage(planes, gbase, shift=0, width=8)
            for _ in range(3)]
    torch.cuda.synchronize()
    want = stage.partition_stage_plain(planes, gbase, shift=0, width=8)
    for r, got in enumerate(runs):
        e = max(max_abs_err(g, w) for g, w in zip(got, want))
        expect(e == 0, f"partition_stage 2^24 run {r}: max err {e}")
    log(f"[kernels] partition_stage == plain on {3 * len(edges) + 3} edge "
        f"cases (n = 1, 31, tile-1, tile, 1000 tiles, tile-1 and 37 tiles "
        f"+ 5 with 10 planes, 37 tiles + 5 with every key in digit 0; tile "
        f"{tile}; widths 8/4/2) and 3 runs of one 2^24 pass, the same bits "
        f"each time")
    del keys, planes, runs, want, got

    # Config 2's shapes: both kernels at 2^28 keys, width 8, on the low key
    # limb with the high limb and the u32 payload riding along (3 planes);
    # first a key plane of one digit, a single bucket whose lookback
    # carries every tile.
    planes = [make_keys("constant", N_PAIRS, gen)]
    planes += [rand_bits(N_PAIRS, torch.uint32, gen) for _ in range(2)]
    errs["partition_stage"] = max(errs["partition_stage"], _stage_case(
        planes, 8, 0, "2^28 one digit, 3 planes"))
    planes[0] = rand_bits(N_PAIRS, torch.uint32, gen)
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


HIST_KEY_CASES = ("random", "constant", "skew90", "zipf")
# u64 keys split into (hi, lo) limbs: the limb bit ranges of sort_pairs at
# begin_bit/end_bit (0, 64), (5, 59), (28, 36) and (8, 56): unaligned ranges
# are masked in the kernel
LIMB_RANGES = ([(0, 32), (0, 32)], [(0, 27), (5, 32)], [(0, 4), (28, 32)],
               [(0, 24), (8, 32)])


def hist_keys(case: str, n: int, gen: torch.Generator) -> torch.Tensor:
    """make_keys, plus "zipf": the group-by's Zipf-like keys."""
    if case == "zipf":
        from cuda.radixsort_tpu_torch.models import flagships

        return flagships.groupby_zipf(n, generator=gen, device="cuda")[1][0]
    return make_keys(case, n, gen)


def u64_limbs(n: int, gen: torch.Generator, offset: int = 0):
    """(hi, lo) u32 limbs of n random u64 keys, as views at an element
    offset (unaligned data pointers for offsets 1-3)."""
    words = rand_bits(2 * (n + offset), torch.uint32, gen).view(torch.int32)
    return [words[(n + offset) * q:(n + offset) * (q + 1)][offset:]
            .view(torch.uint32) for q in (0, 1)]


def phase_hist_kernel(gen: torch.Generator) -> int:
    """digit_histograms and limb_histograms on the card against their plain
    versions, bit for bit: widths 8/4/2 on four key distributions, sizes
    around a block's step, views at offsets 1-3, and u64 limbs with aligned
    and unaligned bit ranges at 2^24 and 2^28."""
    from cuda.radixsort_tpu_torch.kernels import histogram as hist

    err, n_cases = 0, 0

    def check(got, want, what):
        nonlocal err, n_cases
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        expect(e == 0, f"{what}: max err {e}")
        err, n_cases = max(err, e), n_cases + 1

    for case in HIST_KEY_CASES:
        keys = hist_keys(case, N_KEYS, gen)
        for width in (8, 4, 2):
            check(hist.digit_histograms(keys, n_stages=32 // width,
                                        width=width),
                  hist.digit_histograms_plain(keys, n_stages=32 // width,
                                              width=width),
                  f"digit_histograms {case} 2^24 width {width}")
    step = 16 * hist.THREADS  # keys a block counts per step
    sizes = [1, 3, 4, 15, 17, step - 1, step, step + 1]
    for n in sizes:
        for offset in range(4):
            keys = rand_bits(n + offset, torch.uint32, gen)[offset:]
            for width in (8, 4, 2):
                check(hist.digit_histograms(keys, n_stages=32 // width,
                                            width=width),
                      hist.digit_histograms_plain(keys, n_stages=32 // width,
                                                  width=width),
                      f"digit_histograms n={n} offset={offset} width={width}")
    for n in (N_KEYS, N_PAIRS):
        for i, ranges in enumerate(LIMB_RANGES):
            if n == N_PAIRS and i > 1:
                continue
            limbs = u64_limbs(n, gen, offset=i % 4)
            check(hist.limb_histograms(limbs, ranges, 8),
                  hist.limb_histograms_plain(limbs, ranges, 8),
                  f"limb_histograms u64 n={n} ranges {ranges} offset {i % 4}")
            del limbs
        torch.cuda.empty_cache()
    log(f"[kernels] digit_histograms / limb_histograms == plain on {n_cases} "
        f"cases (widths 8/4/2 x keys {list(HIST_KEY_CASES)} at 2^24; n = "
        f"{sizes} at offsets 0-3; u64 "
        f"limbs {LIMB_RANGES} at 2^24, the first two at 2^28)")
    return err


def u64_column(n: int, gen: torch.Generator, offset: int = 0):
    """n random u64 values as a column that starts ``offset`` words into
    its buffer (an odd offset puts it 8 bytes past a 16-byte boundary)."""
    return rand_bits(n + offset, torch.uint64, gen)[offset:]


def phase_paired(gen: torch.Generator) -> dict:
    """The kernels on 8-byte columns (the sort API's 64-bit keys and 8-byte
    payloads): partition_stage and limb_histograms on the card against
    their plain versions on the same columns, bit for bit, at ragged sizes
    and at config 2's 2^28 u64 + u32; then each paired launch timed beside
    the same work on contiguous u32 planes (config 2's pass and histograms
    before 8-byte columns)."""
    from cuda.radixsort_tpu_torch import config as config_lib
    from cuda.radixsort_tpu_torch.kernels import histogram as hist
    from cuda.radixsort_tpu_torch.kernels import stage
    from cuda.radixsort_tpu_torch.utils.profiling import device_time_ms

    tile = config_lib.preset().tile_elems
    n_stage, n_hist = 0, 0

    def gbase_of(key, shift, width):
        counts = torch.bincount(hist.digits(key, shift, width),
                                minlength=1 << width)
        return (torch.cumsum(counts, 0) - counts).to(torch.int32)

    def stage_case(cols, width, shift, what):
        nonlocal n_stage
        gbase = gbase_of(cols[0], shift, width)
        got = stage.partition_stage(cols, gbase, shift=shift, width=width)
        torch.cuda.synchronize()
        want = stage.partition_stage_plain(cols, gbase, shift=shift,
                                           width=width)
        for q, (g, w) in enumerate(zip(got, want)):
            expect(g.dtype == cols[q].dtype and g.is_contiguous(),
                   f"partition_stage {what}: column {q} changed its layout")
            e = max_abs_err(g.view(torch.int32), w.view(torch.int32))
            expect(e == 0, f"partition_stage {what} width={width} "
                   f"shift={shift} column {q}: max err {e}")
        n_stage += 1

    low = ((8, 0), (4, 28), (2, 14))  # digits in the low word
    high = ((8, 32), (4, 60), (2, 46))  # and in the high word
    for n in (1, 31, tile - 1, tile, tile + 1, tile * 37 + 5, N_KEYS - 777):
        col = u64_column(n, gen, offset=n % 2)
        pay = rand_bits(n, torch.uint32, gen)
        masked = rand_bits(n, torch.uint32, gen)
        masked64 = u64_column(n, gen).view(torch.int64) & 0x0FFFFFFFFFFFFFF0
        cases = [([col, pay], low + high, "u64 key + u32"),
                 ([masked, col, pay], low, "u32 key + u64 + u32"),
                 ([masked64, col, pay], low + high,
                  "masked u64 key + u64 + u32"),
                 ([col, u64_column(n, gen)], low + high,
                  "u64 key + 8-byte payload"),
                 ([col] + [rand_bits(n, torch.uint32, gen)
                           for _ in range(8)], ((8, 0), (8, 32)),
                  "u64 key + 8 u32 (a second launch)"),
                 ([col] + [u64_column(n, gen) for _ in range(8)],
                  ((8, 0), (8, 32)), "9 8-byte columns (a second launch)")]
        for cols, shifts, what in cases:
            for width, shift in shifts:
                stage_case(cols, width, shift, f"n={n} {what}")
    # the e0201 cell's keys (the AND of 5 words: 78% of keys in digit 0 of
    # every pass) through the paired instance
    col = u64_column(N_KEYS, gen).view(torch.int64)
    for _ in range(4):
        col = col & u64_column(N_KEYS, gen).view(torch.int64)
    pay = rand_bits(N_KEYS, torch.uint32, gen)
    for shift in (0, 24, 32, 56):
        stage_case([col.view(torch.uint64), pay], 8, shift,
                   "2^24 u64 + u32, keys the AND of 5 words")
    col = u64_column(N_PAIRS, gen)
    pay = rand_bits(N_PAIRS, torch.uint32, gen)
    for shift in (0, 56):
        stage_case([col, pay], 8, shift, "2^28 u64 + u32")
    log(f"[paired] partition_stage on 8-byte columns == plain on {n_stage} "
        f"cases (n = 1 .. 2^24 - 777 and 2^28; an 8-byte key's digit in "
        f"either word, a u32 or masked u64 key beside the column, 8-byte "
        f"payloads, second launches; widths 8/4/2; e0201's keys at 2^24)")

    step = 8 * hist.THREADS  # rows a block counts per step
    ranges_all = [(0, 64), (5, 59), (0, 28), (36, 64), (20, 50), (0, 16),
                  (32, 64), (40, 40), (0, 32)]
    for n in (1, 2, 3, 15, 17, step - 1, step, step + 1, N_KEYS, N_PAIRS):
        for offset in ((0,) if n == N_PAIRS else (0, 1)):
            col = u64_column(n, gen, offset)
            for bits in (ranges_all[:2] if n == N_PAIRS else ranges_all):
                for width in ((8,) if n >= N_KEYS else (8, 4, 2)):
                    got = hist.limb_histograms([col], [bits], width)
                    torch.cuda.synchronize()
                    want = hist.limb_histograms_plain([col], [bits], width)
                    e = max_abs_err(got, want)
                    expect(e == 0, f"limb_histograms u64 column n={n} "
                           f"offset={offset} bits {bits} width {width}: max "
                           f"err {e}")
                    n_hist += 1
    log(f"[paired] limb_histograms of a u64 column == plain on {n_hist} "
        f"cases (n = 1 .. 2^28, columns 0 or 8 bytes past a 16-byte "
        f"boundary, bits {ranges_all}, widths 8/4/2)")
    del col, pay, cols
    torch.cuda.empty_cache()

    # config 2's pass and histograms, 8-byte column against three / two
    # contiguous u32 planes
    t = {}
    col = rand_bits(N_PAIRS, torch.uint64, gen)
    words = col.view(torch.int32).reshape(-1, 2)
    pay = rand_bits(N_PAIRS, torch.uint32, gen)
    flat = [words[:, 0].contiguous().view(torch.uint32),
            words[:, 1].contiguous().view(torch.uint32), pay]
    del words
    gbase = hist.stage_bases(hist.digit_histograms(
        flat[0], n_stages=4, width=8))[0].contiguous()
    out = [torch.empty_like(col), torch.empty_like(pay)]
    t["paired"] = device_time_ms(lambda: stage.partition_stage(
        [col, pay], gbase, shift=0, width=8, out=out), runs=RUNS)
    flat_out = [torch.empty_like(p) for p in flat]
    t["planes"] = device_time_ms(lambda: stage.partition_stage(
        flat, gbase, shift=0, width=8, out=flat_out), runs=RUNS)
    t["hist_paired"] = device_time_ms(lambda: hist.limb_histograms(
        [col], [(0, 64)], 8), runs=RUNS)
    t["hist_planes"] = device_time_ms(lambda: hist.limb_histograms(
        flat[1::-1], [(0, 32), (0, 32)], 8), runs=RUNS)
    bound = bound_ms(8 * N_PAIRS * 3)[0]
    hbound = bound_ms(8 * N_PAIRS)[0]
    log(f"[paired] partition_stage 2^28 width 8, u64 key column + u32: "
        f"{t['paired']:.4f} ms; as 3 u32 planes {t['planes']:.4f} ms "
        f"(bound {bound:.3f} ms)")
    log(f"[paired] limb_histograms 2^28 width 8, a u64 column: "
        f"{t['hist_paired']:.4f} ms; as 2 u32 limbs {t['hist_planes']:.4f} "
        f"ms (bound {hbound:.3f} ms)")
    del col, pay, flat, out, flat_out
    torch.cuda.empty_cache()
    return t


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


N_2_31 = 1 << 31  # the largest device sort: one digit counts 2^31 keys
TIMES_2_31 = {}


def u32_chunks(t: torch.Tensor, step: int = 1 << 28):
    for i in range(0, t.numel(), step):
        yield t[i:i + step]


def byte_histograms(t: torch.Tensor) -> torch.Tensor:
    """(4, 256) int64 counts of each byte of u32 keys, by torch.bincount
    over 2^28-row chunks (independent of the port's kernels)."""
    out = torch.zeros((4, 256), dtype=torch.int64, device=t.device)
    for c in u32_chunks(t):
        w = c.view(torch.int32)
        for b in range(4):
            out[b] += torch.bincount(((w >> (8 * b)) & 255).to(torch.int64),
                                     minlength=256)
    return out


def sum_and_xor(t: torch.Tensor) -> tuple[int, int]:
    """The u64 sum and the xor of u32 keys (a pairwise xor tree)."""
    total = sum(int(u32_to_i64(c).sum()) for c in u32_chunks(t))
    x = t.view(torch.int32)
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, torch.zeros(1, dtype=torch.int32,
                                          device=x.device)])
        x = x[0::2] ^ x[1::2]
    return total, int(x[0]) & 0xFFFFFFFF


def check_sort_2_31(gen: torch.Generator) -> dict:
    """2^31 u32 keys whose top byte is one value (the rest random): the top
    digit counts 2^31, a count and a base that wrap an int32. The histogram
    must read 2^31 there and the sort must skip that pass as trivial;
    checked without torch.sort: adjacent keys do not decrease, and input
    and output have equal byte histograms, u64 sums and xors."""
    import cuda.radixsort_tpu_torch as rt
    from cuda.radixsort_tpu_torch.kernels import histogram as khist
    from cuda.radixsort_tpu_torch.utils.profiling import cuda_time_ms

    keys = torch.empty(N_2_31, dtype=torch.int32, device="cuda")
    for c in u32_chunks(keys):
        c.copy_(torch.randint(0, 1 << 24, (c.numel(),), dtype=torch.int64,
                              device="cuda", generator=gen) | (0x5A << 24))
    keys = keys.view(torch.uint32)
    hist = khist.counts64(khist.limb_histograms([keys], [(0, 32)], 8))
    expect(int(hist[3].max()) == N_2_31 and int(hist[3][0x5A]) == N_2_31,
           f"2^31: the top digit counts {int(hist[3].max())}, not 2^31")
    launches: dict = {}
    out = run_counted("sort 2^31 u32, top byte one value",
                      lambda: rt.sort(keys), SORT_KERNELS, launches)
    expect(launches["partition_stage"] == 3,
           f"2^31: {launches['partition_stage']} stage passes, not 3 (the "
           "top digit's pass is trivial)")
    expect(out.numel() == N_2_31 and out.dtype == torch.uint32,
           "2^31: output shape or dtype")
    ok = True
    for i in range(0, N_2_31, 1 << 28):
        w = u32_to_i64(out[i:i + (1 << 28) + 1])
        ok = ok and bool((w[1:] >= w[:-1]).all())
    expect(ok, "2^31: adjacent output keys decrease")
    expect(torch.equal(byte_histograms(keys), byte_histograms(out)),
           "2^31: input and output byte histograms differ")
    expect(sum_and_xor(keys) == sum_and_xor(out),
           "2^31: input and output u64 sums or xors differ")
    del out
    torch.cuda.empty_cache()
    TIMES_2_31["sort_ms"] = cuda_time_ms(lambda: rt.sort(keys), runs=3,
                                         warmup=1)
    log(f"[slice] sort 2^31 u32 (top byte one value): ordered, byte "
        f"histograms, u64 sum and xor == the input's; the top digit counts "
        f"2^31 and its pass is skipped (3 stage passes); "
        f"{TIMES_2_31['sort_ms']:.3f} ms")
    del keys
    torch.cuda.empty_cache()
    return launches


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
    launches_2_31 = check_sort_2_31(gen)
    for k, c in launches_2_31.items():
        launches[k] = launches.get(k, 0) + c

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


def load_surface():
    """tests/torch_surface.py, loaded by path (the port must be loaded
    first: the table imports it)."""
    path = os.path.join(HERE, "tests", "torch_surface.py")
    spec = importlib.util.spec_from_file_location("torch_surface", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def phase_card_ops() -> dict:
    """The card's torch on uint16/32/64 tensors: the operators it refuses
    must be the committed CARD_UNSIGNED_GAPS, which the CPU tests hold the
    port to (tests/test_torch_card_ops.py)."""
    surf = load_surface()
    got = surf.probe_card_ops("cuda")
    log(f"[card_ops] {len(surf.PROBE_OPS)} torch ops on uint16/32/64 CUDA "
        f"tensors (torch {torch.__version__}): {len(got)} refused: "
        f"{', '.join(got)}")
    expect(got == surf.CARD_UNSIGNED_GAPS,
           "the card's torch refuses other unsigned ops than "
           "tests/torch_surface.py::CARD_UNSIGNED_GAPS: card "
           f"{json.dumps(got)}, table {json.dumps(surf.CARD_UNSIGNED_GAPS)}")
    return got


def phase_surface() -> dict:
    """Every case of tests/torch_surface.py at each of its sizes on the
    card and, on the same inputs, through the port on the CPU (the kernels'
    plain versions): the results must agree under the case's rule (bit for
    bit but float reductions), every result tensor must be on the card, and
    the case's kernels must have launched (counters zeroed just before the
    card's call, read just after). Every case runs; the failures are listed
    together. The coverage rule first: every public name of the swept
    modules is in a case or in EXCLUDED."""
    surf = load_surface()
    t0 = time.perf_counter()
    missing, stale, stale_excluded = surf.uncovered()
    expect(not (missing or stale or stale_excluded),
           f"surface coverage: public names in no case {missing}; covers "
           f"that name nothing {stale}; EXCLUDED names nothing "
           f"{stale_excluded}")
    mods = kernel_modules()
    cases = surf.all_cases()
    failures, runs, card_s, cpu_s = [], 0, 0.0, 0.0
    launches = {k: 0 for k in KERNELS}
    slowest = []
    for case in cases:
        for n in case.sizes:
            runs += 1
            inputs = surf.case_inputs(case, n)
            try:
                t = time.perf_counter()
                want = surf.run_case(case, n, "cpu", inputs)
                t_cpu = time.perf_counter() - t
                torch.cuda.synchronize()
                for m, attr in mods.values():
                    setattr(m, attr, 0)
                t = time.perf_counter()
                got = surf.run_case(case, n, "cuda", inputs)
                torch.cuda.synchronize()
                t_card = time.perf_counter() - t
                counts = {k: getattr(m, attr) for k, (m, attr) in mods.items()}
            except Exception as err:  # listed below; the phase then fails
                failures.append(f"{case.id} n={n}: {type(err).__name__}: "
                                f"{str(err)[:400]}")
                continue
            cpu_s, card_s = cpu_s + t_cpu, card_s + t_card
            slowest.append((t_cpu + t_card, f"{case.id} n={n}"))
            for k, c in counts.items():
                launches[k] += c
            diff = surf.compare(case, got, want, inputs)
            if diff:
                failures.append(f"{case.id} n={n}: {diff}")
            if "cpu" in surf.devices_of(got):
                failures.append(f"{case.id} n={n}: a result tensor is on the CPU")
            idle = [k for k in case.needs if counts[k] == 0]
            if n > 1 and idle:
                failures.append(f"{case.id} n={n}: {idle} never launched: {counts}")
    secs = time.perf_counter() - t0
    names = len(surf.swept_names())
    slowest.sort(reverse=True)
    log(f"[surface] host CPU {cpu_s:.1f} s, card {card_s:.1f} s; slowest: "
        + "; ".join(f"{w} {s:.2f} s" for s, w in slowest[:5]))
    log(f"[surface] launches over the phase: {launches}")
    expect(not failures, f"[surface] {len(failures)} of {runs} cases failed:\n"
           + "\n".join(failures))
    expect(all(launches[k] > 0 for k in KERNELS),
           f"[surface] a kernel never launched in the phase: {launches}")
    log(f"[surface] {runs} cases over {names} public names: card == CPU "
        f"({len(cases)} calls x their sizes; {len(surf.EXCLUDED)} names "
        f"excluded with a reason) in {secs:.1f} s")
    return {"cases": runs, "names": names, "seconds": secs,
            "launches": launches}


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
    # the single-pass kernel's edges: one tile and around it, many tiles,
    # values and flags at offsets 1-3 from a 16-B boundary (their pairs
    # differ), and no flags (a null pointer) against all-zero flags
    from cuda.radixsort_tpu_torch.kernels import scan as kscan

    tile = kscan.TILE_BYTES // 4
    offsets = [(0, 0), (1, 1), (2, 3), (3, 0), (0, 2)]
    sizes = (1, 5, tile - 1, tile, tile + 1, 37 * tile + 5)
    for n in sizes:
        for dtype in (torch.int32, torch.uint32, torch.float32):
            for v_off, f_off in offsets:
                if dtype == torch.float32:
                    values = torch.randn(n + v_off, device="cuda",
                                         generator=gen)[v_off:]
                else:
                    values = rand_bits(n + v_off, dtype, gen)[v_off:]
                flags = (torch.rand(n + f_off, device="cuda", generator=gen)
                         < 0.05)[f_off:]
                for op in ("sum", "min", "max"):
                    case(values, flags, op)
    n_null = 0
    for n in (tile + 1, N_KEYS + 12345):
        zeros = torch.zeros(n, dtype=torch.bool, device="cuda")
        for dtype in (torch.int32, torch.uint32, torch.float32):
            for v_off in (0, 3):
                values = (torch.randn(n + v_off, device="cuda", generator=gen)
                          if dtype == torch.float32
                          else rand_bits(n + v_off, dtype, gen))[v_off:]
                for op in ("sum", "min", "max"):
                    got = kscan.segmented_scan(values, None, op)
                    want = kscan.segmented_scan(values, zeros, op)
                    torch.cuda.synchronize()
                    expect(torch.equal(sv(got), sv(want)),
                           f"segmented_scan {op} {dtype} n={n} offset {v_off}:"
                           " null flags differ from all-zero flags")
                    case(values, zeros, op)
                    n_null += 1
    # three runs of one 2^24 input give the same bits
    values_f = torch.randn(N_KEYS, device="cuda", generator=gen) * 100
    values_i = rand_bits(N_KEYS, torch.int32, gen)
    heads = torch.rand(N_KEYS, device="cuda", generator=gen) < 0.01
    for what, values, flags in (("float32 sum, no heads", values_f, None),
                                ("float32 sum, 1% heads", values_f, heads),
                                ("int32 sum, 1% heads", values_i, heads)):
        runs = [kscan.segmented_scan(values, flags, "sum") for _ in range(3)]
        torch.cuda.synchronize()
        expect(all(torch.equal(sv(r), sv(runs[0])) for r in runs[1:]),
               f"segmented_scan {what}: three runs of one input differ")
    log(f"[kernels] segmented_scan == plain on {n_cases} cases (sum/min/max x "
        f"int32/uint32/float32 at 2^24 and 2^24+12345 with 1% heads and NaNs "
        f"among the floats; {', '.join(edge_flags)}; n = {sizes} with values "
        f"/ flags at element offsets {offsets}); null flags == all-zero flags "
        f"bit for bit on {n_null} cases; three runs of one 2^24 input the "
        f"same bits (float32 sum without and with 1% heads, int32 sum); max "
        f"abs err {errs['exact']} (integers, min/max), {errs['f32_sum']} "
        f"(float32 sums, within {SCAN_F32_TOL} of the segment's sum of |x|)")
    phase_scan_wide(gen)
    torch.cuda.empty_cache()
    errs["reverse_f32_sum"] = phase_scan_reverse(gen)["f32_sum"]
    return errs


def _scan_wide_case(values, flags, op) -> None:
    """segmented_scan of 8-byte values on the card against its plain
    version, bit for bit."""
    from cuda.radixsort_tpu_torch.kernels import scan as kscan

    got = kscan.segmented_scan(values, flags, op)
    torch.cuda.synchronize()
    want = kscan.segmented_scan_plain(values, flags, op)
    bad = int((sv(got) != sv(want)).sum())
    expect(bad == 0, f"segmented_scan {op} {values.dtype} n={values.numel()} "
           f"phase {values.data_ptr() % 16 // 8} heads "
           f"{flags is not None}: {bad} rows differ from the plain version")


def phase_scan_wide(gen: torch.Generator) -> None:
    """The 8-byte instances (int64, uint64) of the scan kernel against the
    plain version, bit for bit: sum/min/max at 2^24 and 2^28 rows, with 1%
    heads and without flags, as views at element phase 0 and 1 of a 16-B
    boundary, on values near +-2^63 (bits 56-62 set to the sign bit), so
    that sums wrap at every few rows; then sizes around one 2048-row tile
    and over many, at element offsets 0-3."""
    from cuda.radixsort_tpu_torch.kernels import scan as kscan

    top = torch.full((), 0x7F << 56, dtype=torch.int64, device="cuda")
    n_cases = 0
    for n in (N_KEYS, N_PAIRS):
        heads = torch.rand(n, device="cuda", generator=gen) < 0.01
        for phase in (0, 1):
            bits = rand_bits(n + phase, torch.int64, gen)
            near = torch.where(bits >= 0, bits | top, bits & ~top)
            del bits
            for dtype in (torch.int64, torch.uint64):
                values = near.view(dtype)[phase:]
                for op in ("sum", "min", "max"):
                    for flags in (heads, None):
                        _scan_wide_case(values, flags, op)
                        n_cases += 1
            del near, values
            torch.cuda.empty_cache()
        del heads
    tile = kscan.TILE_BYTES // 8
    sizes = (1, 5, tile - 1, tile, tile + 1, 37 * tile + 5)
    for n in sizes:
        for dtype in (torch.int64, torch.uint64):
            for v_off, f_off in ((0, 0), (1, 1), (1, 3), (2, 2), (3, 0)):
                values = rand_bits(n + v_off, dtype, gen)[v_off:]
                flags = (torch.rand(n + f_off, device="cuda", generator=gen)
                         < 0.05)[f_off:]
                for op in ("sum", "min", "max"):
                    _scan_wide_case(values, flags, op)
                    _scan_wide_case(values, None, op)
                    n_cases += 2
    log(f"[kernels] segmented_scan 8-byte == plain bit for bit on {n_cases} "
        f"cases (sum/min/max x int64/uint64 at 2^24 and 2^28 rows, element "
        f"phases 0 and 1, 1% heads and no flags, values near +-2^63; n = "
        f"{sizes} at element offsets 0-3)")


def _rev_abs_scale(values, flags) -> torch.Tensor:
    """The sum of |x| over each row and the rest of its segment, in float64:
    the reverse scan's float32-sum tolerance scale."""
    from cuda.radixsort_tpu_torch.kernels import scan as kscan

    n = values.numel()
    heads = torch.zeros(n, dtype=torch.bool, device=values.device)
    if flags is not None:
        heads[:-1] = flags[1:].to(torch.bool)
    heads = torch.flip(heads, [0])
    heads[0] = True
    a = torch.flip(values.double().abs(), [0])
    return torch.flip(kscan.segmented_doubling(a, heads, torch.add), [0])


def _scan_reverse_case(values, flags, op) -> float:
    """segmented_scan_reverse on the card against its plain version (the
    flip form over the plain scan) and against flip -> forward kernel ->
    flip. Integers and float32 min/max bit for bit against both (NaN rows
    by position against the plain version); a float32 sum within
    SCAN_F32_TOL of the rest of its segment's |x| against the plain
    version, and bit for bit against the forward kernel where the reversed
    rows' phase is 0, the flipped copy's. Returns the largest difference of
    a float32 sum (0 for the exact cases)."""
    from cuda.radixsort_tpu_torch.kernels import scan as kscan

    got = kscan.segmented_scan_reverse(values, flags, op)
    fwd = kscan._flip_form(kscan.segmented_scan, values, flags, op)
    torch.cuda.synchronize()
    want = kscan.segmented_scan_reverse_plain(values, flags, op)
    n, size = values.numel(), values.element_size()
    vec = 16 // size
    phase = (vec - (n + values.data_ptr() % 16 // size) % vec) % vec
    what = (f"segmented_scan_reverse {op} {values.dtype} n={n} value offset "
            f"{values.data_ptr() % 16 // size} reversed phase {phase} flags "
            + ("none" if flags is None else f"offset {flags.data_ptr() % 4}"))
    f32_sum = (values.dtype, op) == (torch.float32, "sum")
    if not f32_sum or phase == 0:
        bad = int((sv(got) != sv(fwd)).sum())
        expect(bad == 0, f"{what}: {bad} rows differ from flip -> forward "
               "kernel -> flip")
    if values.dtype != torch.float32:
        bad = int((sv(got) != sv(want)).sum())
        expect(bad == 0, f"{what}: {bad} rows differ from the plain version")
        return 0.0
    g_nan, w_nan = torch.isnan(got), torch.isnan(want)
    expect(torch.equal(g_nan, w_nan), f"{what}: NaN at other rows")
    diff = torch.where(w_nan, 0.0, (got.double() - want.double()).abs())
    if f32_sum:
        ok = w_nan | (diff <= SCAN_F32_TOL * _rev_abs_scale(values, flags))
    else:
        ok = w_nan | (sv(got) == sv(want))
    expect(bool(ok.all()), f"{what}: max err {float(diff.max())} beyond its "
           "tolerance")
    return float(diff.max()) if f32_sum else 0.0


def phase_scan_reverse(gen: torch.Generator) -> dict:
    """The scan kernel's reverse direction (the group-by's totals at each
    group's first row) against its plain version and against flip ->
    forward kernel -> flip, on every kernel dtype x sum/min/max: 2^24 + 1,
    2 and 3 rows (each length mod 4) as views at element offsets 0, 1 and
    3 with flags at byte offsets 0, 2 and 1, 1% heads and NaNs among the
    floats; 2^28 + 3 rows at offset 1; lengths around one tile and over
    many at offsets 0-3; every row a head, only the first, and no flags.
    Then the reverse pass beside the forward pass and the flip form at
    2^27 + 2^24 int64 rows, 1% heads."""
    from cuda.radixsort_tpu_torch.kernels import scan as kscan
    from cuda.radixsort_tpu_torch.utils.profiling import device_time_ms

    dtypes = (torch.int32, torch.uint32, torch.float32, torch.int64,
              torch.uint64)

    def make(n, dtype, off, nan=False):
        if dtype == torch.float32:
            v = torch.randn(n + off, device="cuda", generator=gen) * 100
            if nan:
                v[torch.randint(0, n + off, (64,), device="cuda",
                                generator=gen)] = float("nan")
            return v[off:]
        return rand_bits(n + off, dtype, gen)[off:]

    def heads(n, off, rate):
        return (torch.rand(n + off, device="cuda", generator=gen)
                < rate)[off:]

    f32_err, n_cases = 0.0, 0

    def case(values, flags, op):
        nonlocal f32_err, n_cases
        f32_err = max(f32_err, _scan_reverse_case(values, flags, op))
        n_cases += 1

    for n, v_off, f_off in ((N_KEYS + 1, 0, 0), (N_KEYS + 2, 1, 2),
                            (N_KEYS + 3, 3, 1)):
        flags = heads(n, f_off, 0.01)
        for dtype in dtypes:
            values = make(n, dtype, v_off, nan=True)
            for op in ("sum", "min", "max"):
                case(values, flags, op)
        del flags, values
    n = N_PAIRS + 3
    flags = heads(n, 1, 0.01)
    for dtype, op in ((torch.int64, "sum"), (torch.uint64, "max"),
                      (torch.int32, "sum"), (torch.float32, "min"),
                      (torch.float32, "sum")):
        values = make(n, dtype, 1)
        case(values, flags, op)
        if dtype == torch.int64:
            case(values, None, op)
        del values
    del flags
    torch.cuda.empty_cache()
    for dtype in dtypes:
        tile = kscan.TILE_BYTES // dtype.itemsize
        for n in (1, 2, 3, 5, tile - 1, tile, tile + 1, 37 * tile + 5):
            for v_off, f_off in ((0, 0), (1, 1), (2, 3), (3, 2)):
                values = make(n, dtype, v_off)
                flags = heads(n, f_off, 0.05)
                for op in ("sum", "min", "max"):
                    case(values, flags, op)
        n = 3 * tile + 7
        values = make(n, dtype, 1)
        for flags in (torch.ones(n, dtype=torch.bool, device="cuda"),
                      torch.zeros(n, dtype=torch.bool, device="cuda"), None):
            for op in ("sum", "min", "max"):
                case(values, flags, op)
    log(f"[kernels] segmented_scan_reverse == plain and == flip -> forward "
        f"kernel -> flip on {n_cases} cases (sum/min/max x int32/uint32/"
        f"float32/int64/uint64 at 2^24 + 1/2/3 with 1% heads and NaNs, "
        f"2^28 + 3, lengths 1 to 37 tiles + 5 at offsets 0-3, every row a "
        f"head, only the first, no flags); integers and min/max bit for bit, "
        f"float32 sums bit for bit against the forward kernel at reversed "
        f"phase 0, max err {f32_err} against the plain version (within "
        f"{SCAN_F32_TOL} of the segment's sum of |x|)")

    n = N_PROBE + N_BUILD
    values = rand_bits(n, torch.int64, gen)
    flags = heads(n, 0, 0.01)
    t = {"reverse": device_time_ms(
             lambda: kscan.segmented_scan_reverse(values, flags, "sum"),
             runs=RUNS),
         "forward": device_time_ms(
             lambda: kscan.segmented_scan(values, flags, "sum"), runs=RUNS),
         "flip_form": device_time_ms(
             lambda: kscan._flip_form(kscan.segmented_scan, values, flags,
                                      "sum"), runs=RUNS)}
    bound, _ = bound_ms(kscan.scan_bytes(n, 8, True))
    log(f"[times] segmented_scan 2^27+2^24 int64 sum, 1% heads: reverse "
        f"pass {t['reverse']:.4f} ms, forward pass {t['forward']:.4f} ms, "
        f"flip -> forward -> flip (the group-by's route before the reverse "
        f"pass) {t['flip_form']:.4f} ms; bound {bound:.4f} ms")
    del values, flags
    torch.cuda.empty_cache()
    return {"f32_sum": f32_err, **{f"{k}_ms": v for k, v in t.items()}}


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


def check_fk(name, out, args) -> None:
    """The FK inner join's (keys, vals, probe_idx, count) against
    oracle_fk_join, bit for bit, tail rows included."""
    ok, ov, oi, count = out
    wk, wv, wi, wcount, bs = oracle_fk_join(*args)
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


def phase_operators(gen: torch.Generator, launches: dict) -> dict:
    """Each operator path once, counted, against its oracle. Returns the
    largest relative error of the grouped mean."""
    paths = operator_paths(gen)
    errs = {}

    name = FK
    fn, args, _, _ = paths[name]
    out = run_counted(name, lambda: fn(*args), RADIX_OPERATOR, launches)
    check_fk(name, out, args)
    del out, paths[name]
    torch.cuda.empty_cache()

    name = GROUPBY
    fn, args, _, oracle = paths[name]
    (gk, gs, gc), (ck, cc, ccount) = run_counted(name, lambda: fn(*args),
                                                 RADIX_OPERATOR, launches)
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
    gk, gm, gcount = run_counted(name, lambda: fn(*args), RADIX_OPERATOR,
                                 launches)
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


# ---------------------------------------------------------------------------
# the query layer (phase 5b): Table, Query, filter_sort_join and the
# partition, unique, select, histogram and window operators under them
# ---------------------------------------------------------------------------

N_FSJ_PROBE, N_FSJ_BUILD = 1 << 27, 1 << 24  # P1, the FK join's sizes
N_QUERY, N_QUERY_BUILD = 1 << 26, 1 << 22    # P2 and P4 (the reference's 16:1)
N_WINDOW = 1 << 26                           # P3
N_OPS = 1 << 26                              # P5
P1 = "P1 filter_sort_join_query 2^27 x 2^24"
P2 = "P2 table_query 2^26 x 2^22"
P3 = "P3 window_pipeline 2^26"
P4 = "P4 README Query 2^26 x 2^22"
P4_AGG = "P4 where-join-window-groupby_agg Query 2^26 x 2^22"
P4_DISTINCT = "P4 where-distinct Query 2^26"
PLAN_PATHS = (P1, P2, P3, P4, P4_AGG, P4_DISTINCT)
TOP_K = 1000


def sorted_i64(t: torch.Tensor) -> torch.Tensor:
    """A 1-D integer tensor (u32 included) as int64 values."""
    return u32_to_i64(t) if t.dtype == torch.uint32 else t.to(torch.int64)


def oracle_fsj(pk, pv, bk, bv, threshold):
    """filter_sort_join by plain torch: the probe rows with pv > threshold
    in their order, then oracle_fk_join. Returns (keys as int32 bits,
    probe values, build values, count, rows after the filter)."""
    sel = torch.nonzero(pv > threshold).squeeze(1)
    wk, wv, wi, count, _ = oracle_fk_join(bk, bv, pk.view(torch.int32)[sel]
                                          .view(torch.uint32))
    return wk, pv[sel][wi.long()], wv, count, sel.numel()


def oracle_table_query(k, v, bk, bv):
    """table_query's Table chain, by plain torch: the chain passes no count
    from one Table method to the next (as the reference's), so the join
    sees every probe row (the filter only reorders them) and the group-by
    sees the join's whole output: every probe row with its build value
    (every key has a build row) and the join's tail, the build rows with
    their own values. Returns oracle_groupby's (keys, sums, counts)."""
    bs = torch.sort(u32_to_i64(bk), stable=True)
    idx = torch.searchsorted(bs.values, u32_to_i64(k))
    keys = torch.cat([k.view(torch.int32), bk.view(torch.int32)])
    vals = torch.cat([bv[bs.indices[idx]], bv])
    return oracle_groupby(keys.view(torch.uint32), vals)


def segment_starts(sorted_cols) -> torch.Tensor:
    """True where any of the sorted columns changes (and at row 0)."""
    n = sorted_cols[0].numel()
    heads = torch.zeros(n, dtype=torch.bool, device=sorted_cols[0].device)
    heads[0] = True
    for c in sorted_cols:
        heads[1:] |= c[1:] != c[:-1]
    return heads


def start_fill(heads: torch.Tensor) -> torch.Tensor:
    """Each row's segment start position (int64): the heads' positions,
    gathered by a running count of the heads (torch.cummax, the other
    way, takes hundreds of ms at 2^26 on the card)."""
    return torch.nonzero(heads).squeeze(1)[torch.cumsum(heads, 0) - 1]


def seg_cumsum(v64: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Inclusive int64 running sums restarting at each segment start."""
    cs = torch.cumsum(v64, 0)
    return cs - (cs - v64)[start]


def oracle_window(part, order, vals):
    """window_pipeline by plain torch: a stable sort of part << 32 | order
    in int64, then row_number, rank and the int64 running sum per
    partition wrapped to int32."""
    key = (u32_to_i64(part) << 32) | u32_to_i64(order)
    perm = torch.sort(key, stable=True).indices
    sp, so = part.view(torch.int32)[perm], order.view(torch.int32)[perm]
    heads = segment_starts([sp])
    ps = start_fill(heads)
    pos = torch.arange(perm.numel(), device=perm.device)
    peer = start_fill(heads | segment_starts([so]))
    cs = seg_cumsum(vals[perm].to(torch.int64), ps)
    return (sp, (pos - ps + 1).to(torch.int32),
            (peer - ps + 1).to(torch.int32), wrap_i32(cs))


def query_data(gen: torch.Generator):
    """P4's orders table (k uniform below 2^23, v in [-1000, 1000)) and
    its parts table (the 2^22 even keys below 2^23, a price each): half the
    orders find their part."""
    from cuda.radixsort_tpu_torch.table import Table

    def rng(n, mod):
        return torch.randint(0, mod, (n,), dtype=torch.int64, device="cuda",
                             generator=gen)

    k = rng(N_QUERY, 2 * N_QUERY_BUILD).to(torch.int32).view(torch.uint32)
    v = (rng(N_QUERY, 2000) - 1000).to(torch.int32)
    pk = (torch.arange(N_QUERY_BUILD, device="cuda", dtype=torch.int32)
          * 2).view(torch.uint32)
    price = rng(N_QUERY_BUILD, 1000).to(torch.int32)
    return Table({"k": k, "v": v}), Table({"k": pk, "price": price})


def readme_query(orders, parts):
    import cuda.radixsort_tpu_torch as rt

    return (rt.Query(orders).where(lambda t: t["v"] > 100)
            .join(parts, on="k", value="price")
            .groupby("k", "v", agg="sum")
            .order_by("v", descending=True).limit(10))


def agg_query(orders, parts):
    import cuda.radixsort_tpu_torch as rt

    return (rt.Query(orders).where(lambda t: t["v"] > 100)
            .join(parts, on="k", value="price")
            .window("k", "v", {"rn": "row_number", "cs": ("v", "cumsum")})
            .groupby_agg(["k"], {"s": ("v", "sum"), "mu": ("v", "mean"),
                                 "med": ("v", "median"), "n": ("rn", "max"),
                                 "top": ("cs", "max")}))


def distinct_query(orders, parts):
    import cuda.radixsort_tpu_torch as rt

    return rt.Query(orders).where(lambda t: t["v"] > 100).distinct("k")


def query_rows(orders, parts):
    """The rows P4's plans keep: v > 100 and a part with their key, in row
    order (k as int64, v)."""
    k64 = u32_to_i64(orders["k"])
    ps = torch.sort(u32_to_i64(parts["k"])).values
    j = torch.searchsorted(ps, k64).clamp_max(ps.numel() - 1)
    keep = (orders["v"] > 100) & (ps[j] == k64)
    return k64[keep], orders["v"][keep]


def oracle_readme(orders, parts):
    """Group sums of the kept rows, the 10 largest (ties key-ascending, the
    order a stable descending sort of the key-ascending groups gives)."""
    k, v = query_rows(orders, parts)
    gk, sums, _ = oracle_groupby(k.to(torch.int32).view(torch.uint32), v)
    top = torch.sort(sums, descending=True, stable=True).indices[:10]
    return gk[top], sums[top], min(gk.numel(), 10)


def oracle_agg(orders, parts):
    """P4's aggregate plan by plain torch: the kept rows sorted stably by
    (k, v); per key the int32 sum, the float32 mean float32(sum) /
    float32(count), the median interpolated in float32 as numpy's linear
    rule (vlo * (1 - frac) + vhi * frac), the row count (the largest
    row_number) and the largest running sum."""
    k, v = query_rows(orders, parts)
    perm = torch.sort((k << 32) | (v.to(torch.int64) + (1 << 31)),
                      stable=True).indices
    k, v = k[perm], v[perm]
    heads = segment_starts([k])
    start = start_fill(heads)
    gk, inv = torch.unique_consecutive(k, return_inverse=True)
    g = gk.numel()
    counts = torch.bincount(inv, minlength=g)
    sums = torch.zeros(g, dtype=torch.int64, device=k.device)
    sums.index_add_(0, inv, v.to(torch.int64))
    s32 = wrap_i32(sums)
    mean = s32.to(torch.float32) / counts.to(torch.int32).to(torch.float32)
    first = torch.nonzero(heads).squeeze(1)
    idx_f = (counts - 1).to(torch.float32) * torch.tensor(0.5, device=k.device)
    lo, hi = torch.floor(idx_f), torch.ceil(idx_f)
    frac = idx_f - lo
    vf = v.to(torch.float32)
    vlo, vhi = vf[first + lo.long()], vf[first + hi.long()]
    med = vlo * (1 - frac) + vhi * frac
    cs = wrap_i32(seg_cumsum(v.to(torch.int64), start))
    top = torch.full((g,), -(1 << 31), dtype=torch.int32, device=k.device)
    top.scatter_reduce_(0, inv, cs, "amax")
    return (gk.to(torch.int32), s32, mean, med, counts.to(torch.int32), top)


def plan_paths(gen: torch.Generator) -> dict:
    """name -> (fn, args, rows, oracle) of the query-layer paths P1-P4."""
    from cuda.radixsort_tpu_torch.models import flagships

    fsj = flagships.filter_sort_join_query(N_FSJ_PROBE, N_FSJ_BUILD,
                                           generator=gen, device="cuda")
    tq = flagships.table_query(N_QUERY, N_QUERY_BUILD, generator=gen,
                               device="cuda")
    wp = flagships.window_pipeline(N_WINDOW, generator=gen, device="cuda")
    orders, parts = query_data(gen)
    threshold = flagships.PROBE_VALUE_RANGE // 2

    def run_plan(make):
        return lambda o, p: make(o, p).run()

    return {
        P1: (*fsj, N_FSJ_PROBE + N_FSJ_BUILD,
             lambda pk, pv, bk, bv: oracle_fsj(pk, pv, bk, bv, threshold)),
        P2: (*tq, N_QUERY + N_QUERY_BUILD, oracle_table_query),
        P3: (*wp, N_WINDOW, oracle_window),
        P4: (run_plan(readme_query), (orders, parts),
             N_QUERY + N_QUERY_BUILD, oracle_readme),
        P4_AGG: (run_plan(agg_query), (orders, parts),
                 N_QUERY + N_QUERY_BUILD, oracle_agg),
        P4_DISTINCT: (run_plan(distinct_query), (orders, parts), N_QUERY,
                      lambda o, p: torch.unique(
                          u32_to_i64(o["k"])[o["v"] > 100])),
    }


def expect_equal(name: str, what: str, got: torch.Tensor,
                 want: torch.Tensor) -> None:
    e = max_abs_err(got, want)
    expect(e == 0, f"{name}: {what} differ from the oracle (max err {e})")


def check_plan_path(name: str, out, args, oracle) -> float:
    """One query-layer path's output against its oracle: integers and the
    median bit for bit, the mean within MEAN_TOL. Returns the mean's
    largest relative error (0 where there is none)."""
    want = oracle(*args)
    if name == P1:
        k2, pv2, bv2, cnt, stats = out
        wk, wpv, wbv, c, n_filtered = want
        expect(int(cnt) == c and int(stats.rows_joined) == c
               and int(stats.rows_after_filter) == n_filtered
               and int(stats.rows_in) == N_FSJ_PROBE,
               f"{name}: counts {int(cnt)} / {tuple(int(s) for s in stats)}, "
               f"oracle {c} / {n_filtered}")
        for what, g, w in (("keys", k2[:c], wk),
                           ("probe values", pv2[:c], wpv),
                           ("build values", bv2[:c], wbv)):
            expect_equal(name, what, g, w)
        log(f"[plan] {name}: keys, probe and build values == oracle bit for "
            f"bit ({n_filtered} rows pass the filter, {c} joined)")
        return 0.0
    if name == P2:
        gk, gs, cnt = out
        wk, ws, _ = want
        c = wk.numel()
        expect(int(cnt) == c, f"{name}: {int(cnt)} groups, oracle {c}")
        expect_equal(name, "keys", gk[:c], wk)
        expect_equal(name, "sums", gs[:c], ws)
        log(f"[plan] {name}: keys and int32 sums == oracle bit for bit "
            f"({c} groups)")
        return 0.0
    if name == P3:
        sp, rn, rk, cs, cnt = out
        expect(int(cnt) == N_WINDOW, f"{name}: count {int(cnt)}")
        for what, g, w in zip(("partitions", "row_number", "rank", "cumsum"),
                              (sp, rn, rk, cs), want):
            expect_equal(name, what, g, w)
        log(f"[plan] {name}: partition, row_number, rank and int32 running "
            f"sums == oracle bit for bit")
        return 0.0
    t, cnt, stats = out
    expect(int(list(stats.values())[-1]) == int(cnt),
           f"{name}: the last stage's count is not the plan's")
    if name == P4:
        wk, ws, c = want
        expect(int(cnt) == c, f"{name}: count {int(cnt)}, oracle {c}")
        expect_equal(name, "keys", t["k"][:c], wk)
        expect_equal(name, "sums", t["v"][:c], ws)
        log(f"[plan] {name}: the 10 largest group sums and their keys == "
            f"oracle bit for bit")
        return 0.0
    if name == P4_DISTINCT:
        c = want.numel()
        expect(int(cnt) == c, f"{name}: count {int(cnt)}, oracle {c}")
        expect_equal(name, "keys", t["k"][:c].view(torch.int32),
                     want.to(torch.int32))
        log(f"[plan] {name}: {c} distinct keys == torch.unique bit for bit")
        return 0.0
    gk, s, mean, med, n, top = want
    c = gk.numel()
    expect(int(cnt) == c, f"{name}: count {int(cnt)}, oracle {c}")
    for what, col, w in (("keys", "k", gk), ("sums", "s", s),
                         ("medians", "med", med), ("row counts", "n", n),
                         ("largest running sums", "top", top)):
        expect_equal(name, what, t[col][:c], w)
    diff = (t["mu"][:c] - mean).abs()
    expect(bool((diff <= MEAN_TOL * mean.abs()).all()),
           f"{name}: a mean is off by more than {MEAN_TOL} relative")
    rel = float((diff / mean.abs().clamp_min(1e-30)).max())
    log(f"[plan] {name}: keys, sums, medians, row counts and running sums == "
        f"oracle bit for bit, means within {rel} relative ({c} groups)")
    return rel


def operator_cases(gen: torch.Generator) -> dict:
    """name -> (fn, needs, check) of P5: each operator once at 2^26 keys,
    against plain torch."""
    import cuda.radixsort_tpu_torch as rt

    keys = rand_bits(N_OPS, torch.uint32, gen)
    k64 = u32_to_i64(keys)
    pay = torch.arange(N_OPS, dtype=torch.int32, device="cuda")
    k24 = (k64 & ((1 << 24) - 1)).to(torch.int32).view(torch.uint32)
    ties = (k64 & 0xFFFF).to(torch.int32)  # 1024 copies of each value
    samples = torch.randn(N_OPS, device="cuda", generator=gen)

    def hash_ids(x):
        """The partition hash's top 8 bits, in int64 without a wrapping
        multiply: (h * c) mod 2^32 from c times h's two 16-bit halves."""
        m = 0xFFFFFFFF

        def mul(h, c):
            return ((h & 0xFFFF) * c + (((h >> 16) * c) & 0xFFFF) * 65536) & m
        h = mul(x, 0x9E3779B1)
        h ^= h >> 15
        h = mul(h, 0x85EBCA77)
        h ^= h >> 13
        return h >> 24

    def check_partition(out, ids):
        ko, po, offs = out
        order = torch.sort(ids, stable=True).indices
        expect_equal("partition", "keys", ko, keys.view(torch.int32)[order])
        expect_equal("partition", "payload", po, pay[order])
        counts = torch.bincount(ids, minlength=256)
        want = torch.cat([torch.zeros(1, dtype=torch.int64, device="cuda"),
                          torch.cumsum(counts, 0)]).to(torch.int32)
        expect_equal("partition", "offsets", offs, want)

    def check_unique(out):
        (dv, dc), (uv, uc) = out
        want = torch.unique(u32_to_i64(k24)).to(torch.int32)
        c = want.numel()
        expect(int(dc) == c and int(uc) == c,
               f"distinct / unique: {int(dc)} / {int(uc)}, oracle {c}")
        expect_equal("distinct", "values", dv[:c].view(torch.int32), want)
        expect_equal("unique", "values", uv[:c].view(torch.int32), want)

    def check_top_k(out):
        vals, idx = out
        s = torch.sort(ties, descending=True, stable=True)
        expect_equal("top_k", "values", vals, s.values[:TOP_K])
        expect_equal("top_k", "indices", idx,
                     s.indices[:TOP_K].to(torch.int32))

    def check_digits(out):
        for (shift, bits), got in zip(((16, 8), (4, 4)), out):
            want = torch.bincount((k64 >> shift) & ((1 << bits) - 1),
                                  minlength=1 << bits).to(torch.int32)
            expect_equal("digit_histogram", f"width {bits}", got, want)

    def check_even(out):
        lo, hi = torch.tensor(-3.0, device="cuda"), torch.tensor(3.0,
                                                                 device="cuda")
        bins = torch.floor((samples - lo) * (100 / (hi - lo))).long()
        ok = (samples >= lo) & (samples < hi)
        want = torch.bincount(bins[ok].clamp(0, 99), minlength=100)
        expect_equal("histogram_even", "counts", out, want.to(torch.int32))

    stage, hist, scan = RADIX_OPERATOR[1], RADIX_OPERATOR[0], RADIX_OPERATOR[2]
    return {
        "P5 partition 8 bits by range 2^26": (
            lambda: rt.partition(keys, pay, bits=8), (stage, hist),
            lambda out: check_partition(out, k64 >> 24)),
        "P5 partition 8 bits by hash 2^26": (
            lambda: rt.partition(keys, pay, bits=8, by_hash=True),
            (stage, hist), lambda out: check_partition(out, hash_ids(k64))),
        "P5 distinct and unique 2^26": (
            lambda: (rt.distinct(k24),
                     rt.unique(torch.sort(u32_to_i64(k24)).values.to(
                         torch.int32).view(torch.uint32))),
            (stage, hist), check_unique),
        f"P5 top_k {TOP_K} of 2^26": (
            lambda: rt.top_k(ties, TOP_K), (stage, hist, scan), check_top_k),
        "P5 digit_histogram widths 8 and 4 2^26": (
            lambda: (rt.digit_histogram(keys, begin_bit=16, bits=8),
                     rt.digit_histogram(keys, begin_bit=4, bits=4)),
            (hist,), check_digits),
        "P5 histogram_even 100 bins 2^26": (
            lambda: rt.histogram_even(samples, 100, -3.0, 3.0), (hist,),
            check_even),
    }


def phase_plan(gen: torch.Generator, launches: dict) -> dict:
    """The query layer's paths P1-P5 once each, counted, against their
    oracles. Returns the grouped mean's largest relative error."""
    needs = {P1: RADIX_OPERATOR, P2: RADIX_OPERATOR, P3: RADIX_OPERATOR,
             P4: RADIX_OPERATOR, P4_AGG: RADIX_OPERATOR,
             P4_DISTINCT: RADIX_OPERATOR[:2]}
    errs = {"mean_rel_err": 0.0}
    paths = plan_paths(gen)
    for name in PLAN_PATHS:
        fn, args, _, oracle = paths.pop(name)
        out = run_counted(name, lambda: fn(*args), needs[name], launches)
        errs["mean_rel_err"] = max(errs["mean_rel_err"],
                                   check_plan_path(name, out, args, oracle))
        del fn, args, out
        torch.cuda.empty_cache()
    for name, (fn, kernels, check) in operator_cases(gen).items():
        check(run_counted(name, fn, kernels, launches))
        log(f"[plan] {name}: == plain torch bit for bit")
    torch.cuda.empty_cache()
    return errs


# (planes, n_cmp, logn, heavy ties); n_cmp > 0 with ride planes gets a
# permutation as its last comparand, so the order is total
NETWORK_SORTS = [(1, 1, 10, False), (1, 1, 24, False), (1, 1, 20, True),
                 (2, 2, 16, False), (2, 1, 22, False), (2, -1, 20, True),
                 (2, 2, 24, True), (3, 3, 18, True), (3, -2, 22, True),
                 (3, 2, 24, False), (3, -1, 12, True), (4, 3, 24, False),
                 (4, -2, 21, True), (4, -1, 17, True), (4, 4, 23, True),
                 (4, 1, 14, False)]
# (planes, n_cmp, logn, heavy ties, log_block)
# the last is path (e)'s top merge level: 2^28 rows of (key, source
# index, payload)
NETWORK_MERGES = [(1, 1, 24, False, 23), (3, 2, 22, False, 12),
                  (3, -2, 20, True, 16), (4, 3, 23, False, 9),
                  (2, -1, 10, True, 5), (3, 2, 28, False, 27)]
# the same kernels on a small geometry: more cross passes, narrow strides;
# planes -> (log_t, c_max) for plan_passes
SMALL_GEOMETRY = {1: (10, 3), 2: (10, 2), 3: (10, 2), 4: (10, 1)}
NETWORK_SMALL = [(1, 1, 18, False), (4, -2, 16, True), (2, 2, 20, True)]
# (kernel, planes, n_cmp, logn, keyword arguments) of direct kernel calls;
# the 2^28 ones at the preset geometry of the main path's shapes: (b) is 4
# planes with n_cmp 3, (c) 3 planes tie-safe (n_cmp -2, network tile 2^15),
# (d)'s sort and (e)'s merge 3 planes with n_cmp 2; the cross passes are
# the top level's widest span
NETWORK_DIRECT = [
    ("tile sort mode", 1, 1, 24, dict(log_t=15, k_first=1, k_last=15,
                                      net_tile=16)),
    ("tile sort mode", 4, 4, 24, dict(log_t=13, k_first=1, k_last=13,
                                      net_tile=15)),
    ("tile merge mode", 2, -1, 24, dict(log_t=14, k_first=20, k_last=20,
                                        net_tile=16)),
    ("tile merge mode", 3, 2, 24, dict(log_t=14, k_first=24, k_last=24)),
    ("cross", 1, 1, 24, dict(k=24, lo=18, c=6)),
    ("cross", 4, 3, 24, dict(k=22, lo=13, c=4)),
    ("cross", 2, -2, 24, dict(k=16, lo=15, c=1, net_tile=16)),
    ("cross", 3, -1, 24, dict(k=24, lo=0, c=4)),
    ("tile sort mode", 3, 2, 28, dict(log_t=14, k_first=1, k_last=14,
                                      net_tile=15)),
    ("tile sort mode", 3, -2, 28, dict(log_t=14, k_first=1, k_last=14,
                                       net_tile=15)),
    ("tile sort mode", 4, 3, 28, dict(log_t=13, k_first=1, k_last=13,
                                      net_tile=15)),
    ("tile sort mode", 4, 4, 28, dict(log_t=13, k_first=1, k_last=13,
                                      net_tile=15)),
    ("tile merge mode", 3, 2, 28, dict(log_t=14, k_first=28, k_last=28)),
    ("tile merge mode", 3, -2, 28, dict(log_t=14, k_first=28, k_last=28)),
    ("tile merge mode", 4, 4, 28, dict(log_t=13, k_first=28, k_last=28)),
    ("cross", 3, 2, 28, dict(k=28, lo=24, c=4)),
    ("cross", 3, -2, 28, dict(k=28, lo=24, c=4)),
    ("cross", 4, 3, 28, dict(k=28, lo=24, c=4)),
    ("cross", 4, 4, 28, dict(k=28, lo=24, c=4)),
]


# (planes, n_cmp, log_t): per plane count a tile of registers only (log_t
# <= e), of registers and shuffles (log_t <= e + 5) and of all three
# stride classes (e from kernels/bitonic.py::tile_geometry: 5, 4, 3, 3)
NETWORK_CLASSES = [(1, 1, 3), (1, -1, 9), (1, 1, 14),
                   (2, -2, 2), (2, 2, 8), (2, 1, 13),
                   (3, 2, 3), (3, -1, 7), (3, 3, 13),
                   (4, 1, 2), (4, -2, 6), (4, 4, 12)]


def network_planes(n_planes, n_cmp, logn, ties, gen) -> list:
    n = 1 << logn
    planes = [rand_bits(n, torch.uint32, gen) for _ in range(n_planes)]
    if ties:  # four values in every comparand plane
        for q in range(min(abs(n_cmp), n_planes)):
            planes[q] = (planes[q].view(torch.int32) & 3).view(torch.uint32)
    if 0 < n_cmp < n_planes:
        perm = torch.randperm(n, device="cuda", generator=gen)
        planes[n_cmp - 1] = perm.to(torch.int32).view(torch.uint32)
    return planes


def planes_err(got, want) -> int:
    return max(max_abs_err(g, w) for g, w in zip(got, want))


def phase_network_kernels(gen: torch.Generator) -> dict:
    """The tile and cross kernels against the plain network, bit for bit:
    whole sorts and merges (both kernels), then each kernel alone."""
    from cuda.radixsort_tpu_torch.kernels import bitonic as bk

    errs = {"bitonic_tile": 0, "bitonic_cross": 0}
    cases = {"sort": 0, "merge": 0, "tile sort mode": 0,
             "tile merge mode": 0, "cross": 0}

    def record(what, kernels, got, want):
        e = planes_err(got, want)
        expect(e == 0, f"{what}: differs from the plain network (max err {e})")
        for k in kernels:
            errs[k] = max(errs[k], e)

    for small, table in ((False, NETWORK_SORTS), (True, NETWORK_SMALL)):
        for p, n_cmp, logn, ties in table:
            planes = network_planes(p, n_cmp, logn, ties, gen)
            lt = bk.network_log_tile(p)
            mine = [q.clone() for q in planes]
            if small:
                log_t, c_max = SMALL_GEOMETRY[p]
                ops = bk.plan_passes(logn, 1, p, log_t=log_t, c_max=c_max)
                got = bk.run_passes(mine, ops, min(lt, logn), n_cmp)
            else:
                got = bk.sort_planes_bitonic(mine, n_cmp=n_cmp, log_tile=lt)
            torch.cuda.synchronize()
            want = bk.sort_planes_bitonic_plain(planes, n_cmp=n_cmp,
                                                log_tile=lt)
            record(f"network sort {p} planes n_cmp={n_cmp} 2^{logn} "
                   f"ties={ties} {'small geometry' if small else 'preset'}",
                   NETWORK, got, want)
            cases["sort"] += 1
    for p, n_cmp, logn, ties, lb in NETWORK_MERGES:
        planes = network_planes(p, n_cmp, logn, ties, gen)
        got = bk.merge_sorted_planes_bitonic([q.clone() for q in planes],
                                             log_block=lb, n_cmp=n_cmp)
        torch.cuda.synchronize()
        want = bk.merge_sorted_planes_bitonic_plain(planes, log_block=lb,
                                                    n_cmp=n_cmp)
        record(f"network merge {p} planes n_cmp={n_cmp} 2^{logn} log_block "
               f"{lb}", NETWORK, got, want)
        cases["merge"] += 1
    del planes, mine, got, want
    torch.cuda.empty_cache()

    for kind, p, n_cmp, logn, kw in NETWORK_DIRECT:
        planes = network_planes(p, n_cmp, logn, n_cmp < 0, gen)
        if kind == "cross":
            got = bk.cross_pass([q.clone() for q in planes], n_cmp=n_cmp, **kw)
            torch.cuda.synchronize()
            want = bk.cross_pass_plain(planes, n_cmp=n_cmp, **kw)
            record(f"cross_pass {p} planes n_cmp={n_cmp} 2^{logn} {kw}",
                   ["bitonic_cross"], got, want)
        else:
            got = bk.tile_pass([q.clone() for q in planes], n_cmp=n_cmp, **kw)
            torch.cuda.synchronize()
            want = bk.tile_pass_plain(planes, n_cmp=n_cmp, **kw)
            record(f"tile_pass {p} planes n_cmp={n_cmp} 2^{logn} {kw}",
                   ["bitonic_tile"], got, want)
        cases[kind] += 1
        del planes, got, want
        torch.cuda.empty_cache()
    n_all = sum(cases.values())
    geo = [(bk.tile_log_rows(p), bk.cross_strides(p)) for p in (1, 2, 3, 4)]
    log(f"[kernels] bitonic tile and cross kernels == plain network on "
        f"{n_all} cases ({cases}; 1-4 planes, n_cmp 1/2/3/-1/-2/all, "
        f"2^10..2^28 rows, ties on the tie-safe cases; (log_t, c) per plane "
        f"count: preset {geo}, small {SMALL_GEOMETRY})")
    expect(n_all >= 20, f"only {n_all} network kernel cases")

    # tile geometries in which each stride class occurs, whole networks of
    # 2^18 rows with four values per comparand plane
    classes = {}
    for p, n_cmp, log_t in NETWORK_CLASSES:
        e, _ = bk.tile_geometry(p, log_t)
        kinds = set()
        for kind, k, a, b in bk.tile_phases(log_t, e, 1, log_t):
            if kind == "shared":
                kinds.add("shared")
                continue
            kinds.add("register")  # stride 1 is in every register phase
            if max(b, min(a, log_t) - 1 if a > k else b) >= e:
                kinds.add("shuffle")
        planes = network_planes(p, n_cmp, 18, True, gen)
        lt = bk.network_log_tile(p)
        ops = bk.plan_passes(18, 1, p, log_t=log_t)
        got = bk.run_passes([q.clone() for q in planes], ops, lt, n_cmp)
        torch.cuda.synchronize()
        want = bk.sort_planes_bitonic_plain(planes, n_cmp=n_cmp, log_tile=lt)
        record(f"network sort {p} planes n_cmp={n_cmp} 2^18 log_t={log_t} "
               f"({sorted(kinds)})", NETWORK, got, want)
        key = "+".join(sorted(kinds))
        classes[key] = classes.get(key, 0) + 1
        del planes, got, want
    expect(len(classes) == 3, f"stride classes covered: {classes}")
    log(f"[kernels] bitonic tile kernel == plain network on "
        f"{len(NETWORK_CLASSES)} geometries by stride class ({classes}; 1-4 "
        f"planes, n_cmp 1/-1/2/-2/all, heavy ties)")
    torch.cuda.empty_cache()
    tile_rejects_bad_launches()
    return errs


def tile_rejects_bad_launches() -> None:
    """The tile kernel's C entry point refuses, with cudaErrorInvalidValue
    (1) and no launch, a block of fewer than 32 threads that does not cover
    its tile's units in one pass, and phases its geometry cannot run."""
    import ctypes

    from cuda.radixsort_tpu_torch.kernels import bitonic as bk
    from cuda.radixsort_tpu_torch.utils import build

    lib = build.library()
    planes = [torch.zeros(1 << 8, dtype=torch.int32,
                          device="cuda").view(torch.uint32)]
    ptrs = build.ptr_array(planes)
    log_t, e = 8, 2  # 64 units of 4 rows
    cases = {
        "16 threads for 64 units": (16, bk.tile_phases(log_t, e, 1, log_t)),
        "a shuffle stride of 32 lanes": (64, [("register", 8, 8, e + 5)]),
        "a group of more than e strides": (64, [("shared", 8, 0, e + 1)]),
        "a group beyond the tile": (64, [("shared", 8, 7, 2)]),
    }
    for what, (threads, phases) in cases.items():
        words = [x for kind, k, a, b in phases
                 for x in (kind == "shared", k, a, b)]
        words = (ctypes.c_int * len(words))(*words)
        err = lib.rs_bitonic_tile(
            ctypes.cast(ptrs, ctypes.c_void_p), 1, 1 << log_t, log_t, e,
            threads, ctypes.cast(words, ctypes.c_void_p), len(phases), 0, 1,
            bk.tile_smem_bytes(1, log_t),
            torch.cuda.current_stream().cuda_stream)
        expect(err == 1, f"rs_bitonic_tile accepted {what} (returned {err})")
    torch.cuda.synchronize()
    log(f"[kernels] bitonic tile entry point refuses {len(cases)} launches "
        f"it cannot run: {', '.join(cases)}")


def sorted_u32(n: int, gen: torch.Generator) -> torch.Tensor:
    """n random u32 keys in ascending order."""
    v = torch.sort(u32_to_i64(rand_bits(n, torch.uint32, gen))).values
    return v.to(torch.int32).view(torch.uint32)


def canonical_pairs(keys: torch.Tensor, pay: torch.Tensor):
    """(u64 keys, u32 payloads) ordered by (key, payload): equal for two
    inputs iff their (key, payload) multisets are equal."""
    o1 = torch.sort(u32_to_i64(pay), stable=True).indices
    k64 = keys.view(torch.int64) ^ (-(1 << 63))
    o2 = torch.sort(k64[o1], stable=True).indices
    order = o1[o2]
    return sv(keys)[order], sv(pay)[order]


def ragged_offsets(n: int, n_segments: int, gen) -> torch.Tensor:
    """(n_segments + 1,) int32 offsets of segments of random sizes."""
    cuts = torch.randperm(n - 1, device="cuda", generator=gen)[:n_segments - 1]
    cuts = torch.sort(cuts + 1).values
    zero = torch.zeros(1, dtype=torch.int64, device="cuda")
    return torch.cat([zero, cuts, zero + n]).to(torch.int32)


def oracle_segmented(keys: torch.Tensor, offsets: torch.Tensor):
    """Keys sorted within each segment: torch.sort of (segment << 32 | key)."""
    rows = torch.arange(keys.numel(), device=keys.device)
    seg = torch.searchsorted(offsets[1:-1].to(torch.int64), rows, right=True)
    combo = torch.sort((seg << 32) | u32_to_i64(keys)).values
    return (combo & 0xFFFFFFFF).to(torch.int32).view(torch.uint32)


def network_paths(gen: torch.Generator) -> dict:
    """name -> (fn(cfg), oracle(), rows): the network paths (a)-(f), each
    run with a config (the network's, or the radix engine's for times)."""
    import cuda.radixsort_tpu_torch as rt
    from cuda.radixsort_tpu_torch.models import flagships

    keys1 = rand_bits(N_KEYS, torch.uint32, gen)
    keys2 = rand_bits(N_PAIRS, torch.uint64, gen)
    pay2 = rand_bits(N_PAIRS, torch.uint32, gen)
    _, fk_args = flagships.fk_join(N_PROBE, N_BUILD, generator=gen,
                                   device="cuda")
    half = N_PAIRS // 2
    ma, mb = sorted_u32(half, gen), sorted_u32(half, gen)
    pa, pb = rand_bits(half, torch.uint32, gen), rand_bits(half, torch.uint32, gen)
    seg_keys = rand_bits(N_KEYS, torch.uint32, gen)
    offsets = ragged_offsets(N_KEYS, N_SEGMENTS, gen)
    k32 = keys1.view(torch.int32) ^ (-(1 << 31))
    s64 = keys2.view(torch.int64) ^ (-(1 << 63))
    mkeys = u32_to_i64(torch.cat([ma.view(torch.int32), mb.view(torch.int32)]))
    mpay = torch.cat([pa.view(torch.int32), pb.view(torch.int32)])
    return {
        NET_A: (lambda cfg: rt.sort(keys1, config=cfg),
                lambda: torch.sort(k32), N_KEYS),
        NET_B: (lambda cfg: rt.sort_pairs(keys2, pay2, config=cfg),
                lambda: pay2.view(torch.int32)[torch.sort(s64, stable=True).indices],
                N_PAIRS),
        NET_C: (lambda cfg: rt.sort_pairs(keys2, pay2, config=cfg, stable=False),
                lambda: pay2.view(torch.int32)[torch.sort(s64).indices],
                N_PAIRS),
        NET_D: (lambda cfg: rt.join(*fk_args, how="inner", config=cfg),
                lambda: oracle_fk_join(*fk_args), N_PROBE + N_BUILD),
        NET_E: (lambda cfg: rt.merge_sorted_pairs(ma, pa, mb, pb, config=cfg),
                lambda: mpay[torch.sort(mkeys, stable=True).indices], N_PAIRS),
        NET_F: (lambda cfg: rt.segmented_sort(seg_keys, offsets, config=cfg),
                lambda: oracle_segmented(seg_keys, offsets), N_KEYS),
        "_data": (keys1, keys2, pay2, fk_args, (ma, pa, mb, pb, mkeys, mpay),
                  (seg_keys, offsets)),
    }


def phase_network(gen: torch.Generator, launches: dict) -> None:
    """Paths (a)-(f) on the network engine, counted, against their oracles."""
    import cuda.radixsort_tpu_torch as rt
    from cuda.radixsort_tpu_torch.kernels import bitonic as bk

    net = rt.SortConfig(engine="bitonic")
    paths = network_paths(gen)
    keys1, keys2, pay2, fk_args, merge_data, seg_data = paths.pop("_data")
    pure = ("partition_stage",)

    out = run_counted(NET_A, lambda: paths[NET_A][0](net), NETWORK, launches,
                      forbid=pure)
    check_sort(NET_A, out, keys1)
    k, v = run_counted(NET_B, lambda: paths[NET_B][0](net), NETWORK, launches,
                       forbid=pure)
    check_sort(NET_B, k, keys2, got_vals=[v], vals=[pay2])
    del k, v
    k, v = run_counted(NET_C, lambda: paths[NET_C][0](net), NETWORK, launches,
                       forbid=pure)
    check_sort(NET_C + " (keys)", k, keys2)
    for (g, w), what in zip(zip(canonical_pairs(k, v),
                                canonical_pairs(keys2, pay2)),
                            ("keys", "payloads")):
        e = max_abs_err(g, w)
        expect(e == 0, f"{NET_C}: (key, payload) multiset differs ({what}, "
               f"max err {e})")
    del k, v, g, w
    torch.cuda.empty_cache()
    # a heavy-tie case against the plain network on the same planes:
    # (hi, lo) limbs of 16 distinct u64 keys and the payload, tie-safe
    kt = (rand_bits(N_KEYS, torch.uint64, gen).view(torch.int64)
          & 0x0000000300000003).view(torch.uint64)
    pt = rand_bits(N_KEYS, torch.uint32, gen)
    gk, gv = rt.sort_pairs(kt, pt, config=net, stable=False)
    lohi = kt.view(torch.int32).reshape(-1, 2)
    planes = [lohi[:, 1].contiguous().view(torch.uint32),
              lohi[:, 0].contiguous().view(torch.uint32), pt.clone()]
    hi, lo, pv = bk.sort_planes_bitonic_plain(planes, n_cmp=-2,
                                              log_tile=bk.network_log_tile(3))
    want_k = torch.stack([lo.view(torch.int32), hi.view(torch.int32)], 1)
    e = max(max_abs_err(gk, want_k.view(torch.int64).reshape(-1).view(torch.uint64)),
            max_abs_err(gv, pv))
    expect(e == 0, f"unstable heavy-tie sort_pairs 2^24 differs from the plain "
           f"network (max err {e})")
    log(f"[network] {NET_A}, {NET_B} == oracle bit for bit; {NET_C}: keys bit "
        f"for bit and (key, payload) multiset == oracle; unstable 2^24 u64+u32 "
        f"with 16 distinct keys == the plain network bit for bit")
    del kt, pt, gk, gv, planes, hi, lo, pv, want_k, keys2, pay2
    paths.pop(NET_B)
    paths.pop(NET_C)
    torch.cuda.empty_cache()

    # the join's sort of 2^27 + 2^24 rows must take the split-sort-merge
    # route with the tag comparand: a top merge level of 2^28 rows over
    # (key, tag, value), n_cmp 2 (an index plane would make 4 planes; the
    # padded sort would merge nothing at log_block 27)
    merges, real_merge = [], bk.merge_sorted_planes_bitonic

    def traced_merge(planes, **kw):
        merges.append((planes[0].numel(), len(planes), kw["log_block"],
                       kw["n_cmp"]))
        return real_merge(planes, **kw)

    bk.merge_sorted_planes_bitonic = traced_merge
    try:
        out = run_counted(NET_D, lambda: paths[NET_D][0](net),
                          NETWORK + ("segmented_scan",), launches)
    finally:
        bk.merge_sorted_planes_bitonic = real_merge
    logn = (N_PROBE + N_BUILD - 1).bit_length()
    split = (1 << logn, 3, logn - 1, 2)
    expect(split in merges, f"{NET_D}: no split-sort-merge level {split} "
           f"(rows, planes, log_block, n_cmp); merges: {merges}")
    check_fk(NET_D, out, fk_args)
    log(f"[network] {NET_D}: split-sort-merge route with the tag comparand "
        f"taken (merge levels (rows, planes, log_block, n_cmp): {merges})")
    del out
    paths.pop(NET_D)
    torch.cuda.empty_cache()

    ma, pa, mb, pb, mkeys, mpay = merge_data
    gk, gv = run_counted(NET_E, lambda: paths[NET_E][0](net), NETWORK,
                         launches, forbid=pure)
    rk, rv = paths[NET_E][0](rt.SortConfig(engine="radix"))
    order = torch.sort(mkeys, stable=True).indices
    for what, g, w in (("keys vs rank-scatter", gk, rk),
                       ("payloads vs rank-scatter", gv, rv),
                       ("keys vs torch.sort", gk, mkeys[order].to(torch.int32)),
                       ("payloads vs torch.sort", gv, mpay[order])):
        e = max_abs_err(g, w)
        expect(e == 0, f"{NET_E}: {what} differ (max err {e})")
    del gk, gv, rk, rv, order
    paths.pop(NET_E)
    torch.cuda.empty_cache()

    seg_keys, offsets = seg_data
    out = run_counted(NET_F, lambda: paths[NET_F][0](net),
                      NETWORK + ("segmented_scan",), launches, forbid=pure)
    e = max_abs_err(out, oracle_segmented(seg_keys, offsets))
    expect(e == 0, f"{NET_F}: differs from the oracle (max err {e})")
    log(f"[network] {NET_D} == oracle; {NET_E} == the rank-scatter route and "
        f"a stable torch.sort of the concatenation; {NET_F} == oracle; all bit "
        f"for bit")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# sort_large, the reference engine and the measurement module
# ---------------------------------------------------------------------------

L1 = "L1 sort_large 2^28 u32 (msd_bits 8)"
L2 = "L2 sort_large 2^27 u32 (msd_bits 4)"
L3 = "L3 sort_large 2^27 u32, 90% of keys in one top byte (msd_bits 4)"
L4 = "L4 sort_large 2^24 f32 descending, msd_bits=4"
L5 = "L5 sort_large 2^24 u32 with 0xFFFFFFFF keys (msd_bits 4)"
LARGE_PATHS = (L1, L2, L3, L4, L5)
N_REF = 1 << 20
R1 = "R1 sort engine='reference' 2^20 u32"
R2 = "R2 sort_pairs engine='reference' 2^20 u32+u32"
REF_PATHS = (R1, R2)
BATCHES: dict = {}  # L path -> (cap, group, buckets) of its batches


def large_keys(name: str, gen: torch.Generator):
    """(keys, descending, msd_bits) of one sort_large case, made on the
    card; msd_bits None is sort_large's default."""
    if name in (L1, L2):
        return rand_bits(1 << (28 if name == L1 else 27), torch.uint32,
                         gen), False, None
    if name == L3:  # one bucket of about 0.9 * 2^27 keys: batches of one
        k = rand_bits(1 << 27, torch.uint32, gen).view(torch.int32)
        hot = torch.rand(k.numel(), device="cuda", generator=gen) < 0.9
        k = torch.where(hot, (k & 0x00FFFFFF) | (0x5A << 24), k)
        return k.view(torch.uint32), False, None
    if name == L4:
        return rand_bits(1 << 24, torch.float32, gen), True, 4
    k = rand_bits(1 << 24, torch.uint32, gen).view(torch.int32)
    top = torch.rand(k.numel(), device="cuda", generator=gen) < 0.05
    return torch.where(top, -1, k).view(torch.uint32), False, None


def phase_sort_large(gen: torch.Generator, launches: dict) -> dict:
    """sort_large L1-L5 through the public entry point, each counted (one
    histogram launch and one stage pass: phase A), bit for bit against
    the torch.sort oracle and rt.sort, with the batches it chose, then
    timed beside rt.sort and torch.sort; the reference engine R1-R2 at
    2^20 (plain torch: no kernel may launch) bit for bit against rt.sort /
    rt.sort_pairs, timed once; a trace of config 2 must hold the
    sort_pairs range. Returns {path: (ms, rt_ms, torch_ms, rows)}."""
    import cuda.radixsort_tpu_torch as rt
    from cuda.radixsort_tpu_torch.utils import profiling
    from cuda.radixsort_tpu_torch.utils.profiling import cuda_time_ms

    sort_mod = importlib.import_module("cuda.radixsort_tpu_torch.ops.sort")
    real_batches = sort_mod._hybrid_bucket_sort
    batches = []

    def counted_batches(pb, bounds, *, cap, group):
        batches.append((cap, group, bounds.shape[0] - 1))
        return real_batches(pb, bounds, cap=cap, group=group)

    times = {}
    for name in LARGE_PATHS:
        keys, desc, msd = large_keys(name, gen)
        run = lambda: rt.sort_large(keys, descending=desc, msd_bits=msd)
        counts: dict = {}
        batches.clear()
        sort_mod._hybrid_bucket_sort = counted_batches
        try:
            out = run_counted(name, run, SORT_KERNELS, counts)
        finally:
            sort_mod._hybrid_bucket_sort = real_batches
        expect(counts["digit_histograms"] == 1
               and counts["partition_stage"] == 1,
               f"{name}: phase A launched {counts}, not one histogram and "
               "one stage pass")
        for k, c in counts.items():
            launches[k] = launches.get(k, 0) + c
        (cap, group, nb), = batches
        BATCHES[name] = (cap, group, nb)
        # the memory bound: a batch holds about 2^26 keys, or one bucket
        # where a bucket is larger (L3's: batches of one bucket)
        expect(group * cap <= max(cap, 1 << 26), f"{name}: batches of "
               f"{group} x {cap} slots exceed max(cap, 2^26)")
        check_sort(name, out, keys, descending=desc)
        e = max_abs_err(out, rt.sort(keys, descending=desc))
        expect(e == 0, f"{name}: differs from rt.sort (max err {e})")
        del out
        torch.cuda.empty_cache()
        # torch.sort on the card sorts no u32: the sign-flipped int32 view
        lib = (keys.view(torch.int32) ^ (-(1 << 31))
               if keys.dtype == torch.uint32 else keys)
        # the two phases apart: the partition on the kernels, the batches
        cfg = rt.resolve()
        phase_a = lambda: sort_mod._hybrid_partition(
            keys, descending=desc, msd_bits=nb.bit_length() - 1, config=cfg)
        pb, bounds = phase_a()
        phase_b = lambda: sort_mod._hybrid_bucket_sort(pb, bounds, cap=cap,
                                                       group=group)
        times[name] = tuple(cuda_time_ms(f, runs=3) for f in (
            run, lambda: rt.sort(keys, descending=desc),
            lambda: torch.sort(lib))) + (keys.numel(),) + tuple(
            cuda_time_ms(f, runs=3) for f in (phase_a, phase_b))
        log(f"[sort_large] {name}: == the torch.sort oracle and rt.sort bit "
            f"for bit; batches of {group} bucket(s) x {cap} slots; "
            f"{times[name][0]:.3f} ms: phase A {times[name][4]:.3f} ms, "
            f"phase B {times[name][5]:.3f} ms (rt.sort {times[name][1]:.3f} "
            f"ms, torch.sort {times[name][2]:.3f} ms)")
        del keys, lib, pb, bounds
        torch.cuda.empty_cache()

    ref = rt.SortConfig(engine="reference")
    keys = (rand_bits(N_REF, torch.uint32, gen).view(torch.int32)
            & 0xFFF0FFFF).view(torch.uint32)  # ties: stability shows
    pay = rand_bits(N_REF, torch.uint32, gen)
    out = run_counted(R1, lambda: rt.sort(keys, config=ref), (), {},
                      forbid=KERNELS)
    e = max_abs_err(out, rt.sort(keys))
    expect(e == 0, f"{R1}: differs from rt.sort (max err {e})")
    ok, ov = run_counted(R2, lambda: rt.sort_pairs(keys, pay, config=ref),
                         (), {}, forbid=KERNELS)
    wk, wv = rt.sort_pairs(keys, pay)
    e = max(max_abs_err(ok, wk), max_abs_err(ov, wv))
    expect(e == 0, f"{R2}: differs from rt.sort_pairs (max err {e})")
    times[R1] = (cuda_time_ms(lambda: rt.sort(keys, config=ref), runs=1),
                 cuda_time_ms(lambda: rt.sort(keys), runs=1), None, N_REF)
    times[R2] = (cuda_time_ms(lambda: rt.sort_pairs(keys, pay, config=ref),
                              runs=1),
                 cuda_time_ms(lambda: rt.sort_pairs(keys, pay), runs=1),
                 None, N_REF)
    for name in LARGE_PATHS:  # batch shapes, in the record
        times[name] += (BATCHES[name],)
    log(f"[reference] {R1} and {R2} == rt.sort / rt.sort_pairs bit for bit, "
        f"no kernel launched; {times[R1][0]:.3f} / {times[R2][0]:.3f} ms "
        f"(radix {times[R1][1]:.3f} / {times[R2][1]:.3f} ms)")
    del keys, pay, out, ok, ov, wk, wv

    keys2 = rand_bits(N_PAIRS, torch.uint64, gen)
    pay2 = rand_bits(N_PAIRS, torch.uint32, gen)
    rt.sort_pairs(keys2, pay2)
    trace_dir = os.path.join(HERE, "build", "chip_smoke_trace")
    with profiling.trace(trace_dir) as d:
        rt.sort_pairs(keys2, pay2)
        torch.cuda.synchronize()
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    shutil.rmtree(trace_dir)
    names = [e.get("name") for e in events]
    expect("sort_pairs" in names, "a trace of config 2 holds no "
           "'sort_pairs' range")
    n_kernels = sum(1 for e in events if e.get("cat") == "kernel")
    log(f"[profiling] a trace of config 2 (utils/profiling.py::trace) holds "
        f"the 'sort_pairs' range; {n_kernels} kernel events on the card")
    del keys2, pay2
    torch.cuda.empty_cache()
    return times


# ---------------------------------------------------------------------------
# compat: the CUB- and thrust-shaped surfaces
# ---------------------------------------------------------------------------

N_COMPAT = 1 << 26         # the compat operators' inputs
N_COMPAT_SEGMENTS = 1 << 16
COMPAT_TOP_K = 1024
C_PAIRS = "C1 DeviceRadixSort.SortPairs 2^28 u64+u32"
C_DESC = "C2 DeviceRadixSort.SortKeysDescending bits [4, 20) 2^24 u32"
C_SEG = "C3 DeviceSegmentedRadixSort.SortPairs 2^24, 4096 segments"
C_MSORT = "C4 DeviceMergeSort.StableSortPairs struct comparator 2^24"
C_TSORT = "C5 thrust.stable_sort_by_key 2^26 u32, (N, 3) f32 values"
C_3WAY = "C6 DevicePartition.ThreeWay 2^26 int32"
C_UBK = "C7 DeviceSelect.UniqueByKey 2^26"
C_RLE = "C8 DeviceRunLengthEncode.Encode 2^26"
C_RBK = "C9 DeviceReduce.ReduceByKey sum 2^26"
C_XSCAN = "C10 DeviceScan.ExclusiveScan torch.maximum 2^26 int32"
C_SRED = "C11 DeviceSegmentedReduce.Sum 2^26, 2^16 segments"
C_MHIST = "C12 DeviceHistogram.MultiHistogramEven 4 channels, 2^26 samples"
C_TOPK = "C13 DeviceTopK.MaxPairs k=1024 2^26 u32"
C_LB = "C14 thrust.lower_bound 2^24 queries into 2^26 sorted u32"


def expect_same(name: str, pairs) -> None:
    """Every (got, want) pair bit for bit (max_abs_err of the bits)."""
    for i, (g, w) in enumerate(pairs):
        e = max_abs_err(g, w)
        expect(e == 0, f"{name}: output {i} differs from the oracle "
               f"(max err {e})")


def by_flag_order(keep: torch.Tensor) -> torch.Tensor:
    """The rows with keep first, then the rest, each in input order (a
    stable compaction's permutation)."""
    return torch.sort((~keep).to(torch.int8), stable=True).indices


def sorted_runs(n: int, n_keys: int, gen) -> torch.Tensor:
    """n sorted int32 keys drawn from [0, n_keys): runs of equal keys."""
    k = torch.randint(0, n_keys, (n,), device="cuda", generator=gen,
                      dtype=torch.int32)
    return torch.sort(k).values


def phase_compat(gen: torch.Generator, launches: dict) -> dict:
    """The compat surfaces' paths C1-C14 once each, counted, bit for bit
    against plain-torch oracles on the card, then each timed (CUDA-event
    medians). Returns path -> ms."""
    import cuda.radixsort_tpu_torch as rt
    from cuda.radixsort_tpu_torch import cub_compat as cub
    from cuda.radixsort_tpu_torch import thrust_compat as thrust
    from cuda.radixsort_tpu_torch.utils.profiling import cuda_time_ms

    t0 = time.perf_counter()
    times = {}

    def path(name, fn, needs, oracle, runs=RUNS):
        out = run_counted(name, fn, needs, launches)
        expect_same(name, oracle(out))
        del out
        times[name] = cuda_time_ms(fn, runs=runs, warmup=1)
        log(f"[compat] {name}: == plain torch bit for bit; "
            f"{times[name]:.3f} ms")
        torch.cuda.empty_cache()

    # C1: config 2's input through the CUB entry point, beside rt.sort_pairs
    keys2 = rand_bits(N_PAIRS, torch.uint64, gen)
    pay2 = rand_bits(N_PAIRS, torch.uint32, gen)

    def c1_oracle(out):
        k, v = out
        check_sort(C_PAIRS, k, keys2, got_vals=[v], vals=[pay2])
        rk, rv = rt.sort_pairs(keys2, pay2)
        return [(k, rk), (v, rv)]

    path(C_PAIRS, lambda: cub.DeviceRadixSort.SortPairs(keys2, pay2, N_PAIRS),
         SORT_KERNELS, c1_oracle)
    times[C_PAIRS + " (rt.sort_pairs)"] = cuda_time_ms(
        lambda: rt.sort_pairs(keys2, pay2), runs=RUNS, warmup=1)
    log(f"[compat] {C_PAIRS}: rt.sort_pairs on the same input "
        f"{times[C_PAIRS + ' (rt.sort_pairs)']:.3f} ms")
    del keys2, pay2
    torch.cuda.empty_cache()

    keys = rand_bits(N_KEYS, torch.uint32, gen)
    path(C_DESC, lambda: cub.DeviceRadixSort.SortKeysDescending(
        keys, N_KEYS, 4, 20), SORT_KERNELS,
        lambda out: [(out, sv(keys)[torch.sort(
            (u32_to_i64(keys) >> 4) & 0xFFFF, descending=True,
            stable=True).indices])])

    seg_keys = rand_bits(N_KEYS, torch.uint32, gen)
    idx = torch.arange(N_KEYS, dtype=torch.int32, device="cuda")
    offsets = ragged_offsets(N_KEYS, N_SEGMENTS, gen)

    def c3_oracle(out):
        rows = torch.arange(N_KEYS, device="cuda")
        seg = torch.searchsorted(offsets[1:-1].to(torch.int64), rows,
                                 right=True)
        order = torch.sort((seg << 32) | u32_to_i64(seg_keys),
                           stable=True).indices
        return [(out[0], sv(seg_keys)[order]), (out[1], idx[order])]

    path(C_SEG, lambda: cub.DeviceSegmentedRadixSort.SortPairs(
        seg_keys, idx, N_KEYS, N_SEGMENTS, offsets[:-1], offsets[1:]),
        RADIX_OPERATOR, c3_oracle)
    del keys, seg_keys, offsets

    rec = {"score": torch.randint(0, 1000, (N_KEYS,), device="cuda",
                                  generator=gen).to(torch.float32),
           "id": torch.randint(0, 1 << 20, (N_KEYS,), device="cuda",
                               generator=gen, dtype=torch.int32)}

    def by_score(a, b):  # score descending, then id ascending
        return (a["score"] > b["score"]) | ((a["score"] == b["score"])
                                            & (a["id"] < b["id"]))

    def c4_oracle(out):
        o1 = torch.sort(rec["id"], stable=True).indices
        o2 = torch.sort(rec["score"][o1], descending=True,
                        stable=True).indices
        order = o1[o2]
        return [(out[0]["score"], rec["score"][order]),
                (out[0]["id"], rec["id"][order]), (out[1], idx[order])]

    path(C_MSORT, lambda: cub.DeviceMergeSort.StableSortPairs(
        rec, idx, N_KEYS, by_score), (), c4_oracle, runs=2)
    del rec, idx
    torch.cuda.empty_cache()

    keys = rand_bits(N_COMPAT, torch.uint32, gen)
    pts = torch.randn(N_COMPAT, 3, device="cuda", generator=gen)

    def c5_oracle(out):
        order = torch.sort(u32_to_i64(keys), stable=True).indices
        return [(out[0], sv(keys)[order]), (out[1], pts[order])]

    path(C_TSORT, lambda: thrust.stable_sort_by_key(keys, pts), SORT_KERNELS,
         c5_oracle)
    del pts

    x = torch.randint(0, 1 << 20, (N_COMPAT,), device="cuda", generator=gen,
                      dtype=torch.int32)

    def c6_oracle(out):
        first = x % 3 == 0
        second = ~first & (x < (1 << 19))
        part = torch.where(first, 0, torch.where(second, 1, 2))
        o = x[torch.sort(part, stable=True).indices]
        n1, n2 = int(first.sum()), int(second.sum())
        counts = torch.tensor([n1, n2], dtype=torch.int32, device="cuda")
        return [(out[0], o), (out[1], torch.roll(o, -n1)),
                (out[2], torch.roll(o, -(n1 + n2))), (out[3], counts)]

    path(C_3WAY, lambda: cub.DevicePartition.ThreeWay(
        x, lambda a: a % 3 == 0, lambda a: a < (1 << 19), N_COMPAT),
        SORT_KERNELS, c6_oracle)

    rk = sorted_runs(N_COMPAT, 1 << 22, gen)
    rv = x
    starts = segment_starts([rk])
    ends = torch.cat([starts[1:], starts[:1]])  # a run ends where one starts
    n_runs = torch.tensor(int(starts.sum()), dtype=torch.int32, device="cuda")
    keep = by_flag_order(starts)
    path(C_UBK, lambda: cub.DeviceSelect.UniqueByKey(rk, rv, N_COMPAT),
         SORT_KERNELS, lambda out: [(out[0], rk[keep]), (out[1], rv[keep]),
                                    (out[2], n_runs)])

    def c8_oracle(out):
        _, counts = torch.unique_consecutive(rk, return_counts=True)
        lengths = torch.zeros(N_COMPAT, dtype=torch.int32, device="cuda")
        lengths[:counts.numel()] = counts.to(torch.int32)
        return [(out[0], rk[keep]), (out[1], lengths), (out[2], n_runs)]

    path(C_RLE, lambda: cub.DeviceRunLengthEncode.Encode(rk, N_COMPAT),
         SORT_KERNELS, c8_oracle)

    def c9_oracle(out):
        scanned = wrap_i32(seg_cumsum(rv.to(torch.int64), start_fill(starts)))
        at_ends = by_flag_order(ends)
        return [(out[0], rk[at_ends]), (out[1], scanned[at_ends]),
                (out[2], n_runs)]

    path(C_RBK, lambda: cub.DeviceReduce.ReduceByKey(rk, rv, None, N_COMPAT),
         RADIX_OPERATOR, c9_oracle)
    del rk, starts, ends, keep

    xs = rand_bits(N_COMPAT, torch.int32, gen)

    def c10_oracle(out):
        init = torch.full((1,), -5, dtype=torch.int32, device="cuda")
        inc = torch.cummax(xs, 0).values
        return [(out, torch.cat([init, torch.maximum(init, inc[:-1])]))]

    path(C_XSCAN, lambda: cub.DeviceScan.ExclusiveScan(xs, torch.maximum, -5,
                                                       N_COMPAT), (),
         c10_oracle)

    soffs = ragged_offsets(N_COMPAT, N_COMPAT_SEGMENTS, gen)

    def c11_oracle(out):
        cs = torch.cat([torch.zeros(1, dtype=torch.int64, device="cuda"),
                        torch.cumsum(xs.to(torch.int64), 0)])
        return [(out, wrap_i32(cs[soffs[1:].long()] - cs[soffs[:-1].long()]))]

    path(C_SRED, lambda: cub.DeviceSegmentedReduce.Sum(
        xs, N_COMPAT_SEGMENTS, soffs), SORT_KERNELS, c11_oracle)
    del xs, soffs

    px = torch.randint(0, 256, (N_COMPAT // 4, 4), device="cuda",
                       generator=gen, dtype=torch.int32)
    levels = [129, 65, 129, 33]

    def c12_oracle(out):
        return [(h, torch.bincount(px[:, c] // (256 // (lv - 1)),
                                   minlength=lv - 1))
                for c, (h, lv) in enumerate(zip(out, levels))]

    path(C_MHIST, lambda: cub.DeviceHistogram.MultiHistogramEven(
        px, levels, 0, 256, N_COMPAT // 4), ("digit_histograms",), c12_oracle)
    del px

    pay = torch.arange(N_COMPAT, dtype=torch.int32, device="cuda")

    def c13_oracle(out):
        o = torch.sort(u32_to_i64(keys), descending=True,
                       stable=True).indices[:COMPAT_TOP_K]
        return [(out[0], sv(keys)[o]), (out[1], pay[o])]

    path(C_TOPK, lambda: cub.DeviceTopK.MaxPairs(keys, pay, COMPAT_TOP_K,
                                                 N_COMPAT), RADIX_OPERATOR,
         c13_oracle)
    del pay, keys, x

    s = sorted_u32(N_COMPAT, gen)
    q = rand_bits(N_KEYS, torch.uint32, gen)
    path(C_LB, lambda: thrust.lower_bound(s, q), (),
         lambda out: [(out, torch.searchsorted(u32_to_i64(s), u32_to_i64(q))
                       .to(torch.int32))])
    del s, q
    torch.cuda.empty_cache()
    log(f"[compat] phase wall time {time.perf_counter() - t0:.1f} s")
    return times


# ---------------------------------------------------------------------------
# external: the out-of-core sorts and join (host arrays larger than a chunk)
# ---------------------------------------------------------------------------

N_EXT = 1 << 30          # BASELINE.json: "sorting 1B uint32"
N_EXT_PAIRS = 1 << 28
N_EXT_BUILD = 100_000_000  # BASELINE.json's join: 1B probe x 100M build
N_EXT_MPROBE, N_EXT_MBUILD = 1 << 26, 1 << 22
EXT_HOST_RAM = 48 << 30  # host RAM the 2^30 legs need, with room
ODD = 2654435761         # odd: i * ODD mod 2^32 is a bijection


def host_ram_bytes() -> tuple[int, int]:
    """(MemTotal, MemAvailable) of the host, from /proc/meminfo."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":")
            info[k] = int(v.split()[0]) * 1024
    return info["MemTotal"], info["MemAvailable"]


def peak_rss_gib() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def to_card(a) -> torch.Tensor:
    """A host u32 (or int32) array on the card as int32 bits."""
    import numpy as np

    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).cuda()


def unique_u32(n: int, offset: int) -> torch.Tensor:
    """n distinct u32 keys on the card (a bijection of 0..n-1), int32 bits."""
    i = torch.arange(n, dtype=torch.int64, device="cuda")
    return wrap_i32((i * ODD + offset) & 0xFFFFFFFF)


def log_split(name: str, wall: float, t: dict) -> None:
    log(f"[external] {name}: {wall:.3f} s wall; host-to-card copies "
        f"{t['h2d']:.3f} s, card {t['device']:.3f} s, card-to-host copies "
        f"{t['d2h']:.3f} s, host merge {t['merge']:.3f} s; peak RSS "
        f"{peak_rss_gib():.2f} GiB")


def phase_external(gen: torch.Generator, launches: dict) -> dict:
    """The out-of-core paths E1-E6, each counted and checked against a
    plain-torch oracle on the card. Returns name -> {wall and the split}."""
    import numpy as np

    import cuda.radixsort_tpu_torch as rt
    from cuda.radixsort_tpu_torch.ops import external
    from cuda.radixsort_tpu_torch.utils import native

    t_phase = time.perf_counter()
    total, avail = host_ram_bytes()
    n_ext = N_EXT if avail >= EXT_HOST_RAM else N_EXT // 2
    log(f"[external] host RAM {total / 2**30:.1f} GiB ({avail / 2**30:.1f} "
        f"GiB available), {os.cpu_count()} cores")
    if n_ext != N_EXT:
        log(f"[external] reduced: the 2^30 legs run at 2^29 (host RAM "
            f"available {avail / 2**30:.1f} GiB < {EXT_HOST_RAM >> 30} GiB)")
    lg = n_ext.bit_length() - 1
    sign = -(1 << 31)
    out: dict = {}

    def leg(name, fn, needs):
        t = {}
        t0 = time.perf_counter()
        res = run_counted(name, lambda: fn(t), needs, launches)
        wall = time.perf_counter() - t0
        log_split(name, wall, t)
        out[name] = dict(t, wall=wall)
        return res

    # E1: sort_external of 2^30 u32 keys in 2^27-row chunks: 8 runs merged
    e1 = f"E1 sort_external 2^{lg} u32, chunk 2^27"
    keys = native.random_u32(n_ext, SEED)
    got = leg(e1, lambda t: rt.sort_external(keys, chunk=1 << 27, timings=t),
              SORT_KERNELS)
    kd = to_card(keys)
    want = torch.sort(kd ^ sign).values ^ sign
    expect(torch.equal(to_card(got), want), f"{e1}: differs from torch.sort "
           f"of the same keys on the card")
    log(f"[external] {e1} == torch.sort on the card bit for bit")
    del keys, got, kd, want
    torch.cuda.empty_cache()

    # E2: pairs, the payload the row index, so stability shows
    e2 = "E2 sort_external_pairs 2^28 u32 + row index, chunk 2^26"
    pk = native.random_u32(N_EXT_PAIRS, SEED + 1)
    pv = np.arange(N_EXT_PAIRS, dtype=np.int32)
    gk, gv = leg(e2, lambda t: rt.sort_external_pairs(pk, pv, chunk=1 << 26,
                                                      timings=t),
                 SORT_KERNELS)
    order = torch.sort(u32_to_i64(to_card(pk).view(torch.uint32)),
                       stable=True).indices
    want_k = to_card(pk)[order]
    expect(torch.equal(to_card(gk), want_k)
           and torch.equal(to_card(gv), order.to(torch.int32)),
           f"{e2}: differs from a stable torch.sort on the card")
    log(f"[external] {e2} == stable torch.sort on the card bit for bit")
    del order
    torch.cuda.empty_cache()

    # E3, E4: the disk-spill forms at 2^28 under build/, files removed
    tdir = os.path.join(HERE, "build", "chip_smoke_external")
    os.makedirs(tdir, exist_ok=True)
    paths = [os.path.join(tdir, f) for f in ("k.u32", "v.u32", "ok.u32",
                                             "ov.u32")]
    try:
        pk.tofile(paths[0])
        pv.tofile(paths[1])
        e3 = "E3 sort_external_file 2^28 u32, chunk 2^27"
        n3 = leg(e3, lambda t: external.sort_external_file(
            paths[0], paths[2], tmpdir=tdir, timings=t), SORT_KERNELS)
        expect(n3 == N_EXT_PAIRS and np.array_equal(
            np.fromfile(paths[2], np.uint32), gk), f"{e3}: differs from E2's "
            f"checked keys")
        e4 = "E4 sort_external_pairs_file 2^28 u32 + row index, chunk 2^26"
        n4 = leg(e4, lambda t: external.sort_external_pairs_file(
            *paths, tmpdir=tdir, timings=t), SORT_KERNELS)
        expect(n4 == N_EXT_PAIRS
               and np.array_equal(np.fromfile(paths[2], np.uint32), gk)
               and np.array_equal(np.fromfile(paths[3], np.int32), gv),
               f"{e4}: differs from E2's checked pairs")
        left = sorted(set(os.listdir(tdir)) - {os.path.basename(p)
                                               for p in paths})
        expect(not left, f"run files left behind: {left}")
        log(f"[external] {e3}, {e4} == E2's checked output bit for bit; no "
            f"run file left")
    finally:
        for p in paths:
            if os.path.exists(p):
                os.remove(p)
        os.rmdir(tdir)
    del pk, pv, gk, gv, want_k

    # E5: BASELINE.json's join shape, count and checksum only
    e5 = f"E5 join_external 2^{lg} probe x 10^8 build, materialize=False"
    bk = unique_u32(N_EXT_BUILD, 12345)
    bv = rand_bits(N_EXT_BUILD, torch.int32, gen)
    hit = bk[torch.randint(0, N_EXT_BUILD, (n_ext // 2,), device="cuda",
                           generator=gen)]
    probe = torch.cat([hit, rand_bits(n_ext - n_ext // 2, torch.int32, gen)])
    probe = probe[torch.randperm(n_ext, device="cuda", generator=gen)]
    host_probe = probe.cpu().numpy().view(np.uint32)
    host_bk = bk.cpu().numpy().view(np.uint32)
    host_bv = bv.cpu().numpy()
    del probe, hit
    torch.cuda.empty_cache()
    count, checksum = leg(e5, lambda t: external.join_external(
        host_bk, host_bv, host_probe, materialize=False, timings=t),
        RADIX_OPERATOR)
    bs = torch.sort(u32_to_i64(bk), stable=True)
    want_count, want_sum = 0, 0
    for lo in range(0, n_ext, 1 << 27):
        p64 = u32_to_i64(to_card(host_probe[lo: lo + (1 << 27)])
                         .view(torch.uint32))
        pos = torch.searchsorted(bs.values, p64).clamp_max(N_EXT_BUILD - 1)
        m = bs.values[pos] == p64
        ksum = int(torch.where(m, p64, 0).sum()) & 0xFFFFFFFF
        vsum = int(torch.where(m, bv[bs.indices[pos]].to(torch.int64),
                               0).sum()) & 0xFFFFFFFF
        want_count += int(m.sum())
        want_sum ^= ksum ^ vsum
    expect(count == want_count and int(checksum) == want_sum,
           f"{e5}: (count, checksum) ({count}, {int(checksum)}) != the "
           f"searchsorted oracle's ({want_count}, {want_sum})")
    log(f"[external] {e5}: count {count} and checksum {int(checksum)} == the "
        f"searchsorted oracle on the card")
    del bk, bv, bs, host_probe, host_bk, host_bv
    torch.cuda.empty_cache()

    # E6: the materialized join, row for row
    e6 = "E6 join_external 2^26 probe x 2^22 build, materialize=True"
    bk = unique_u32(N_EXT_MBUILD, 777)
    bv = rand_bits(N_EXT_MBUILD, torch.int32, gen)
    hit = bk[torch.randint(0, N_EXT_MBUILD, (N_EXT_MPROBE // 2,),
                           device="cuda", generator=gen)]
    probe = torch.cat([hit, rand_bits(N_EXT_MPROBE // 2, torch.int32, gen)])
    probe = probe[torch.randperm(N_EXT_MPROBE, device="cuda", generator=gen)]
    chunk = 1 << 27  # the default: one slice
    gk, gv, gi, gc = leg(e6, lambda t: external.join_external(
        bk.cpu().numpy().view(np.uint32), bv.cpu().numpy(),
        probe.cpu().numpy().view(np.uint32), chunk=chunk, timings=t),
        RADIX_OPERATOR)
    slices = [oracle_fk_join(bk.view(torch.uint32), bv,
                             probe[lo: lo + chunk].view(torch.uint32))
              for lo in range(0, N_EXT_MPROBE, chunk)]
    wk, wv = (torch.cat([s[i] for s in slices]) for i in (0, 1))
    wi = torch.cat([s[2] + lo for s, lo in zip(slices, range(
        0, N_EXT_MPROBE, chunk))])
    wc = sum(s[3] for s in slices)
    expect(gc == wc and torch.equal(to_card(gk), wk)
           and torch.equal(to_card(gv), wv) and torch.equal(to_card(gi), wi),
           f"{e6}: differs from the torch.sort + searchsorted oracle")
    log(f"[external] {e6}: {gc} rows == the oracle row for row")
    del bk, bv, hit, probe, gk, gv, gi, wk, wv, wi, slices
    torch.cuda.empty_cache()
    log(f"[external] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# distributed (phase 6d): the parallel/ layer through torch.distributed
# ---------------------------------------------------------------------------

N_D_SORT = 1 << 28     # D1: lanes above 4 MB, so the default 2 rounds
N_D_PAIRS = 1 << 27    # D2
N_D_SCAN = 1 << 26     # D5
N_D_SELECT = 1 << 26   # D6
N_GLOO = 1 << 24       # rows of each path of the 4-rank gloo leg
N_GLOO_BUILD = 1 << 21  # above the 2^20 broadcast threshold: hash joins
GLOO_RANKS = 4
GLOO_TIMEOUT_S = 300
D1 = "D1 sort_distributed 2^28 u32"
D2 = "D2 sort_pairs_distributed 2^27 u32+u32"
D3 = "D3 groupby_distributed sum, count 2^26"
D4 = "D4 join_distributed 2^27 x 2^24, hash route"
D4B = "D4 join_distributed 2^27 x 2^24, broadcast route"
D5 = "D5 scan_by_key_distributed 2^26"
D6 = "D6 kth_value, top_k 1000, distinct, groupby_quantile 2^26"
D7 = "D7 filter_sort_join_distributed 2^27 x 2^24"
D7Q = "D7 Query.run(mesh=) README plan 2^26 x 2^22"
DIST_PATHS = (D1, D2, D3, D4, D4B, D5, D6, D7, D7Q)


def nccl_world():
    """A one-rank NCCL world in this process (a FileStore under build/):
    one card holds one NCCL rank. Returns the store's path: the store may
    delete its file itself once the process group is destroyed."""
    import torch.distributed as dist

    path = os.path.join(HERE, "build", "chip_smoke_dist_store")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    dist.init_process_group("nccl", store=dist.FileStore(path, 1), rank=0,
                            world_size=1)
    return path


def oracle_sorted_bits(keys: torch.Tensor) -> torch.Tensor:
    """u32 keys sorted, as int32 bits."""
    return torch.sort(u32_to_i64(keys)).values.to(torch.int32)


def oracle_scan_by_key(keys, vals):
    """int32 running sums within runs of equal consecutive keys (wrapping)."""
    heads = segment_starts([keys.view(torch.int32)])
    return wrap_i32(seg_cumsum(vals.to(torch.int64), start_fill(heads)))


def oracle_top_k(keys, k):
    """The k largest u32 keys (ties to the smaller row) and their rows."""
    order = torch.sort(-u32_to_i64(keys), stable=True).indices[:k]
    return keys.view(torch.int32)[order], order.to(torch.int32)


def oracle_group_quantiles(keys, vals, qs):
    """Per-group quantiles of u32 values by linear interpolation between
    the floor- and ceil-rank values (float32 rank and lerp arithmetic, as
    the operators compute them): (group keys int64, [column per q])."""
    key = (u32_to_i64(keys) << 32) | u32_to_i64(vals)
    s = torch.sort(key).values
    sk, sv = s >> 32, s & 0xFFFFFFFF
    uniq, counts = torch.unique_consecutive(sk, return_counts=True)
    start = torch.cumsum(counts, 0) - counts
    cols = []
    for q in qs:
        idx_f = (counts - 1).to(torch.float32) * torch.tensor(
            q, dtype=torch.float32, device=keys.device)
        lo = torch.floor(idx_f).to(torch.int64)
        hi = torch.ceil(idx_f).to(torch.int64)
        f = idx_f - lo.to(torch.float32)
        vlo = sv[start + lo].to(torch.float32)
        vhi = sv[start + hi].to(torch.float32)
        cols.append(vlo * (1 - f) + vhi * f)
    return uniq, cols


def expect_close(name: str, what: str, got, want) -> float:
    diff = (got - want).abs()
    expect(bool((diff <= MEAN_TOL * want.abs()).all()),
           f"{name}: {what} off by more than {MEAN_TOL} relative")
    return float((diff / want.abs().clamp_min(1e-30)).max())


def dist_paths(gen: torch.Generator, mesh) -> dict:
    """name -> (distributed call, its check, the single-GPU call, rows,
    kernels that must launch) of D1-D7 on a one-rank mesh."""
    import cuda.radixsort_tpu_torch as rt
    from cuda.radixsort_tpu_torch.models import flagships
    from cuda.radixsort_tpu_torch.parallel import dscan, dselect, dsort, shuffle
    from cuda.radixsort_tpu_torch.pipeline import query

    paths = {}

    keys1 = rand_bits(N_D_SORT, torch.uint32, gen)

    def check_d1(out):
        o, counts, st = out
        # two rounds of one 2^27-row lane each: the output is 2^28 rows
        expect(counts.tolist() == [N_D_SORT] and o.numel() == N_D_SORT
               and int(st.rows_in.sum()) == N_D_SORT,
               f"{D1}: counts {counts.tolist()}, {o.numel()} rows")
        expect_equal(D1, "keys", o.view(torch.int32), oracle_sorted_bits(keys1))

    paths[D1] = (lambda: dsort.sort_distributed(keys1, mesh=mesh), check_d1,
                 lambda: rt.sort(keys1), N_D_SORT, SORT_KERNELS)

    keys2 = (rand_bits(N_D_PAIRS, torch.uint32, gen).view(torch.int32)
             & 0xFFFFFF).view(torch.uint32)  # 2^24 values: ties
    vals2 = rand_bits(N_D_PAIRS, torch.uint32, gen)

    def check_d2(out):
        ok, ov, counts, _ = out
        expect(counts.tolist() == [N_D_PAIRS], f"{D2}: {counts.tolist()}")
        order = oracle_order(keys2)
        expect_equal(D2, "keys", ok[:N_D_PAIRS].view(torch.int32),
                     keys2.view(torch.int32)[order])
        expect_equal(D2, "values (stable)", ov[:N_D_PAIRS].view(torch.int32),
                     vals2.view(torch.int32)[order])

    paths[D2] = (lambda: dsort.sort_pairs_distributed(keys2, vals2, mesh=mesh),
                 check_d2, lambda: rt.sort_pairs(keys2, vals2), N_D_PAIRS,
                 SORT_KERNELS)

    _, (gk, gv) = flagships.groupby_zipf(N_GROUP, generator=gen, device="cuda")

    def check_d3(out):
        (k, s, c, _), (k2, n2, c2, _) = out
        wk, ws, wc = oracle_groupby(gk, gv)
        g = wk.numel()
        expect(c.tolist() == [g] and c2.tolist() == [g],
               f"{D3}: {c.tolist()} / {c2.tolist()} groups, oracle {g}")
        for what, got, want in (("sum keys", k[:g], wk), ("sums", s[:g], ws),
                                ("count keys", k2[:g], wk),
                                ("counts", n2[:g], wc)):
            expect_equal(D3, what, got.view(torch.int32), want)

    paths[D3] = (lambda: (shuffle.groupby_distributed(gk, gv, mesh=mesh),
                          shuffle.groupby_distributed(gk, gv, mesh=mesh,
                                                      agg="count")),
                 check_d3, lambda: (rt.groupby(gk, gv),
                                    rt.groupby(gk, agg="count")),
                 N_GROUP, RADIX_OPERATOR)

    fk_fn, (bk, bv, pk) = flagships.fk_join(N_PROBE, N_BUILD, generator=gen,
                                            device="cuda")

    def check_fk_dist(name):
        def check(out):
            ok, ov, og, counts, _ = out
            wk, wv, wi, c, _ = oracle_fk_join(bk, bv, pk)
            expect(counts.tolist() == [c], f"{name}: {counts.tolist()}, {c}")
            for what, got, want in (("keys", ok[:c].view(torch.int32), wk),
                                    ("vals", ov[:c], wv),
                                    ("probe rows", og[:c], wi)):
                expect_equal(name, what, got, want)
        return check

    paths[D4] = (lambda: shuffle.join_distributed(bk, bv, pk, mesh=mesh),
                 check_fk_dist(D4), lambda: fk_fn(bk, bv, pk),
                 N_PROBE + N_BUILD, RADIX_OPERATOR)
    paths[D4B] = (lambda: shuffle.join_distributed(
        bk, bv, pk, mesh=mesh, broadcast_threshold=N_BUILD),
        check_fk_dist(D4B), lambda: fk_fn(bk, bv, pk), N_PROBE + N_BUILD,
        RADIX_OPERATOR)

    sk = torch.sort(torch.randint(0, 1 << 20, (N_D_SCAN,), device="cuda",
                                  generator=gen)).values.to(torch.int32)
    sk = sk.view(torch.uint32)
    sv_ = torch.randint(-1000, 1000, (N_D_SCAN,), dtype=torch.int32,
                        device="cuda", generator=gen)

    def check_d5(out):
        expect_equal(D5, "running sums", out, oracle_scan_by_key(sk, sv_))

    paths[D5] = (lambda: dscan.scan_by_key_distributed(sk, sv_, mesh=mesh),
                 check_d5, lambda: rt.scan_by_key(sk, sv_), N_D_SCAN,
                 ("segmented_scan",))

    xk = (rand_bits(N_D_SELECT, torch.uint32, gen).view(torch.int32)
          & 0xFFFFFF).view(torch.uint32)  # 2^24 values: duplicates
    qk = (xk.view(torch.int32) % 50).view(torch.uint32)
    qv = rand_bits(N_D_SELECT, torch.uint32, gen)
    qs = (0.25, 0.5, 0.75)
    k_mid = N_D_SELECT // 2

    def d6():
        return (dselect.kth_value_distributed(xk, k_mid, mesh=mesh),
                dselect.top_k_distributed(xk, TOP_K, mesh=mesh),
                dselect.distinct_distributed(xk, mesh=mesh),
                dselect.groupby_quantile_distributed(qk, qv, qs, mesh=mesh,
                                                     max_groups=64))

    def check_d6(out):
        kth, (tv, ti), (u, uc), (gq, qcols, ng) = out
        srt = oracle_sorted_bits(xk)
        expect(int(kth.view(torch.int32)) == int(srt[k_mid]),
               f"{D6}: kth_value {int(kth)}")
        wv, wi = oracle_top_k(xk, TOP_K)
        expect_equal(D6, "top_k values", tv.view(torch.int32), wv)
        expect_equal(D6, "top_k rows", ti, wi)
        uniq = torch.unique(u32_to_i64(xk))
        c = uniq.numel()
        expect(uc.tolist() == [c], f"{D6}: distinct {uc.tolist()}, {c}")
        expect_equal(D6, "distinct keys", u[:c].view(torch.int32),
                     uniq.to(torch.int32))
        wk, wcols = oracle_group_quantiles(qk, qv, qs)
        g = wk.numel()
        expect(int(ng) == g, f"{D6}: {int(ng)} groups, oracle {g}")
        expect_equal(D6, "quantile groups", gq[:g].view(torch.int32),
                     wk.to(torch.int32))
        rel = max(expect_close(D6, f"q{q}", col[:g], w)
                  for q, col, w in zip(qs, qcols, wcols))
        log(f"[dist] {D6}: quantiles within {rel} relative of the oracle")

    paths[D6] = (d6, check_d6, lambda: (
        rt.kth_value(xk, k_mid), rt.top_k(xk, TOP_K), rt.distinct(xk),
        rt.groupby_quantile(qk, qv, qs)), N_D_SELECT, SORT_KERNELS)

    fsj_fn, fsj_args = flagships.filter_sort_join_query(
        N_FSJ_PROBE, N_FSJ_BUILD, generator=gen, device="cuda")
    threshold = flagships.PROBE_VALUE_RANGE // 2

    def check_d7(out):
        k, pv, bv_, counts, st = out
        wk, wpv, wbv, c, n_filtered = oracle_fsj(*fsj_args, threshold)
        expect(counts.tolist() == [c] and int(st.rows_joined) == c
               and int(st.rows_after_filter) == n_filtered
               and int(st.rows_in) == N_FSJ_PROBE,
               f"{D7}: {counts.tolist()} / {tuple(int(s) for s in st)}")
        for what, got, want in (("keys", k[:c].view(torch.int32), wk),
                                ("probe values", pv[:c], wpv),
                                ("build values", bv_[:c], wbv)):
            expect_equal(D7, what, got, want)

    paths[D7] = (lambda: query.filter_sort_join_distributed(
        *fsj_args, threshold, mesh=mesh), check_d7,
        lambda: fsj_fn(*fsj_args), N_FSJ_PROBE + N_FSJ_BUILD, RADIX_OPERATOR)

    orders, parts = query_data(gen)
    paths[D7Q] = (lambda: readme_query(orders, parts).run(mesh=mesh),
                  lambda out: check_plan_path(P4, out, (orders, parts),
                                              oracle_readme),
                  lambda: readme_query(orders, parts).run(),
                  N_QUERY + N_QUERY_BUILD, RADIX_OPERATOR)
    return paths


def mesh_rank(rank: int, world: int, nccl: bool = False) -> dict:
    """One rank of a 4-rank leg (tests/torch_world.py starts it): D1, D3,
    D4 and D7's plan at 2^24 rows, over gloo with CUDA tensors of the one
    card, or over NCCL with one card a rank (``nccl``), which adds D2, D5,
    D6 and D7; each rank checks its block against the oracle, rank 0 the
    whole. The joins' builds are above the broadcast threshold, so both
    hash-exchange rows between the ranks."""
    torch.cuda.set_device(rank if nccl else 0)
    load_port()
    from cuda.radixsort_tpu_torch.parallel import comm, dsort, shuffle
    from cuda.radixsort_tpu_torch.table import Table

    mesh = dsort.make_mesh(world, device="cuda")
    ax = comm.Axis(mesh, "x")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 6)
    s = N_GLOO // world
    mine = slice(rank * s, (rank + 1) * s)
    res = {}

    def timed(name, fn):
        out = fn()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        res[name] = statistics.median(times)
        return out

    keys = rand_bits(N_GLOO, torch.uint32, gen)
    o, counts, _ = timed("D1", lambda: dsort.sort_distributed(
        keys[mine], mesh=mesh, n=N_GLOO))
    srt = oracle_sorted_bits(keys)
    off = int(counts[:rank].sum())
    c = int(counts[rank])
    expect(int(counts.sum()) == N_GLOO, f"gloo D1: counts {counts.tolist()}")
    expect_equal("gloo D1", f"rank {rank}'s keys", o[:c].view(torch.int32),
                 srt[off:off + c])
    blocks = comm.all_gather(o, ax)
    if rank == 0:
        whole = torch.cat([blocks[d][:int(counts[d])] for d in range(world)])
        expect_equal("gloo D1", "the reconstruction", whole.view(torch.int32),
                     srt)

    gk = (rand_bits(N_GLOO, torch.uint32, gen).view(torch.int32)
          & 0x3FF).view(torch.uint32)
    gv = torch.randint(-1000, 1000, (N_GLOO,), dtype=torch.int32,
                       device="cuda", generator=gen)
    k, v, counts, _ = timed("D3", lambda: shuffle.groupby_distributed(
        gk[mine], gv[mine], mesh=mesh, n=N_GLOO))
    wk, ws, _ = oracle_groupby(gk, gv)
    c = int(counts[rank])
    at = torch.searchsorted(u32_to_i64(wk.view(torch.uint32)),
                            u32_to_i64(k[:c]))
    expect(int(counts.sum()) == wk.numel()
           and bool((wk[at.clamp_max(wk.numel() - 1)]
                     == k[:c].view(torch.int32)).all()),
           f"gloo D3: rank {rank}'s groups are not the oracle's")
    expect_equal("gloo D3", f"rank {rank}'s sums", v[:c], ws[at])

    n_probe = N_GLOO - N_GLOO_BUILD
    bk = torch.arange(N_GLOO_BUILD, dtype=torch.int32,
                      device="cuda").view(torch.uint32)
    bv = torch.arange(N_GLOO_BUILD, dtype=torch.int32, device="cuda") * 3
    pk = (torch.randint(0, N_GLOO_BUILD, (n_probe,), dtype=torch.int32,
                        device="cuda", generator=gen)).view(torch.uint32)
    sp = n_probe // world
    ok, ov, og, counts, st = timed("D4", lambda: shuffle.join_distributed(
        bk, bv, pk[rank * sp:(rank + 1) * sp], mesh=mesh, n=n_probe))
    c = int(counts[rank])
    expect(int(counts.sum()) == n_probe, f"gloo D4: {counts.tolist()}")
    # the hash route sends this rank's build and probe rows to their owners
    expect(int(st.rows_in[rank]) == sp + N_GLOO_BUILD // world,
           f"gloo D4: rank {rank} sent {int(st.rows_in[rank])} rows: not "
           "the hash route")
    expect(bool((ov[:c] == ok[:c].view(torch.int32) * 3).all())
           and bool((pk.view(torch.int32)[og[:c].long()]
                     == ok[:c].view(torch.int32)).all()),
           f"gloo D4: rank {rank}'s matches are not the oracle's")

    orders = Table({"k": (torch.randint(0, 2 * N_GLOO_BUILD, (n_probe,),
                                        dtype=torch.int32, device="cuda",
                                        generator=gen)).view(torch.uint32),
                    "v": torch.randint(-1000, 1000, (n_probe,),
                                       dtype=torch.int32, device="cuda",
                                       generator=gen)})
    parts = Table({"k": (torch.arange(N_GLOO_BUILD, dtype=torch.int32,
                                      device="cuda") * 2).view(torch.uint32),
                   "price": bv})
    t, cnt, _ = timed("D7", lambda: readme_query(
        orders.shard(mesh), parts).run(mesh=mesh))
    wk, ws, c = oracle_readme(orders, parts)
    expect(int(cnt) == c, f"gloo D7: {int(cnt)} rows, oracle {c}")
    expect_equal("gloo D7", "keys", t["k"][:c], wk)
    expect_equal("gloo D7", "sums", t["v"][:c], ws)
    if nccl:
        nccl_paths(rank, world, mesh, gen, timed)
    return res


def nccl_paths(rank: int, world: int, mesh, gen: torch.Generator,
               timed) -> None:
    """D2, D5, D6 and D7 on the 4-rank NCCL leg, each rank's block against
    the oracle of the whole input (every rank makes the same input and
    passes its rows [rank*s, (rank+1)*s))."""
    from cuda.radixsort_tpu_torch.models import flagships
    from cuda.radixsort_tpu_torch.parallel import dscan, dselect, dsort
    from cuda.radixsort_tpu_torch.pipeline import query

    n = N_GLOO
    s = n // world
    mine = slice(rank * s, (rank + 1) * s)

    def block(counts):
        return int(counts[:rank].sum()), int(counts[rank])

    keys = (rand_bits(n, torch.uint32, gen).view(torch.int32)
            & 0xFFFFFF).view(torch.uint32)  # 2^24 values: ties
    vals = rand_bits(n, torch.uint32, gen)
    ok, ov, counts, _ = timed("D2", lambda: dsort.sort_pairs_distributed(
        keys[mine], vals[mine], mesh=mesh, n=n))
    off, c = block(counts)
    order = oracle_order(keys)[off:off + c]
    expect(int(counts.sum()) == n, f"nccl D2: counts {counts.tolist()}")
    expect_equal("nccl D2", "keys", ok[:c].view(torch.int32),
                 keys.view(torch.int32)[order])
    expect_equal("nccl D2", "values (stable)", ov[:c].view(torch.int32),
                 vals.view(torch.int32)[order])

    sk = torch.sort(torch.randint(0, 1 << 16, (n,), device="cuda",
                                  generator=gen)).values.to(torch.int32)
    sk = sk.view(torch.uint32)  # runs cross the shards
    sv_ = torch.randint(-1000, 1000, (n,), dtype=torch.int32, device="cuda",
                        generator=gen)
    got = timed("D5", lambda: dscan.scan_by_key_distributed(
        sk[mine], sv_[mine], mesh=mesh, n=n))
    expect_equal("nccl D5", "running sums", got,
                 oracle_scan_by_key(sk, sv_)[mine])

    xk = (rand_bits(n, torch.uint32, gen).view(torch.int32)
          & 0xFFFFFF).view(torch.uint32)
    qk = (xk.view(torch.int32) % 50).view(torch.uint32)
    qv = rand_bits(n, torch.uint32, gen)
    qs = (0.25, 0.5, 0.75)
    kth, (tv, ti), (u, uc), (gq, qcols, ng) = timed("D6", lambda: (
        dselect.kth_value_distributed(xk[mine], n // 2, mesh=mesh, n=n),
        dselect.top_k_distributed(xk[mine], TOP_K, mesh=mesh, n=n),
        dselect.distinct_distributed(xk[mine], mesh=mesh, n=n),
        dselect.groupby_quantile_distributed(qk[mine], qv[mine], qs,
                                             mesh=mesh, max_groups=64, n=n)))
    srt = oracle_sorted_bits(xk)
    expect(int(kth.view(torch.int32)) == int(srt[n // 2]),
           f"nccl D6: kth_value {int(kth)}")
    wv, wi = oracle_top_k(xk, TOP_K)
    expect_equal("nccl D6", "top_k values", tv.view(torch.int32), wv)
    expect_equal("nccl D6", "top_k rows", ti, wi)
    uniq = torch.unique(u32_to_i64(xk)).to(torch.int32)
    off, c = block(uc)
    expect(int(uc.sum()) == uniq.numel(), f"nccl D6: distinct {uc.tolist()}")
    expect_equal("nccl D6", "distinct keys", u[:c].view(torch.int32),
                 uniq[off:off + c])
    wk, wcols = oracle_group_quantiles(qk, qv, qs)
    g = wk.numel()
    expect(int(ng) == g, f"nccl D6: {int(ng)} groups, oracle {g}")
    expect_equal("nccl D6", "quantile groups", gq[:g].view(torch.int32),
                 wk.to(torch.int32))
    for q, col, w in zip(qs, qcols, wcols):
        expect_close("nccl D6", f"q{q}", col[:g], w)

    # the build is broadcast: each rank joins its own probe rows
    _, (pk, pv, bk, bv) = flagships.filter_sort_join_query(
        n, N_GLOO_BUILD // 2, generator=gen, device="cuda")
    threshold = flagships.PROBE_VALUE_RANGE // 2
    k, jpv, jbv, counts, _ = timed("D7 fsj", lambda: (
        query.filter_sort_join_distributed(
            pk[mine], pv[mine], bk, bv, threshold, mesh=mesh,
            join_strategy="broadcast")))
    wk, wpv, wbv, c, _ = oracle_fsj(pk[mine], pv[mine], bk, bv, threshold)
    expect(int(counts[rank]) == c, f"nccl D7: {counts.tolist()}, {c}")
    for what, got, want in (("keys", k[:c].view(torch.int32), wk),
                            ("probe values", jpv[:c], wpv),
                            ("build values", jbv[:c], wbv)):
        expect_equal("nccl D7", what, got, want)


def phase_distributed(gen: torch.Generator, launches: dict) -> dict:
    """D1-D7 through the public distributed entry points on a one-rank NCCL
    mesh, each counted, checked and timed beside its single-GPU call; then
    the 4-rank gloo leg on the same card. Returns the times."""
    import torch.distributed as dist

    from cuda.radixsort_tpu_torch.parallel import dsort
    from cuda.radixsort_tpu_torch.utils.profiling import cuda_time_ms

    t_phase = time.perf_counter()
    store = nccl_world()
    out_ms = {}
    try:
        mesh = dsort.make_mesh(1, device="cuda")
        paths = dist_paths(gen, mesh)
        for name in DIST_PATHS:
            fn, check, single, rows, needs = paths.pop(name)
            check(run_counted(name, fn, needs, launches))
            ms = cuda_time_ms(fn, runs=3, warmup=1)
            single_ms = cuda_time_ms(single, runs=3, warmup=1)
            out_ms[name] = {"ms": ms, "single_gpu_ms": single_ms,
                            "rows": rows}
            log(f"[dist] {name}: == oracle; {ms:.3f} ms = "
                f"{rows / ms * 1e3:.4g} rows/s, single-GPU call "
                f"{single_ms:.3f} ms (NCCL, 1 rank)")
            del fn, check, single
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "torch_world", os.path.join(HERE, "tests", "torch_world.py"))
    world = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(world)
    ranks = world.run_world(f"{os.path.abspath(__file__)}:mesh_rank",
                            GLOO_RANKS, backend="gloo",
                            timeout=GLOO_TIMEOUT_S, threads=0)
    gloo = {p: statistics.median(r[p] for r in ranks) for p in ranks[0]}
    log(f"[dist] 4 ranks over gloo with CUDA tensors, {N_GLOO} rows a path: "
        "D1 sort, D3 group-by, D4 join (hash), D7 README plan (hash join) "
        "== oracle "
        "on every rank; gloo through host memory, median of the ranks' "
        "medians: " + ", ".join(f"{p} {ms:.1f} ms" for p, ms in gloo.items())
        + f" (the leg's wall time {time.perf_counter() - t0:.1f} s)")
    out_ms["gloo_4_ranks_ms"] = gloo
    if torch.cuda.device_count() < GLOO_RANKS:
        log(f"[dist] 4 ranks over NCCL: not run, torch sees "
            f"{torch.cuda.device_count()} card(s)")
    else:
        t0 = time.perf_counter()
        ranks = world.run_world(f"{os.path.abspath(__file__)}:mesh_rank",
                                GLOO_RANKS, backend="nccl",
                                timeout=GLOO_TIMEOUT_S, threads=0,
                                args=(True,))
        nccl = {p: statistics.median(r[p] for r in ranks) for p in ranks[0]}
        log(f"[dist] 4 ranks over NCCL, one card a rank, {N_GLOO} rows a "
            "path: D1-D7 (D4 and D7's README plan by the hash route, D7's "
            "filter_sort_join by the broadcast route) == oracle on every "
            "rank; median of the ranks' "
            "medians: " + ", ".join(f"{p} {ms:.2f} ms"
                                   for p, ms in nccl.items())
            + f" (the leg's wall time {time.perf_counter() - t0:.1f} s)")
        out_ms["nccl_4_ranks_ms"] = nccl
    log(f"[dist] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out_ms


def phase_times(gen: torch.Generator) -> dict:
    import cuda.radixsort_tpu_torch as rt
    from cuda.radixsort_tpu_torch import twiddle
    from cuda.radixsort_tpu_torch.kernels import bitonic as bk
    from cuda.radixsort_tpu_torch.kernels import histogram as hist
    from cuda.radixsort_tpu_torch.kernels import scan as kscan
    from cuda.radixsort_tpu_torch.kernels import stage
    from cuda.radixsort_tpu_torch.utils.profiling import (cuda_time_ms,
                                                          device_time_ms)

    t = {}

    def kernel(name, fn):
        """t[name_ms]: the card's time per call (batches queued ahead, so the
        host's launch path does not show); t[name_call_ms]: one call as a
        caller waits for it, the host's launch path included."""
        t[f"{name}_ms"] = device_time_ms(fn, runs=RUNS)
        t[f"{name}_call_ms"] = cuda_time_ms(fn, runs=RUNS)

    keys1 = rand_bits(N_KEYS, torch.uint32, gen)
    t["sort_ms"] = cuda_time_ms(lambda: rt.sort(keys1), runs=RUNS)
    # baseline: torch.sort of an int32 view whose order is the u32 order
    k32 = keys1.view(torch.int32) ^ (-(1 << 31))
    t["torch_sort_ms"] = cuda_time_ms(lambda: torch.sort(k32, stable=True),
                                      runs=RUNS)

    kernel("hist", lambda: hist.digit_histograms(keys1, n_stages=4, width=8))
    # the library call: torch.bincount of one 8-bit digit (of the kernel's
    # four), the digit extracted beforehand and timed apart
    t["digit_extract_ms"] = cuda_time_ms(
        lambda: keys1.view(torch.int32) & 255, runs=RUNS)
    digit = keys1.view(torch.int32) & 255
    t["bincount_ms"] = cuda_time_ms(
        lambda: torch.bincount(digit, minlength=256), runs=RUNS)
    try:  # device_time_ms refuses a call that waits for the host
        device_time_ms(lambda: torch.bincount(digit, minlength=256),
                       runs=RUNS)
        t["bincount_syncs"] = False
    except RuntimeError:
        t["bincount_syncs"] = True
    del digit
    t["hist_plain_ms"] = cuda_time_ms(
        lambda: hist.digit_histograms_plain(keys1, n_stages=4, width=8),
        runs=RUNS)
    for width in (4, 2):
        kernel(f"hist_w{width}", lambda: hist.digit_histograms(
            keys1, n_stages=32 // width, width=width))
    for case in ("skew90", "zipf"):  # skewed keys, width 8
        k = hist_keys(case, N_KEYS, gen)
        t[f"hist_{case}_ms"] = device_time_ms(
            lambda: hist.digit_histograms(k, n_stages=4, width=8), runs=RUNS)
        del k
    gbase = hist.stage_bases(hist.digit_histograms(keys1, n_stages=4,
                                                   width=8))[0].contiguous()
    for n_planes in (1, 3):
        planes = [keys1] + [rand_bits(N_KEYS, torch.uint32, gen)
                            for _ in range(n_planes - 1)]
        out = [torch.empty_like(p) for p in planes]
        kernel(f"stage{n_planes}", lambda: stage.partition_stage(
            planes, gbase, shift=0, width=8, out=out))
        t[f"stage{n_planes}_plain_ms"] = cuda_time_ms(
            lambda: stage.partition_stage_plain(planes, gbase, shift=0,
                                                width=8, out=out), runs=RUNS)
    del keys1, k32, planes, out

    # config 2's pass: 2^28 keys, width 8, 3 planes
    planes = [rand_bits(N_PAIRS, torch.uint32, gen) for _ in range(3)]
    out = [torch.empty_like(p) for p in planes]
    gbase = hist.stage_bases(hist.digit_histograms(planes[0], n_stages=4,
                                                   width=8))[0].contiguous()
    kernel("stage3_2_28", lambda: stage.partition_stage(
        planes, gbase, shift=0, width=8, out=out))
    # config 2's histograms: one u32 limb, and both limbs of its u64 keys in
    # one launch (the pipeline's call)
    kernel("hist_2_28", lambda: hist.limb_histograms(
        [planes[0]], [(0, 32)], 8))
    kernel("hist2_2_28", lambda: hist.limb_histograms(
        planes[:2], [(0, 32), (0, 32)], 8))
    del planes, out
    torch.cuda.empty_cache()

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
    kernel("scan", lambda: kscan.segmented_scan(values, heads, "sum"))
    t["scan_plain_ms"] = cuda_time_ms(
        lambda: kscan.segmented_scan_plain(values, heads, "sum"), runs=RUNS)
    kernel("scan_f32", lambda: kscan.segmented_scan(
        values.view(torch.float32), heads, "sum"))
    kernel("scan_sum_noheads",
           lambda: kscan.segmented_scan(values, None, "sum"))
    kernel("scan_max_noheads",
           lambda: kscan.segmented_scan(values, None, "max"))
    t["cumsum_ms"] = device_time_ms(
        lambda: torch.cumsum(values, 0, dtype=torch.int32), runs=RUNS)
    t["cummax_ms"] = device_time_ms(lambda: torch.cummax(values, 0),
                                    runs=RUNS)
    del values, heads
    # at the FK join's size: 2^27 + 2^24 rows
    values = rand_bits(N_PROBE + N_BUILD, torch.int32, gen)
    heads = torch.rand(values.numel(), device="cuda", generator=gen) < 0.01
    kernel("scan_fk", lambda: kscan.segmented_scan(values, heads, "sum"))
    kernel("scan_fk_noheads",
           lambda: kscan.segmented_scan(values, None, "sum"))
    del values, heads
    torch.cuda.empty_cache()

    for name, (fn, args, rows, oracle) in operator_paths(gen).items():
        t[name] = (cuda_time_ms(lambda: fn(*args), runs=RUNS),
                   cuda_time_ms(lambda: oracle(*args), runs=RUNS), rows)
        torch.cuda.empty_cache()
    paths = plan_paths(gen)
    for name in PLAN_PATHS:
        fn, args, rows, oracle = paths.pop(name)
        t[name] = (cuda_time_ms(lambda: fn(*args), runs=RUNS),
                   cuda_time_ms(lambda: oracle(*args), runs=RUNS), rows)
        del fn, args, oracle
        torch.cuda.empty_cache()

    # the network: each path on 'bitonic', on 'radix' and its torch oracle
    net = rt.SortConfig(engine="bitonic")
    radix = rt.SortConfig(engine="radix")
    paths = network_paths(gen)
    fk_args = paths.pop("_data")[3]
    for name in NET_PATHS:
        fn, oracle, rows = paths[name]
        t[name] = (cuda_time_ms(lambda: fn(net), runs=RUNS),
                   cuda_time_ms(lambda: fn(radix), runs=RUNS),
                   cuda_time_ms(oracle, runs=RUNS), rows)
    # (d)'s sort (2^27 + 2^24 rows, key + tag + value) on the split route
    # (split_sort_min_logn 19, the preset) and on the padded 2^28 network
    # (29: the split never engages); the same bits either way
    bkeys, bvals, pkeys = fk_args
    del paths, fn, oracle, fk_args
    keys = twiddle.cat([bkeys, pkeys])
    n = keys.numel()
    posc = torch.arange(n, dtype=torch.int32, device="cuda").view(torch.uint32)
    vals = torch.cat([bvals, torch.zeros(n - bvals.numel(), dtype=bvals.dtype,
                                         device="cuda")])
    split_cfg = {19: net, 29: net.replace(split_sort_min_logn=29)}
    split_out = {}
    for m, cfg in split_cfg.items():
        sort_d = lambda cfg=cfg: rt.sort_pairs(keys, (posc, vals), config=cfg,
                                               unique_leading_payload=True)
        split_out[m] = sort_d()
        t[f"split{m}_ms"] = cuda_time_ms(sort_d, runs=RUNS)
    (k19, (p19, v19)), (k29, (p29, v29)) = split_out[19], split_out[29]
    e = max(max_abs_err(k19, k29), max_abs_err(p19, p29), max_abs_err(v19, v29))
    expect(e == 0, f"(d)'s sort: split route and padded sort differ ({e})")
    del keys, posc, vals, bkeys, bvals, pkeys, split_out
    del k19, p19, v19, k29, p29, v29
    torch.cuda.empty_cache()
    # each network kernel at 2^24 with 1 and 4 planes (all-compare): the
    # tile kernel's sort pass, one cross pass of the preset width at the
    # top level, and the whole network
    logn = N_KEYS.bit_length() - 1
    for p in (1, 4):
        planes = [rand_bits(N_KEYS, torch.uint32, gen) for _ in range(p)]
        lt = min(bk.tile_log_rows(p), logn)
        c = bk.cross_strides(p)
        if p == 1:
            # the 1-plane pass's library call: every 2^lt-row tile sorted
            # by one torch.sort of the sign-flipped int32 view of the same
            # keys (the pass leaves odd tiles descending: the same work);
            # no single call computes the 4-plane pass
            tiles = (planes[0].view(torch.int32)
                     ^ (-(1 << 31))).view(-1, 1 << lt)
            lib = lambda: torch.sort(tiles, dim=-1)
            try:  # device_time_ms refuses a call that waits for the host
                t["tile1_torch_sort_ms"] = device_time_ms(lib, runs=RUNS)
                t["tile1_torch_sort_syncs"] = False
            except RuntimeError:
                t["tile1_torch_sort_ms"] = cuda_time_ms(lib, runs=RUNS)
                t["tile1_torch_sort_syncs"] = True
            del tiles, lib
        tile_kw = dict(log_t=lt, k_first=1, k_last=lt, n_cmp=p,
                       net_tile=bk.network_log_tile(p))
        cross_kw = dict(k=logn, lo=logn - c, c=c, n_cmp=p)
        kernel(f"tile{p}", lambda: bk.tile_pass(planes, **tile_kw))
        t[f"tile{p}_plain_ms"] = cuda_time_ms(
            lambda: bk.tile_pass_plain(planes, **tile_kw), runs=RUNS)
        kernel(f"cross{p}", lambda: bk.cross_pass(planes, **cross_kw))
        t[f"cross{p}_plain_ms"] = cuda_time_ms(
            lambda: bk.cross_pass_plain(planes, **cross_kw), runs=RUNS)
        t[f"network{p}_ms"] = cuda_time_ms(
            lambda: bk.sort_planes_bitonic(planes, n_cmp=p,
                                           log_tile=bk.network_log_tile(p)),
            runs=RUNS)
        # the same network on tiles twice as large: one block an SM
        ops = bk.plan_passes(logn, 1, p, log_t=lt + 1)
        t[f"network{p}_one_block_ms"] = cuda_time_ms(
            lambda: bk.run_passes(planes, ops, bk.network_log_tile(p), p),
            runs=RUNS)
        t[f"geometry{p}"] = (lt, c)
    del planes
    torch.cuda.empty_cache()
    # path (b)'s tile passes: 2^28 rows of 4 planes (n_cmp 3), the sort
    # pass and the top level's merge-mode pass
    planes = network_planes(4, 3, 28, False, gen)
    lt = bk.tile_log_rows(4)
    kernel("tile4_2_28", lambda: bk.tile_pass(
        planes, log_t=lt, k_first=1, k_last=lt, n_cmp=3,
        net_tile=bk.network_log_tile(4)))
    kernel("tile4_merge_2_28", lambda: bk.tile_pass(
        planes, log_t=lt, k_first=28, k_last=28, n_cmp=3))
    del planes
    torch.cuda.empty_cache()
    t["peak_gib"] = max(PEAK_BYTES[0], torch.cuda.max_memory_allocated()) / 2**30
    return t


def load_parent(root: str) -> dict:
    """The port of another commit (a `git archive` of it unpacked under
    ``root``), imported beside this checkout's: its modules load under the
    port's name and then leave sys.modules, so each copy keeps calling its
    own code and builds its own kernels (under ``root``/build). Returns
    {"": the package, "kernels.histogram": ..., "kernels.scan": ...,
    "models.flagships": ..., "utils.build": ...}."""
    name = "cuda.radixsort_tpu_torch"
    ours = {k: m for k, m in sys.modules.items()
            if k == name or k.startswith(name + ".")}
    top = sys.modules["cuda"]
    for k in ours:
        del sys.modules[k]
    try:
        pkg_dir = os.path.join(root, "cuda", "radixsort_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg_dir, "__init__.py"),
            submodule_search_locations=[pkg_dir])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[name] = pkg
        spec.loader.exec_module(pkg)
        mods = {"": pkg}
        for sub in ("kernels.histogram", "kernels.scan", "models.flagships",
                    "utils.build"):
            mods[sub] = importlib.import_module(f"{name}.{sub}")
    finally:
        for k in [k for k in sys.modules
                  if k == name or k.startswith(name + ".")]:
            del sys.modules[k]
        sys.modules.update(ours)
        setattr(top, "radixsort_tpu_torch", ours[name])
    return mods


def ab_items(par: dict, gen: torch.Generator):
    """(name, timer, bound_ms, make) of the before/after: make() returns
    (the parent's call, this checkout's call) on the same inputs. Kernels
    are timed on the card alone ("device"), paths as a caller waits
    ("call")."""
    import cuda.radixsort_tpu_torch as rt
    from cuda.radixsort_tpu_torch.kernels import histogram as hist
    from cuda.radixsort_tpu_torch.kernels import scan as kscan

    prt, phist, pscan = par[""], par["kernels.histogram"], par["kernels.scan"]
    pflag = par["models.flagships"]

    def hist_24(width, case="random"):
        keys = hist_keys(case, N_KEYS, gen)
        return (lambda: phist.digit_histograms(keys, n_stages=32 // width,
                                               width=width),
                lambda: hist.digit_histograms(keys, n_stages=32 // width,
                                              width=width))

    def hist_28(n_limbs):
        limbs = u64_limbs(N_PAIRS, gen)[:n_limbs]
        return (lambda: [phist.digit_histograms(k, n_stages=4, width=8)
                         for k in limbs],
                lambda: hist.limb_histograms(limbs, [(0, 32)] * n_limbs, 8))

    def scan(n, heads, dtype=torch.int32):
        values = (torch.randn(n, device="cuda", generator=gen) * 100
                  if dtype == torch.float32 else rand_bits(n, dtype, gen))
        flags = (torch.rand(n, device="cuda", generator=gen) < 0.01 if heads
                 else torch.zeros(n, dtype=torch.bool, device="cuda"))
        return (lambda: pscan.segmented_scan(values, flags, "sum"),
                lambda: kscan.segmented_scan(values, flags if heads else None,
                                             "sum"))

    def sort_1():
        keys = rand_bits(N_KEYS, torch.uint32, gen)
        return lambda: prt.sort(keys), lambda: rt.sort(keys)

    def pairs_2():
        keys = rand_bits(N_PAIRS, torch.uint64, gen)
        pay = rand_bits(N_PAIRS, torch.uint32, gen)
        return (lambda: prt.sort_pairs(keys, pay),
                lambda: rt.sort_pairs(keys, pay))

    def operator(recipe, sizes, count=False):
        from cuda.radixsort_tpu_torch.models import flagships

        fn, args = getattr(flagships, recipe)(*sizes, generator=gen,
                                              device="cuda")
        pfn, _ = getattr(pflag, recipe)(*[16] * len(sizes), generator=gen,
                                        device="cuda")
        if count:  # the group-by path: the sums, then the counts
            return (lambda: (pfn(*args), prt.groupby(args[0], agg="count")),
                    lambda: (fn(*args), rt.groupby(args[0], agg="count")))
        return lambda: pfn(*args), lambda: fn(*args)

    b24 = bound_ms(4 * N_KEYS, 4 * N_KEYS)[0]
    return [
        ("digit_histograms 2^24 width 8", "device", b24, lambda: hist_24(8)),
        ("digit_histograms 2^24 width 8, 90%-one-key", "device", b24,
         lambda: hist_24(8, "skew90")),
        ("digit_histograms 2^24 width 8, Zipf-like keys", "device", b24,
         lambda: hist_24(8, "zipf")),
        ("digit_histograms 2^24 width 4", "device",
         bound_ms(4 * N_KEYS, 8 * N_KEYS)[0], lambda: hist_24(4)),
        ("digit_histograms 2^24 width 2", "device",
         bound_ms(4 * N_KEYS, 16 * N_KEYS)[0], lambda: hist_24(2)),
        ("histograms 2^28 one u32 limb", "device",
         bound_ms(4 * N_PAIRS, 4 * N_PAIRS)[0], lambda: hist_28(1)),
        ("histograms 2^28 two u32 limbs (parent: two launches)", "device",
         bound_ms(8 * N_PAIRS, 8 * N_PAIRS)[0], lambda: hist_28(2)),
        ("segmented_scan 2^24 int32 sum, 1% heads", "device",
         bound_ms(9 * N_KEYS, N_KEYS)[0], lambda: scan(N_KEYS, True)),
        ("segmented_scan 2^24 float32 sum, 1% heads", "device",
         bound_ms(9 * N_KEYS, N_KEYS)[0],
         lambda: scan(N_KEYS, True, torch.float32)),
        ("segmented_scan 2^24 int32 sum, no heads (parent: zero flags)",
         "device", bound_ms(8 * N_KEYS, N_KEYS)[0],
         lambda: scan(N_KEYS, False)),
        ("segmented_scan 2^27+2^24 int32 sum, 1% heads", "device",
         bound_ms(9 * (N_PROBE + N_BUILD), N_PROBE + N_BUILD)[0],
         lambda: scan(N_PROBE + N_BUILD, True)),
        ("segmented_scan 2^27+2^24 int32 sum, no heads", "device",
         bound_ms(8 * (N_PROBE + N_BUILD), N_PROBE + N_BUILD)[0],
         lambda: scan(N_PROBE + N_BUILD, False)),
        ("config 1 sort 2^24 u32", "call", None, sort_1),
        ("config 2 sort_pairs 2^28 u64+u32", "call", None, pairs_2),
        (FK, "call", None, lambda: operator("fk_join", (N_PROBE, N_BUILD))),
        (GROUPBY, "call", None,
         lambda: operator("groupby_zipf", (N_GROUP,), count=True)),
        (OUTER, "call", None,
         lambda: operator("outer_join_agg", (N_OPROBE, N_OBUILD))),
    ]


def phase_ab(gen: torch.Generator, root: str) -> dict:
    """--parent DIR: the parent commit's kernels and radix paths against
    this checkout's on the same inputs in the same call, timed in turns
    parent, this, this, parent (two calls of the card are not comparable
    at this size). The two must agree: kernels bit for bit (float32 scans
    within their tolerance), paths on their first output."""
    from cuda.radixsort_tpu_torch.utils.profiling import (cuda_time_ms,
                                                          device_time_ms)

    par = load_parent(root)
    t0 = time.perf_counter()
    par["utils.build"].library()
    log(f"[ab] parent port from {root}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for name, timer, bound, make in ab_items(par, gen):
        pf, nf = make()
        got, want = nf(), pf()
        if isinstance(want, list) and isinstance(got, torch.Tensor):
            want = torch.cat(want)  # the parent's one launch per limb
        while isinstance(got, (tuple, list)):
            got, want = got[0], want[0]
        torch.cuda.synchronize()
        if got.dtype == torch.float32 and "scan" in name:
            ok = bool(torch.allclose(got, want, rtol=1e-4, atol=1e-2))
        else:
            ok = torch.equal(sv(got), sv(want))
        expect(ok, f"[ab] {name}: parent and this checkout disagree")
        # kernels are steady on the card: one round; paths wait on the host
        # too, so they take AB_ROUNDS rounds for their spread
        t = device_time_ms if timer == "device" else cuda_time_ms
        parent_ms, ms = [], []
        for _ in range(1 if timer == "device" else AB_ROUNDS):
            times = [t(fn, runs=RUNS) for fn in (pf, nf, nf, pf)]
            parent_ms += [times[0], times[3]]
            ms += [times[1], times[2]]
        out[name] = {"timer": timer, "parent_ms": parent_ms, "ms": ms,
                     "bound_ms": bound}
        log(f"[ab] {name} ({timer}): parent median "
            f"{statistics.median(parent_ms):.4f} ms ({min(parent_ms):.4f}-"
            f"{max(parent_ms):.4f}), this median {statistics.median(ms):.4f} "
            f"ms ({min(ms):.4f}-{max(ms):.4f}) over {len(ms)} medians of "
            f"{RUNS} each" + (f"; bound {bound:.4f} ms" if bound else ""))
        del pf, nf, got, want
        torch.cuda.empty_cache()
    return out


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


def profile_path(name: str, fn) -> None:
    """One call of fn under torch.profiler after a warm-up: device busy
    time, idle share against the CUDA-event median, time by kernel."""
    from cuda.radixsort_tpu_torch.utils.profiling import cuda_time_ms
    from torch.profiler import ProfilerActivity, profile

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


def profile_distributed(gen: torch.Generator) -> None:
    """The D paths under the profiler, on a one-rank NCCL mesh."""
    import torch.distributed as dist

    from cuda.radixsort_tpu_torch.parallel import dsort

    store = nccl_world()
    try:
        paths = dist_paths(gen, dsort.make_mesh(1, device="cuda"))
        for name in DIST_PATHS:
            profile_path(name, paths.pop(name)[0])
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)


def phase_profile(gen: torch.Generator) -> None:
    """--profile: where the device time of each path goes (torch.profiler,
    one call after a warm-up), the device's idle share against the call's
    CUDA-event time, and, for the sorts, a sweep of the digit width and the
    tile geometry."""
    import cuda.radixsort_tpu_torch as rt
    from cuda.radixsort_tpu_torch import config as config_lib
    from cuda.radixsort_tpu_torch.utils.profiling import cuda_time_ms

    keys1 = rand_bits(N_KEYS, torch.uint32, gen)
    keys2 = rand_bits(N_PAIRS, torch.uint64, gen)
    pay2 = rand_bits(N_PAIRS, torch.uint32, gen)
    calls = {"config 1 sort 2^24 u32": lambda cfg=None: rt.sort(keys1, config=cfg),
             "config 2 sort_pairs 2^28 u64+u32":
                 lambda cfg=None: rt.sort_pairs(keys2, pay2, config=cfg)}
    ops = {name: (lambda fn=fn, args=args: fn(*args))
           for name, (fn, args, _, _) in {**operator_paths(gen),
                                          **plan_paths(gen)}.items()}
    net = rt.SortConfig(engine="bitonic")
    net_paths = network_paths(gen)
    net_paths.pop("_data")
    ops.update({name: (lambda fn=fn: fn(net))
                for name, (fn, _, _) in net_paths.items()})
    for name, fn in {**calls, **ops}.items():
        profile_path(name, fn)
    profile_distributed(gen)

    base = config_lib.preset()
    for name, fn in calls.items():
        for rb in (4, 8):
            ms = cuda_time_ms(lambda: fn(base.replace(radix_bits=rb)), runs=RUNS)
            log(f"[sweep] {name}: radix_bits={rb}: {ms:.3f} ms")
    for name, fn in calls.items():
        for bt in (128, 256, 512):
            for ipt in (8, 16, 32):
                ms = cuda_time_ms(lambda: fn(base.replace(
                    block_threads=bt, items_per_thread=ipt)), runs=RUNS)
                log(f"[sweep] {name}: block_threads={bt} "
                    f"items_per_thread={ipt}: {ms:.3f} ms")
    del keys1, keys2, pay2, ops, net_paths
    torch.cuda.empty_cache()


def check_measurement(t: dict, stage_bound: tuple) -> None:
    """The measurement module on this run's numbers: bitonic_passes(24, 1)
    is the tile and cross launches counted on network path (a), and
    speed_of_light of the 2^24 stage pass gives the share bound_ms gives."""
    from cuda.radixsort_tpu_torch.utils.profiling import (bitonic_passes,
                                                          speed_of_light)

    a = PATH_LAUNCHES[NET_A]
    counted = a["bitonic_tile"] + a["bitonic_cross"]
    expect(bitonic_passes(24, 1) == counted,
           f"bitonic_passes(24, 1) = {bitonic_passes(24, 1)}, but {NET_A} "
           f"launched {counted} tile and cross passes")
    sol = speed_of_light(8 * N_KEYS + 4 * 256, t["stage1_ms"] / 1e3)
    share = stage_bound[0] / t["stage1_ms"]
    expect(abs(sol["fraction_of_sol"] - share) <= 1e-9 * share,
           f"speed_of_light {sol['fraction_of_sol']} != bound_ms / ms "
           f"{share} for the 2^24 stage pass")
    log(f"[profiling] bitonic_passes(24, 1) = {counted} = {NET_A}'s tile + "
        f"cross launches; the 2^24 stage pass runs at "
        f"{sol['fraction_of_sol']:.4f} of the memory rate "
        f"({sol['hbm_bytes_per_s']:.4g} B/s), as bound_ms gives")


def main() -> int:
    args = sys.argv[1:]
    profile_run = "--profile" in args
    parent = args[args.index("--parent") + 1] if "--parent" in args else None
    kind, smi = phase_device()
    load_port()
    phase_build()
    if "--only-scan" in args:  # the scan kernel's phases alone
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        errs = phase_scan_kernel(gen)
        log(json.dumps({"ok": True, "segmented_scan": errs}))
        return 0
    if "--only-distributed" in args:  # phase 6d alone
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        dist_ms = phase_distributed(gen, {})
        log(json.dumps({"ok": True, "distributed_ms": dist_ms}))
        return 0
    card_ops = phase_card_ops()
    surface = phase_surface()
    phase_self_test()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    errs = phase_kernels(gen)
    errs["digit_histograms"] = max(errs["digit_histograms"],
                                   phase_hist_kernel(gen))
    paired_ms = phase_paired(gen)
    errs["segmented_scan"] = phase_scan_kernel(gen)
    errs.update(phase_network_kernels(gen))
    launches = phase_slice(gen)
    op_errs = phase_operators(gen, launches)
    plan_errs = phase_plan(gen, launches)
    phase_network(gen, launches)
    if profile_run:
        phase_profile(gen)
    large_ms = phase_sort_large(gen, launches)
    compat_ms = phase_compat(gen, launches)
    external_s = phase_external(gen, launches)
    dist_launches: dict = {}
    dist_ms = phase_distributed(gen, dist_launches)
    for k, c in dist_launches.items():
        launches[k] = launches.get(k, 0) + c
    t = phase_times(gen)
    ab = phase_ab(gen, parent) if parent else None

    log(f"[times] config 1 sort 2^24 u32: {t['sort_ms']:.3f} ms = "
        f"{N_KEYS / t['sort_ms'] * 1e3:.4g} keys/s "
        f"(torch.sort of the int32 view, stable: {t['torch_sort_ms']:.3f} ms)")
    log(f"[times] config 2 sort_pairs 2^28 u64+u32: {t['pairs_ms']:.3f} ms = "
        f"{N_PAIRS / t['pairs_ms'] * 1e3:.4g} pairs/s "
        f"(torch.sort int64 stable + gather: {t['torch_pairs_ms']:.3f} ms)")
    for name in (FK, GROUPBY, OUTER) + PLAN_PATHS:
        ms, oracle_ms, rows = t[name]
        log(f"[times] {name}: {ms:.3f} ms = {rows / ms * 1e3:.4g} rows/s "
            f"(its torch oracle: {oracle_ms:.3f} ms)")
    log("[times] kernels: the card's time per call (batches queued ahead), "
        "then one call as a caller waits for it (host launch path included)")
    log(f"[times] digit_histograms 2^24 width 8: kernel {t['hist_ms']:.4f} / "
        f"{t['hist_call_ms']:.4f} ms, plain {t['hist_plain_ms']:.4f} ms; "
        f"width 4 {t['hist_w4_ms']:.4f} / {t['hist_w4_call_ms']:.4f} ms, "
        f"width 2 {t['hist_w2_ms']:.4f} / {t['hist_w2_call_ms']:.4f} ms")
    log(f"[times] torch.bincount of one 8-bit digit of 2^24 keys: "
        f"{t['bincount_ms']:.4f} ms (the digit made beforehand: "
        f"{t['digit_extract_ms']:.4f} ms; reads its maximum to the host: "
        f"{t['bincount_syncs']})")
    log(f"[times] digit_histograms 2^24 width 8 on skewed keys: "
        f"90%-one-key {t['hist_skew90_ms']:.4f} ms, Zipf-like "
        f"{t['hist_zipf_ms']:.4f} ms")
    log(f"[times] histograms 2^28 width 8: one u32 limb "
        f"{t['hist_2_28_ms']:.4f} / {t['hist_2_28_call_ms']:.4f} ms, config "
        f"2's two limbs in one launch {t['hist2_2_28_ms']:.4f} / "
        f"{t['hist2_2_28_call_ms']:.4f} ms")
    for p in (1, 3):
        log(f"[times] partition_stage 2^24 width 8, {p} plane(s): kernel "
            f"{t[f'stage{p}_ms']:.4f} / {t[f'stage{p}_call_ms']:.4f} ms, plain "
            f"{t[f'stage{p}_plain_ms']:.4f} ms")
    log(f"[times] partition_stage 2^28 width 8, 3 planes (config 2's pass): "
        f"{t['stage3_2_28_ms']:.4f} / {t['stage3_2_28_call_ms']:.4f} ms")
    log(f"[times] segmented_scan 2^24 int32 sum, 1% heads: kernel "
        f"{t['scan_ms']:.4f} / {t['scan_call_ms']:.4f} ms, plain "
        f"{t['scan_plain_ms']:.4f} ms; float32 sum {t['scan_f32_ms']:.4f} ms; "
        f"no heads: sum {t['scan_sum_noheads_ms']:.4f} ms (torch.cumsum "
        f"{t['cumsum_ms']:.4f} ms), max {t['scan_max_noheads_ms']:.4f} ms "
        f"(torch.cummax {t['cummax_ms']:.4f} ms)")
    log(f"[times] segmented_scan 2^27+2^24 int32 sum (the FK join's size): "
        f"1% heads {t['scan_fk_ms']:.4f} / {t['scan_fk_call_ms']:.4f} ms, no "
        f"heads {t['scan_fk_noheads_ms']:.4f} ms")
    for name in NET_PATHS:
        ms, radix_ms, oracle_ms, rows = t[name]
        log(f"[times] {name}: bitonic {ms:.3f} ms = {rows / ms * 1e3:.4g} "
            f"rows/s; radix {radix_ms:.3f} ms; torch oracle {oracle_ms:.3f} ms")
    for p in (1, 4):
        lt, c = t[f"geometry{p}"]
        log(f"[times] network kernels 2^24, {p} plane(s): tile sort pass "
            f"(2^{lt}-row tiles) {t[f'tile{p}_ms']:.4f} ms, plain "
            f"{t[f'tile{p}_plain_ms']:.4f} ms; cross pass (c={c}) "
            f"{t[f'cross{p}_ms']:.4f} ms, plain {t[f'cross{p}_plain_ms']:.4f} "
            f"ms; whole network {t[f'network{p}_ms']:.4f} ms (two blocks an "
            f"SM), {t[f'network{p}_one_block_ms']:.4f} ms on 2^{lt + 1}-row "
            f"tiles (one block an SM)")
    log(f"[times] tile kernel 2^28, 4 planes (path (b)): sort pass "
        f"{t['tile4_2_28_ms']:.4f} ms, merge-mode pass at level 28 "
        f"{t['tile4_merge_2_28_ms']:.4f} ms")
    log(f"[times] (d)'s sort 2^27 + 2^24 rows, key + tag + value: split-sort-"
        f"merge route {t['split19_ms']:.3f} ms, padded 2^28 network "
        f"{t['split29_ms']:.3f} ms (split_sort_min_logn 19 / 29; same bits)")
    for name in LARGE_PATHS:
        ms, rt_ms, torch_ms, rows, a_ms, b_ms, (cap, group, nb) = \
            large_ms[name]
        log(f"[times] {name}: {ms:.3f} ms = {rows / ms * 1e3:.4g} keys/s "
            f"(phase A {a_ms:.3f} ms, phase B {b_ms:.3f} ms in {nb // group}"
            f" batch(es) of {group} x {cap}); rt.sort {rt_ms:.3f} ms; "
            f"torch.sort {torch_ms:.3f} ms")
    for name in REF_PATHS:
        ms, rt_ms, _, rows = large_ms[name]
        log(f"[times] {name}: {ms:.3f} ms = {rows / ms * 1e3:.4g} keys/s; "
            f"the radix engine {rt_ms:.3f} ms")
    log(f"[times] tile pass 2^24, 1 plane, beside its library call "
        f"torch.sort(view(-1, 2^{t['geometry1'][0]}), dim=-1) of the "
        f"sign-flipped int32 view: {t['tile1_ms']:.4f} / "
        f"{t['tile1_torch_sort_ms']:.4f} ms (the card's time per call"
        + (", the library call one call as a caller waits: it syncs)"
           if t["tile1_torch_sort_syncs"] else ")"))
    log(f"[times] peak device memory {t['peak_gib']:.2f} GiB; card: {smi}")

    from cuda.radixsort_tpu_torch.kernels import bitonic as bk

    # network kernels: each plane read and written once; one operation
    # (a min, max or select) per output word per stage
    net_bounds = {}
    for p in (1, 4):
        lt, c = t[f"geometry{p}"]
        stages = lt * (lt + 1) // 2
        net_bounds[p] = (bound_ms(8 * p * N_KEYS, stages * p * N_KEYS),
                         bound_ms(8 * p * N_KEYS, c * p * N_KEYS))
    lt4 = bk.tile_log_rows(4)
    tile4_2_28_bound = bound_ms(8 * 4 * N_PAIRS,
                                lt4 * (lt4 + 1) // 2 * 4 * N_PAIRS)
    # histograms: each key read once, each counter written once; one count
    # per key and stage
    hist_bound = bound_ms(4 * N_KEYS + 4 * 256 * 4, 4 * N_KEYS)
    hist_2_28_bound = bound_ms(4 * N_PAIRS + 4 * 256 * 4, 4 * N_PAIRS)
    hist2_2_28_bound = bound_ms(8 * N_PAIRS + 8 * 256 * 4, 8 * N_PAIRS)
    stage_bound = bound_ms(8 * N_KEYS + 4 * 256, N_KEYS)
    check_measurement(t, stage_bound)
    stage_2_28_bound = bound_ms(8 * 3 * N_PAIRS + 4 * 256, N_PAIRS)
    # scans: 4 B of value and 1 B of flag read, 4 B written per row
    scan_bound = bound_ms(9 * N_KEYS, N_KEYS)
    scan_fk_bound = bound_ms(9 * (N_PROBE + N_BUILD), N_PROBE + N_BUILD)
    scan_noheads_bound = bound_ms(8 * N_KEYS, N_KEYS)
    record = {"kernels": [
        {"name": "digit_histograms", "route": "cuda",
         "source": "cuda/radixsort_tpu_torch/csrc/histogram.cu",
         "replaces": "cuda/radixsort_tpu/kernels/histogram.py:71",
         "launches": launches["digit_histograms"],
         "max_abs_err": errs["digit_histograms"],
         "ms": t["hist_ms"], "plain_ms": t["hist_plain_ms"],
         "bound_ms": hist_bound[0], "bound_by": hist_bound[1],
         "library_ms": t["bincount_ms"],
         "library_call": "torch.bincount(digit, minlength=256) of one 8-bit "
                         "digit of the kernel's four, the int32 digit made "
                         "beforehand (digit_extract_ms)"
                         + ("; it reads the digits' maximum to the host"
                            if t["bincount_syncs"] else ""),
         "digit_extract_ms": t["digit_extract_ms"],
         "ms_per_call": t["hist_call_ms"],
         "ms_width_4": t["hist_w4_ms"], "ms_width_2": t["hist_w2_ms"],
         "ms_skew90": t["hist_skew90_ms"], "ms_zipf": t["hist_zipf_ms"],
         "ms_2_28_one_limb": t["hist_2_28_ms"],
         "bound_ms_2_28_one_limb": hist_2_28_bound[0],
         "ms_2_28_two_limbs": t["hist2_2_28_ms"],
         "bound_ms_2_28_two_limbs": hist2_2_28_bound[0],
         "ms_2_28_u64_column": paired_ms["hist_paired"],
         "shape": "2^24 u32 keys, width 8, 4 stages"},
        {"name": "partition_stage", "route": "cuda",
         "source": "cuda/radixsort_tpu_torch/csrc/stage.cu",
         "replaces": "cuda/radixsort_tpu/kernels/stage.py:267",
         "launches": launches["partition_stage"],
         "max_abs_err": errs["partition_stage"],
         "ms": t["stage1_ms"], "plain_ms": t["stage1_plain_ms"],
         "ms_per_call": t["stage1_call_ms"],
         "bound_ms": stage_bound[0], "bound_by": stage_bound[1],
         "library_ms": None,
         "ms_3_planes": t["stage3_ms"], "plain_ms_3_planes": t["stage3_plain_ms"],
         "ms_2_28_3_planes": t["stage3_2_28_ms"],
         "bound_ms_2_28_3_planes": stage_2_28_bound[0],
         "ms_2_28_u64_column_u32": paired_ms["paired"],
         "shape": "2^24 u32 keys, width 8, shift 0 (2^28: config 2's pass)"},
        {"name": "segmented_scan", "route": "cuda",
         "source": "cuda/radixsort_tpu_torch/csrc/scan.cu",
         "replaces": "cuda/radixsort_tpu/kernels/scan.py:155",
         "launches": launches["segmented_scan"],
         "max_abs_err": errs["segmented_scan"]["exact"],
         "f32_sum_max_abs_err": errs["segmented_scan"]["f32_sum"],
         "f32_sum_tol": f"{SCAN_F32_TOL} of the segment's sum of |x|",
         "ms": t["scan_ms"], "plain_ms": t["scan_plain_ms"],
         "bound_ms": scan_bound[0], "bound_by": scan_bound[1],
         "ms_per_call": t["scan_call_ms"], "ms_float32": t["scan_f32_ms"],
         "ms_no_heads": t["scan_sum_noheads_ms"],
         "bound_ms_no_heads": scan_noheads_bound[0],
         "ms_2_27_2_24": t["scan_fk_ms"],
         "bound_ms_2_27_2_24": scan_fk_bound[0],
         "ms_2_27_2_24_no_heads": t["scan_fk_noheads_ms"],
         "library_ms": t["cumsum_ms"], "library_call": "torch.cumsum int32, no heads",
         "ms_max_no_heads": t["scan_max_noheads_ms"],
         "library_ms_cummax": t["cummax_ms"],
         "shape": "2^24 int32 values, sum, 1% heads"},
        {"name": "bitonic_tile", "route": "cuda",
         "source": "cuda/radixsort_tpu_torch/csrc/bitonic.cu",
         "replaces": "cuda/radixsort_tpu/kernels/bitonic.py:412",
         "launches": launches["bitonic_tile"],
         "max_abs_err": errs["bitonic_tile"],
         "ms": t["tile1_ms"], "plain_ms": t["tile1_plain_ms"],
         "ms_per_call": t["tile1_call_ms"],
         "bound_ms": net_bounds[1][0][0], "bound_by": net_bounds[1][0][1],
         "library_ms": t["tile1_torch_sort_ms"],
         "library_call": f"torch.sort(view(-1, 2^{t['geometry1'][0]}), "
                         "dim=-1) of the sign-flipped int32 view: every "
                         "tile sorted (the pass leaves odd tiles "
                         "descending; the same work); no single call "
                         "computes the 4-plane pass",
         "network_ms": t["network1_ms"],
         "network_library_ms": t["torch_sort_ms"],
         "network_library_call": "torch.sort of the 2^24 u32 bits (the "
                                 "whole 1-plane network's yardstick)",
         "ms_4_planes": t["tile4_ms"], "plain_ms_4_planes": t["tile4_plain_ms"],
         "bound_ms_4_planes": net_bounds[4][0][0],
         "network_ms_4_planes": t["network4_ms"],
         "ms_2_28_4_planes": t["tile4_2_28_ms"],
         "bound_ms_2_28_4_planes": tile4_2_28_bound[0],
         "merge_ms_2_28_4_planes": t["tile4_merge_2_28_ms"],
         "shape": f"2^24 rows, sort pass of 2^{t['geometry1'][0]}-row tiles "
                  f"(4 planes: 2^{t['geometry4'][0]})"},
        {"name": "bitonic_cross", "route": "cuda",
         "source": "cuda/radixsort_tpu_torch/csrc/bitonic.cu",
         "replaces": "cuda/radixsort_tpu/kernels/bitonic.py:922",
         "launches": launches["bitonic_cross"],
         "max_abs_err": errs["bitonic_cross"],
         "ms": t["cross1_ms"], "plain_ms": t["cross1_plain_ms"],
         "ms_per_call": t["cross1_call_ms"],
         "bound_ms": net_bounds[1][1][0], "bound_by": net_bounds[1][1][1],
         "library_ms": None,
         "library_note": "no single torch call runs c strides of one "
                         "bitonic level",
         "ms_4_planes": t["cross4_ms"],
         "plain_ms_4_planes": t["cross4_plain_ms"],
         "bound_ms_4_planes": net_bounds[4][1][0],
         "shape": f"2^24 rows, one pass of c={t['geometry1'][1]} strides "
                  f"(4 planes: c={t['geometry4'][1]}) at level 24"},
    ], "sort_keys_per_s": N_KEYS / t["sort_ms"] * 1e3,
        "sort_pairs_per_s": N_PAIRS / t["pairs_ms"] * 1e3,
        "rows_per_s": {name: t[name][2] / t[name][0] * 1e3
                       for name in (FK, GROUPBY, OUTER)},
        "mean_rel_err": max(op_errs["mean_rel_err"],
                            plan_errs["mean_rel_err"]),
        "plan_paths_ms": {name: {"port": t[name][0], "oracle": t[name][1],
                                 "rows": t[name][2]}
                          for name in PLAN_PATHS},
        "d_sort_ms": {"split_sort_merge": t["split19_ms"],
                      "padded_network": t["split29_ms"]},
        "network_paths_ms": {name: {"bitonic": t[name][0], "radix": t[name][1],
                                    "oracle": t[name][2]}
                             for name in NET_PATHS},
        "sort_large_ms": {name: {"sort_large": large_ms[name][0],
                                 "rt_sort": large_ms[name][1],
                                 "torch_sort": large_ms[name][2],
                                 "rows": large_ms[name][3],
                                 "phase_a": large_ms[name][4],
                                 "phase_b": large_ms[name][5],
                                 "cap": large_ms[name][6][0],
                                 "group": large_ms[name][6][1],
                                 "buckets": large_ms[name][6][2]}
                          for name in LARGE_PATHS},
        "reference_engine_ms": {name: {"reference": large_ms[name][0],
                                       "radix": large_ms[name][1]}
                                for name in REF_PATHS},
        "compat_paths_ms": compat_ms,
        "external_paths_s": external_s,
        "distributed_paths_ms": dist_ms,
        "sort_2_31_ms": TIMES_2_31["sort_ms"],
        "surface": surface, "card_unsigned_gaps": card_ops}
    for k in record["kernels"]:
        k["launches_distributed"] = dist_launches.get(k["name"], 0)
    if ab is not None:
        record["parent_ab"] = ab
    log(smi)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
