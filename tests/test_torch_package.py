"""Package boundary of the port: it imports without JAX, never names it,
its kernel build fails loudly where nvcc is absent, and every public name
of the JAX package has a counterpart in it but a stated TPU-only set."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import cuda.radixsort_tpu_torch as rt
from torch_surface import public_names as _public_names
from cuda.radixsort_tpu_torch.kernels import bitonic, histogram, scan, stage
from cuda.radixsort_tpu_torch.utils import build

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "cuda" / "radixsort_tpu_torch"


def test_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['jaxlib'] = None; "
            "import cuda.radixsort_tpu_torch as rt; "
            "import cuda.radixsort_tpu_torch.utils.convert, "
            "cuda.radixsort_tpu_torch.utils.profiling, "
            "cuda.radixsort_tpu_torch.models.flagships, "
            "cuda.radixsort_tpu_torch.kernels.bitonic, "
            "cuda.radixsort_tpu_torch.ops.merge, "
            "cuda.radixsort_tpu_torch.ops.segmented, "
            "cuda.radixsort_tpu_torch.ops.setops, "
            "cuda.radixsort_tpu_torch.ops.partition, "
            "cuda.radixsort_tpu_torch.ops.unique, "
            "cuda.radixsort_tpu_torch.ops.select, "
            "cuda.radixsort_tpu_torch.ops.histogram, "
            "cuda.radixsort_tpu_torch.ops.window, "
            "cuda.radixsort_tpu_torch.table, "
            "cuda.radixsort_tpu_torch.pipeline.query, "
            "cuda.radixsort_tpu_torch.pipeline.plan, "
            "cuda.radixsort_tpu_torch.cub_compat, "
            "cuda.radixsort_tpu_torch.thrust_compat, "
            "cuda.radixsort_tpu_torch.ops.comparator_sort, "
            "cuda.radixsort_tpu_torch.ops.external, "
            "cuda.radixsort_tpu_torch.utils.native, "
            "cuda.radixsort_tpu_torch.parallel.comm, "
            "cuda.radixsort_tpu_torch.parallel.stats, "
            "cuda.radixsort_tpu_torch.parallel.dsort, "
            "cuda.radixsort_tpu_torch.parallel.shuffle, "
            "cuda.radixsort_tpu_torch.parallel.dscan, "
            "cuda.radixsort_tpu_torch.parallel.dselect, "
            "cuda.radixsort_tpu_torch.__main__; "
            "import torch; "
            "net = rt.SortConfig(engine='bitonic'); "
            "print(rt.sort(torch.tensor([3, 1, 2])).tolist(), "
            "rt.sort(torch.tensor([3, 1, 2]), config=net).tolist())")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[1, 2, 3] [1, 2, 3]"


def test_no_source_file_names_jax():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax)", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 14
    assert {"comm.py", "stats.py", "dsort.py", "shuffle.py", "dscan.py",
            "dselect.py"} <= {p.name for p in PKG.glob("parallel/*.py")}
    for path in files:
        assert not pattern.search(path.read_text()), path


def test_build_raises_without_nvcc():
    if build.shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present on this machine")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library()
    with pytest.raises(RuntimeError, match="nvcc"):
        build._build()


def test_every_kernel_has_a_source_and_a_counter():
    names = {os.path.basename(p) for p in build.sources()}
    assert names == {"bitonic.cu", "histogram.cu", "scan.cu", "stage.cu"}
    for mod in (histogram, scan, stage):
        assert isinstance(mod.LAUNCHES, int)
    assert isinstance(bitonic.TILE_LAUNCHES, int)
    assert isinstance(bitonic.CROSS_LAUNCHES, int)
    for name in ("rs_bitonic_tile", "rs_bitonic_cross"):
        assert name in build._SIGNATURES
    for src in build.sources():
        text = open(src).read()
        assert "Replaces: cuda/radixsort_tpu/kernels/" in text
        assert re.search(r'extern "C" int rs_\w+', text)


def test_kernel_limits_are_set_once():
    # every limit a source reads is a macro of the header build.py writes
    # from config.py; no source defines one itself
    header = build.limits_header()
    defined = set(re.findall(r"#define (RS_\w+) ", header))
    assert f"#define RS_MAX_TILE_WORDS {rt.config.MAX_TILE_WORDS}\n" in header
    assert "#define RS_STAGE_ITEMS 4, 8, 16, 32\n" in header
    used = set()
    for src in build.sources():
        text = open(src).read()
        assert "#define RS_" not in text, src
        used |= set(re.findall(r"\b(RS_[A-Z_]+)\b", text))
    assert used == defined


def test_non_cpu_device_never_falls_back():
    keys = torch.empty(8, dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="device"):
        histogram.digit_histograms(keys, n_stages=4, width=8)
    gb = torch.empty(256, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        stage.partition_stage([keys], gb, shift=0, width=8)
    flags = torch.empty(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="device"):
        scan.segmented_scan(keys, flags, "sum")
    with pytest.raises(ValueError, match="device"):
        bitonic.sort_planes_bitonic([keys])
    with pytest.raises(ValueError, match="device"):
        bitonic.merge_sorted_planes_bitonic([keys], log_block=2)
    # the operators on the histogram kernel raise too: one digit of a width
    # the kernel takes, and the 8-bit route of the other widths
    for bits in (4, 3):
        with pytest.raises(ValueError, match="device"):
            rt.digit_histogram(keys, bits=bits)


def test_version_and_surface():
    assert rt.__version__
    for name in ("sort", "sort_pairs", "argsort", "sort_struct",
                 "SortConfig", "preset", "resolve", "filter_columns",
                 "selection_vector", "join", "join_count", "join_expand",
                 "groupby", "groupby_multi", "groupby_quantile",
                 "segmented_scan", "scan_by_key", "segmented_sort",
                 "merge_sorted", "merge_sorted_pairs", "set_intersection",
                 "set_difference", "set_union", "set_symmetric_difference",
                 "Table", "table", "Query", "partition", "bucket_ids",
                 "hash32", "kth_value", "top_k", "window", "unique",
                 "run_length_encode", "non_trivial_runs", "distinct",
                 "digit_histogram", "histogram_even", "histogram_range",
                 "comparator_sort", "comparator_argsort", "sort_external",
                 "sort_external_pairs", "sort_large", "best_engine"):
        assert hasattr(rt, name)


# Public names of the JAX package that the port leaves out, each TPU-only:
# (module path under the package, name) -> the reason.
_VMEM = "a TPU tile constant (lanes, sublane rows, VMEM tile and chunk sizes)"
TPU_ONLY = {
    **{("__init__.py", "LANES"): _VMEM, ("config.py", "LANES"): _VMEM,
       ("kernels/bitonic.py", "LANES"): _VMEM,
       ("kernels/bitonic.py", "LOG_LANES"): _VMEM,
       ("kernels/tiles.py", "LANES"): _VMEM},
    **{("kernels/histogram.py", n): _VMEM for n in ("NB", "NSTAGES", "ROWS")},
    **{("kernels/pipeline.py", n): _VMEM for n in ("ROWS", "TILE")},
    **{("kernels/stage.py", n): _VMEM
       for n in ("CHUNK", "NB", "ROWS", "SROWS", "W")},
    **{("kernels/tiles.py", n): "the TPU's in-row rank helpers: no "
       "pallas_call, and the card ranks with shared memory and shuffles"
       for n in ("NB", "bucket_count_table", "field", "field_dyn",
                 "inrow_sort", "lane_inclusive_prefix", "packed_words",
                 "row_tables")},
    ("config.py", "device_kind"): "the TPU generation string",
    ("config.py", "generation"): "the TPU generation presets",
    ("kernels/bitonic.py", "resolve_log_merge"):
        "the TPU merge kernel's VMEM block",
    ("kernels/pipeline.py", "stage_width"):
        "the TPU stage kernel's 2- or 4-bit clamp (the card runs 2, 4 and 8; "
        "utils/convert.py::config_from_jax applies the clamp)",
    ("kernels/pipeline.py", "tile_elems"):
        "the TPU stage kernel's VMEM tile (the card's is "
        "SortConfig.tile_elems)",
    ("kernels/pipeline.py", "sort_limbs_pallas"):
        "the Pallas entry name; the port's is kernels/pipeline.py::sort_limbs",
    ("kernels/scan.py", "segmented_scan_pallas"):
        "the Pallas entry name; the port's is kernels/scan.py::segmented_scan",
    ("utils/profiling.py", "DEFAULT_HBM"):
        "a TPU's memory rate as the default; the port has no default rate",
}


def test_every_public_jax_name_has_a_port_counterpart():
    jax_pkg = REPO / "cuda" / "radixsort_tpu"
    modules = sorted(jax_pkg.rglob("*.py"))
    assert len(modules) >= 40
    missing, seen = [], set()
    for path in modules:
        rel = path.relative_to(jax_pkg).as_posix()
        port = PKG / rel
        theirs = _public_names(path)
        seen |= {(rel, n) for n in theirs}
        mine = _public_names(port) if port.exists() else set()
        missing += [(rel, n) for n in sorted(theirs - mine)
                    if (rel, n) not in TPU_ONLY]
    assert missing == [], missing
    # every exemption still names a public JAX name
    assert set(TPU_ONLY) <= seen, set(TPU_ONLY) - seen
