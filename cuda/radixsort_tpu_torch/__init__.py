"""cuda.radixsort_tpu_torch — the PyTorch + CUDA port of cuda.radixsort_tpu.

The LSD radix-sort path, the comparison network, the query operators
built on them and the query layer over those (Table, Query), on NVIDIA
Hopper: plain torch glue around five hand-written CUDA kernels
(``csrc/``): the all-digit histogram, the stable counting pass, the
segmented scan, and the network's shared-memory tile and register cross
kernels. The JAX package ``cuda.radixsort_tpu`` is the
reference it is tested against; this package never imports JAX.

Public API (parity: CUB ``device_radix_sort.cuh``, ``device_scan.cuh``,
``device_merge.cuh``, ``device_segmented_radix_sort.cuh``; thrust set ops):
    sort, sort_pairs, argsort, sort_struct   — radix sort, or the network
                                               (SortConfig(engine="bitonic"))
                                               or the plain reference
                                               (engine="reference")
    sort_large                               — MSD partition on the kernels,
                                               then bucket sorts in batches
    segmented_sort                           — stable sort per segment
    merge_sorted, merge_sorted_pairs         — stable two-way merge
    set_intersection, set_difference,
    set_union, set_symmetric_difference      — sorted multiset algebra
    filter_columns, selection_vector         — stable compaction
    join, join_count, join_expand            — sort-coalesce equality joins
    groupby, groupby_multi, groupby_quantile — sort + segmented-scan group-by
    segmented_scan, scan_by_key              — scans that restart at heads
    partition, bucket_ids, hash32            — stable radix/hash partition
    unique, run_length_encode,
    non_trivial_runs, distinct               — runs over sorted keys
    kth_value, top_k                         — radix select
    digit_histogram, histogram_even,
    histogram_range                          — device-wide histograms
    window                                   — OVER (PARTITION BY p ORDER BY o)
    comparator_sort, comparator_argsort      — sort by any comparator
    sort_external, sort_external_pairs       — host arrays larger than the
                                               card: chunk sorts + host merge
    Table, table, Query                      — column batches and query plans
    SortConfig, preset, resolve, best_engine — tuning policy

CUB- and thrust-shaped surfaces: ``cub_compat`` (DeviceRadixSort and the
rest of CUB's device-wide suite) and ``thrust_compat``. Measurement:
``utils/profiling.py`` (CUDA-event timers, ``speed_of_light``, the
network's bytes model, ``trace``).

``python -m cuda.radixsort_tpu_torch`` runs a one-command self-test.
"""

from cuda.radixsort_tpu_torch.config import (  # noqa: F401
    SortConfig,
    best_engine,
    preset,
    resolve,
)
from cuda.radixsort_tpu_torch.ops.sort import (  # noqa: F401
    argsort,
    sort,
    sort_large,
    sort_pairs,
    sort_struct,
)
from cuda.radixsort_tpu_torch.ops.filter import (  # noqa: F401
    filter_columns,
    selection_vector,
)
from cuda.radixsort_tpu_torch.ops.join import (  # noqa: F401
    join,
    join_count,
    join_expand,
)
from cuda.radixsort_tpu_torch.ops.aggregate import (  # noqa: F401
    groupby,
    groupby_multi,
    groupby_quantile,
)
from cuda.radixsort_tpu_torch.ops.scan import scan_by_key, segmented_scan  # noqa: F401
from cuda.radixsort_tpu_torch.ops.segmented import segmented_sort  # noqa: F401
from cuda.radixsort_tpu_torch.ops.merge import (  # noqa: F401
    merge_sorted,
    merge_sorted_pairs,
)
from cuda.radixsort_tpu_torch.ops.setops import (  # noqa: F401
    set_difference,
    set_intersection,
    set_symmetric_difference,
    set_union,
)
from cuda.radixsort_tpu_torch.ops.partition import (  # noqa: F401
    bucket_ids,
    hash32,
    partition,
)
from cuda.radixsort_tpu_torch.ops.unique import (  # noqa: F401
    distinct,
    non_trivial_runs,
    run_length_encode,
    unique,
)
from cuda.radixsort_tpu_torch.ops.select import kth_value, top_k  # noqa: F401
from cuda.radixsort_tpu_torch.ops.histogram import (  # noqa: F401
    digit_histogram,
    histogram_even,
    histogram_range,
)
from cuda.radixsort_tpu_torch.ops.window import window  # noqa: F401
from cuda.radixsort_tpu_torch.ops.comparator_sort import (  # noqa: F401
    comparator_argsort,
    comparator_sort,
)
from cuda.radixsort_tpu_torch.ops.external import (  # noqa: F401
    sort_external,
    sort_external_pairs,
)
from cuda.radixsort_tpu_torch.table import Table, table  # noqa: F401
from cuda.radixsort_tpu_torch.pipeline.plan import Query  # noqa: F401
from cuda.radixsort_tpu_torch import twiddle  # noqa: F401

__version__ = "0.5.0"
