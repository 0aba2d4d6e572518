"""cuda.radixsort_tpu_torch — the PyTorch + CUDA port of cuda.radixsort_tpu.

The LSD radix-sort path and the query operators built on it, on NVIDIA
Hopper: plain torch glue around three hand-written CUDA kernels
(``csrc/``): the all-digit histogram, the stable counting pass and the
segmented scan. The JAX package ``cuda.radixsort_tpu`` is the reference it
is tested against; this package never imports JAX.

Public API (parity: CUB ``device_radix_sort.cuh``, ``device_scan.cuh``):
    sort, sort_pairs, argsort, sort_struct   — stable radix sort
    filter_columns, selection_vector         — stable compaction
    join, join_count, join_expand            — sort-coalesce equality joins
    groupby, groupby_multi, groupby_quantile — sort + segmented-scan group-by
    segmented_scan, scan_by_key              — scans that restart at heads
    SortConfig, preset, resolve              — tuning policy
"""

from cuda.radixsort_tpu_torch.config import SortConfig, preset, resolve  # noqa: F401
from cuda.radixsort_tpu_torch.ops.sort import (  # noqa: F401
    argsort,
    sort,
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
from cuda.radixsort_tpu_torch import twiddle  # noqa: F401

__version__ = "0.2.0"
