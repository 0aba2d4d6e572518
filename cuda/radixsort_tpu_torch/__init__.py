"""cuda.radixsort_tpu_torch — the PyTorch + CUDA port of cuda.radixsort_tpu.

The LSD radix-sort path on NVIDIA Hopper: the key twiddle and limb split
in plain torch, and two hand-written CUDA kernels (``csrc/``): the
all-digit histogram and the stable counting pass. The JAX package
``cuda.radixsort_tpu`` is the reference it is tested against; this package
never imports JAX.

Public API (parity: CUB ``device_radix_sort.cuh``):
    sort, sort_pairs, argsort, sort_struct — stable radix sort
    SortConfig, preset, resolve            — tuning policy
"""

from cuda.radixsort_tpu_torch.config import SortConfig, preset, resolve  # noqa: F401
from cuda.radixsort_tpu_torch.ops.sort import (  # noqa: F401
    argsort,
    sort,
    sort_pairs,
    sort_struct,
)
from cuda.radixsort_tpu_torch import twiddle  # noqa: F401

__version__ = "0.1.0"
