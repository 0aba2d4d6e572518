"""Single-GPU operator layer: sort, partition, join, aggregate, filter,
select. As in the JAX package, the names below bind ``ops.sort`` to the
function; import the module as ``cuda.radixsort_tpu_torch.ops.sort``
through ``importlib`` or ``from cuda.radixsort_tpu_torch.ops.sort import``."""

from cuda.radixsort_tpu_torch.ops.sort import argsort, sort, sort_pairs  # noqa: F401
from cuda.radixsort_tpu_torch.ops.select import kth_value, top_k  # noqa: F401
