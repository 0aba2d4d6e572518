"""Carry state across from the JAX package: arrays and tables bit for bit,
and config.

The system has no weights: its data and its sort configuration are the
state. Arrays move through numpy. Every key and payload dtype crosses
bit-for-bit; unsigned 32/64-bit arrays become ``torch.uint32`` /
``torch.uint64`` views, and bfloat16 travels as a uint16 view (``ml_dtypes``
is imported only when a bfloat16 array is converted back to numpy, so this
module imports without it).
"""

from __future__ import annotations

import numpy as np
import torch

from cuda.radixsort_tpu_torch import config as config_lib
from cuda.radixsort_tpu_torch.table import Table

# unsigned numpy dtype -> (same-width signed numpy dtype, torch dtype)
_BY_NUMPY = {
    np.dtype(np.uint16): (np.int16, torch.uint16),
    np.dtype(np.uint32): (np.int32, torch.uint32),
    np.dtype(np.uint64): (np.int64, torch.uint64),
}
_TO_NUMPY_VIA = {
    torch.uint16: (torch.int16, np.uint16),
    torch.uint32: (torch.int32, np.uint32),
    torch.uint64: (torch.int64, np.uint64),
}


def from_numpy(arr, device="cuda") -> torch.Tensor:
    """numpy array (any key or payload dtype, bfloat16 included) -> tensor
    on ``device`` (the card unless the caller asks for the CPU) with the
    same bits. Always copies."""
    a = np.ascontiguousarray(np.asarray(arr))
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    elif a.dtype in _BY_NUMPY:
        signed, tdt = _BY_NUMPY[a.dtype]
        t = torch.from_numpy(a.view(signed).copy()).view(tdt)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy array with the same bits (bfloat16 as ml_dtypes)."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if t.dtype in _TO_NUMPY_VIA:
        signed, ndt = _TO_NUMPY_VIA[t.dtype]
        return t.view(signed).numpy().view(ndt)
    return t.numpy()


def table_from_numpy(columns: dict, device):
    """A port Table of numpy columns, each bit for bit (:func:`from_numpy`),
    on ``device``: the data counterpart of carrying weights across."""
    return Table({k: from_numpy(v, device) for k, v in columns.items()})


def tree_from_numpy(tree, device="cuda"):
    """Apply :func:`from_numpy` to every leaf of a tensor/list/tuple/dict."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, device) for v in tree)
    return from_numpy(tree, device)


# JAX engine -> port engine. 'pallas' is the LSD radix pipeline and
# 'reference' the plain one of the same name; 'xla' is a stable lax.sort,
# which any stable engine reproduces bit for bit, so it maps to 'auto'.
# 'bitonic' maps to the port's network engine, which runs the JAX engine's
# default network (its log_tile of 16, or 15 from 3 planes up) and so lands
# unstable ties where it does.
_ENGINE_OF = {"auto": "auto", "pallas": "radix", "reference": "reference",
              "xla": "auto", "bitonic": "bitonic"}


def config_from_jax(cfg) -> config_lib.SortConfig:
    """Map a ``cuda.radixsort_tpu.SortConfig`` onto the port's SortConfig.

    The digit width follows the JAX Pallas pipeline's clamp (2-bit stages
    for radix_bits <= 3, 4-bit up to 7) and keeps 8 where JAX asks for 8 or
    more; the reference engine keeps JAX's width, as both honour any. The
    TPU geometry has no meaning here and is dropped: tile_rows
    and stage_rows are the radix kernels' VMEM tiles, and log_tile and
    log_merge the network kernels' VMEM blocks (a JAX config that sets
    log_tile also changes its network, which the port does not follow)."""
    rb = cfg.radix_bits
    engine = _ENGINE_OF[cfg.engine]
    if engine != "reference":
        rb = 2 if rb <= 3 else (4 if rb <= 7 else 8)
    return config_lib.preset((9, 0)).replace(radix_bits=rb, engine=engine)


def blocks(x, ndev: int) -> list:
    """A global array sharded over ``ndev`` devices along its first axis
    (a JAX ``shard_map`` output, say) -> the ``ndev`` per-device blocks as
    numpy arrays, the blocks the port's ranks return."""
    a = np.asarray(x)
    return list(a.reshape((ndev, -1) + a.shape[1:]))


def stats_to_numpy(st) -> dict:
    """An ExchangeStats of either package (any NamedTuple of arrays or
    tensors) -> {field: numpy array}."""
    return {k: (to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in st._asdict().items()}
