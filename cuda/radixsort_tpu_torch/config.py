"""Sort configuration for the PyTorch/CUDA port — the counterpart of
``cuda.radixsort_tpu.config`` (itself the analogue of CUB's policy hub,
``dispatch/tuning/tuning_radix_sort.cuh``).

A small frozen dataclass holds the digit width, the CUDA tile geometry of
the stage kernel, the engine and the network's split-sort threshold.
``preset()`` is keyed on the card's compute capability. The network
kernels' geometry follows from the two limits below
(``kernels/bitonic.py::tile_log_rows`` / ``cross_strides``). Nothing here
reads an environment variable.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

ENGINES = ("auto", "radix", "bitonic", "reference")

MAX_PLANES = 4            # u32 planes the network kernels carry
SMEM_BYTES = 232448       # shared memory one block may use (227 KB, sm_90)
MAX_CROSS_WORDS = 64      # 2^c * planes words a cross-kernel thread holds
MAX_TILE_WORDS = 32       # 2^e * planes words a tile-kernel thread holds
MAX_TILE_THREADS = 256    # threads of one tile-kernel block
TILE_BLOCKS_PER_SM = 2    # tile-kernel blocks that share one SM
STAGE_ITEMS = (4, 8, 16, 32)  # keys per thread the stage kernel is built for
MAX_STAGE_THREADS = 512   # the stage kernel's __launch_bounds__
HIST_MAX_LIMBS = 32       # limb columns one histogram launch counts
HIST_TABLE_BINS = 1024    # bins of a histogram block's table: a u32 limb's
#                           4 bytes x 256, a column per lane (128 KB)


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Static configuration of one sort.

    Attributes:
      radix_bits: digit width of one counting pass, 2, 4 or 8 (8 = 256 bins,
        the contract's digit width: a u32 sort is 4 passes); the
        'reference' engine takes any width from 1 to 16.
      block_threads: threads per block of the stage kernel (a multiple of
        32, at most 512: the kernel is built for 512 threads a block, so a
        thread keeps up to 128 registers for its keys and their slots; its
        shared memory, ``kernels/stage.py::stage_smem_bytes``, then stays
        under ``SMEM_BYTES`` for every tile these limits allow).
      items_per_thread: keys each thread ranks per tile, one of
        ``STAGE_ITEMS`` (the kernel holds them in registers, one build per
        value); a tile holds ``block_threads * items_per_thread`` keys.
      engine: 'auto' (= 'radix'), 'radix' (the LSD pipeline),
        'bitonic' (the comparison network, kernels/bitonic.py) or
        'reference' (the LSD pipeline in plain torch with CUB's tile and
        spine layout, ``ops/sort.py::counting_pass_reference``: an oracle
        that runs only where it is named; 'auto' never picks it).
      split_sort_min_logn: a network sort padded by a quarter or more takes
        the split-sort-merge route from 2^this padded rows up (at least 11).
    """

    radix_bits: int = 8
    block_threads: int = 256
    items_per_thread: int = 32
    engine: str = "auto"
    split_sort_min_logn: int = 19

    def __post_init__(self):
        if self.engine == "reference":
            if not 1 <= self.radix_bits <= 16:
                raise ValueError("the reference engine takes radix_bits 1-16;"
                                 f" got {self.radix_bits}")
        elif self.radix_bits not in (2, 4, 8):
            raise ValueError(f"radix_bits must be 2, 4 or 8; got {self.radix_bits}")
        if (self.block_threads % 32
                or not 32 <= self.block_threads <= MAX_STAGE_THREADS):
            raise ValueError("block_threads must be a multiple of 32 in "
                             f"[32, {MAX_STAGE_THREADS}]; got "
                             f"{self.block_threads}")
        if self.items_per_thread not in STAGE_ITEMS:
            raise ValueError(f"items_per_thread must be one of {STAGE_ITEMS};"
                             f" got {self.items_per_thread}")
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}; got {self.engine!r}")
        if self.split_sort_min_logn < 11:
            raise ValueError("split_sort_min_logn must be at least 11; got "
                             f"{self.split_sort_min_logn}")

    @property
    def num_bins(self) -> int:
        return 1 << self.radix_bits

    @property
    def tile_elems(self) -> int:
        return self.block_threads * self.items_per_thread

    def replace(self, **kw) -> "SortConfig":
        return dataclasses.replace(self, **kw)


@functools.cache
def default_backend() -> str:
    """'cuda' where a card is present, else 'cpu'."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def best_engine(platform: str | None = None) -> str:
    """The fastest full-sort engine: 'radix' on every platform.

    On the card (NVIDIA H100 80GB HBM3, 700 W power limit) the radix
    pipeline led the network on every sort path measured: config 1's 2^24
    u32 sort, config 2's 2^28 pairs stable and unstable, the FK join and
    the segmented sort (PERF.md, sections 5-7). The network led only on
    the 2^28 pair merge, which is not a full sort. On the CPU the kernels
    run their plain versions and the radix route is the one the tests
    hold against the reference. ``platform`` is accepted for the JAX
    signature and does not change the answer."""
    return "radix"


# Per-architecture presets, keyed on torch.cuda.get_device_capability().
# (9, 0): H100 / H200: 256 threads x 32 keys = 8192-key tiles, 8-bit digits.
# `chip_smoke.py --profile` sweeps radix_bits 4/8, block_threads 128/256/512
# and items_per_thread 8/16/32 on the card; with the onesweep stage kernel
# this was the fastest on config 2; on config 1 the sweeps disagree
# (PERF.md): one preset serves both, and config 2's size decides.
_PRESETS = {
    (9, 0): dict(radix_bits=8, block_threads=256, items_per_thread=32,
                 split_sort_min_logn=19),
}


def preset(capability: tuple[int, int] | None = None) -> SortConfig:
    """The preset for a compute capability (default: the current card's).

    Without a card the (9, 0) preset is returned: on the CPU the wrappers
    run their plain versions and the geometry is never used."""
    if capability is None:
        capability = (torch.cuda.get_device_capability()
                      if torch.cuda.is_available() else (9, 0))
    capability = tuple(capability)
    if capability not in _PRESETS:
        raise ValueError(f"no preset for compute capability {capability}; "
                         f"known: {sorted(_PRESETS)}")
    return SortConfig(**_PRESETS[capability])


def for_partition(cfg: SortConfig, bits: int | None = None) -> SortConfig:
    """The configuration of a partition-class op (filter, selection vector)
    whose keys hold ``bits`` significant bits. The network engine cannot
    sort a bit range, so 'bitonic' becomes 'radix'; keys of at most 2 bits
    take 2-bit digits, one counting pass into 4 buckets."""
    if cfg.engine == "bitonic":
        cfg = cfg.replace(engine="radix")
    if bits is not None and bits <= 2:
        cfg = cfg.replace(radix_bits=2)
    return cfg


def resolve(config: SortConfig | None = None, **overrides) -> SortConfig:
    """The configuration a call runs with: ``config`` (default: the
    preset) with ``overrides`` applied, then 'auto' resolved to
    :func:`best_engine`. The network and the reference engine run only
    where they are named."""
    cfg = config or preset()
    if overrides:
        cfg = cfg.replace(**overrides)
    if cfg.engine == "auto":
        cfg = cfg.replace(engine=best_engine())
    return cfg
