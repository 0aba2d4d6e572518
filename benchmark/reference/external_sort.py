"""Plain-torch reference of the ``external_sort`` calls, and their control.

Imports nothing of the program. The card's torch has no sort or compare
on uint32, so keys are ordered through their int32 view with the sign bit
flipped (its signed order is the unsigned order of the keys), as
``reference/cccl_sort.py`` orders them.
"""

from __future__ import annotations

import numpy as np
import torch

SIGN = -2**31


def expected(keys: torch.Tensor) -> torch.Tensor:
    """The u32 keys (a tensor) in ascending order, sorted where they lie."""
    flipped = keys.view(torch.int32) ^ SIGN
    return (torch.sort(flipped).values ^ SIGN).view(torch.uint32)


def mismatched_rows(got: torch.Tensor, want: torch.Tensor) -> int:
    """Rows whose bits differ from the reference's; every row where the
    lengths differ."""
    if got.shape != want.shape:
        return max(got.numel(), want.numel())
    return int((got.view(torch.int32) != want.view(torch.int32)).sum())


def control(name: str, keys: np.ndarray, chunk: int, device="cuda"
            ) -> np.ndarray:
    """The reference with one of the configuration's guarantees broken:

    runs_concatenated  each chunk of ``chunk`` rows sorted on ``device``
                       and the runs left unmerged, in input order: exact
                       order broken wherever there are two runs or more
    """
    if name != "runs_concatenated":
        raise ValueError(f"no control {name!r}")
    out = np.empty_like(keys)
    for lo in range(0, keys.shape[0], chunk):
        piece = torch.from_numpy(keys[lo: lo + chunk].view(np.int32))
        run = expected(piece.to(device).view(torch.uint32))
        out[lo: lo + chunk] = run.view(torch.int32).cpu().numpy() \
            .view(np.uint32)
    return out
