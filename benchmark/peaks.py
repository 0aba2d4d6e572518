"""The card's peaks, by the name ``torch.cuda.get_device_name()`` gives.

NVIDIA's data sheet for the H100 SXM: 3.35 TB/s of HBM3 at the full power
limit of 700 W. No default: a card not listed here stops a traced run
until its own data sheet's rate is added. A card set below 700 W runs
slower under load, so the power limit is read and printed beside every
run's numbers."""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_bytes_per_s(card: str) -> float:
    if card not in HBM_BYTES_PER_S:
        raise KeyError(f"no memory rate for {card!r} in "
                       "benchmark/peaks.py::HBM_BYTES_PER_S")
    return HBM_BYTES_PER_S[card]


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())
