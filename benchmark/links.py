"""The cards' link rates, by the name ``torch.cuda.get_device_name()``
gives. NVIDIA's data sheet for the H100 SXM5: NVLink 4 at 900 GB/s in all,
450 GB/s in each direction, which is what one card can send. A card not
listed here has no rate, and a metric read against it gives nothing."""

from __future__ import annotations

NVLINK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 450e9}


def nvlink_bytes_per_s(card: str) -> float | None:
    return NVLINK_BYTES_PER_S.get(card)
