"""Flagship end-to-end pipelines ("models"): BASELINE.json's sort, join and
query configurations on the card."""

from cuda.radixsort_tpu_torch.models.flagships import REGISTRY  # noqa: F401
