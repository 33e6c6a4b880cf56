"""Idealized datasets for tests and the chip smoke run."""

from parcels_tpu_torch.datasets.moi import moi_like_fieldset, moi_like_inputs
from parcels_tpu_torch.datasets.structured import (
    curvilinear_rotated_dataset,
    moving_eddy_dataset,
    peninsula_dataset,
    simple_UV_dataset,
)

__all__ = [
    "curvilinear_rotated_dataset",
    "moi_like_fieldset",
    "moi_like_inputs",
    "moving_eddy_dataset",
    "peninsula_dataset",
    "simple_UV_dataset",
]
