"""Idealized datasets for tests and the chip smoke run."""

from parcels_tpu_torch.datasets.moi import moi_like_fieldset, moi_like_inputs
from parcels_tpu_torch.datasets.structured import (
    curvilinear_rotated_dataset,
    decaying_moving_eddy_dataset,
    moving_eddy_dataset,
    peninsula_dataset,
    radial_rotation_dataset,
    simple_UV_dataset,
    stommel_gyre_dataset,
)
from parcels_tpu_torch.datasets.unstructured import delaunay_flow_dataset, fesom2_style_dataset

__all__ = [
    "curvilinear_rotated_dataset",
    "decaying_moving_eddy_dataset",
    "delaunay_flow_dataset",
    "fesom2_style_dataset",
    "moi_like_fieldset",
    "moi_like_inputs",
    "moving_eddy_dataset",
    "peninsula_dataset",
    "radial_rotation_dataset",
    "simple_UV_dataset",
    "stommel_gyre_dataset",
]
