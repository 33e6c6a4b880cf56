"""Idealized datasets for tests, tutorials and the chip smoke run."""

from parcels_tpu_torch.datasets.moi import moi_like_fieldset, moi_like_inputs
from parcels_tpu_torch.datasets.remote import list_remote_datasets, open_remote_dataset
from parcels_tpu_torch.datasets.structured import (
    curvilinear_rotated_dataset,
    decaying_moving_eddy_dataset,
    generic_datasets,
    moving_eddy_dataset,
    padded_variant_dataset,
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
    "generic_datasets",
    "list_remote_datasets",
    "moi_like_fieldset",
    "moi_like_inputs",
    "moving_eddy_dataset",
    "open_remote_dataset",
    "padded_variant_dataset",
    "peninsula_dataset",
    "radial_rotation_dataset",
    "simple_UV_dataset",
    "stommel_gyre_dataset",
]
