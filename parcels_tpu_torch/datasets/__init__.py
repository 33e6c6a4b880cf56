"""Idealized datasets for tests and the chip smoke run."""

from parcels_tpu_torch.datasets.structured import moving_eddy_dataset, simple_UV_dataset

__all__ = ["moving_eddy_dataset", "simple_UV_dataset"]
