"""Tutorial datasets (capability parity with reference src/parcels/tutorial.py).

Copy of the JAX package's ``tutorial.py``. The reference downloads example
data with pooch; ``open_dataset`` serves the idealized datasets the port
generates in memory (the fixture family the reference ships in
``_datasets/structured``), and downloads nothing.
"""

from __future__ import annotations

from parcels_tpu_torch.datasets import (
    decaying_moving_eddy_dataset,
    moving_eddy_dataset,
    peninsula_dataset,
    radial_rotation_dataset,
    simple_UV_dataset,
    stommel_gyre_dataset,
)
from parcels_tpu_torch.datasets.moi import moi_like_inputs
from parcels_tpu_torch.datasets.structured import curvilinear_rotated_dataset, padded_variant_dataset
from parcels_tpu_torch.datasets.unstructured import delaunay_flow_dataset, fesom2_style_dataset

__all__ = ["list_datasets", "open_dataset"]

def _moi_like_sgrid(**kw):
    from parcels_tpu_torch import convert

    fields, coords = moi_like_inputs(**kw)
    return convert.nemo_to_sgrid(fields=fields, coords=coords)


_DATASETS = {
    "simple_UV": simple_UV_dataset,
    "radial_rotation": radial_rotation_dataset,
    "moving_eddy": moving_eddy_dataset,
    "decaying_moving_eddy": decaying_moving_eddy_dataset,
    "peninsula": peninsula_dataset,
    "stommel_gyre": stommel_gyre_dataset,
    "delaunay_flow": delaunay_flow_dataset,
    "curvilinear_rotated": curvilinear_rotated_dataset,
    "padded_variant": padded_variant_dataset,
    "fesom2_style": fesom2_style_dataset,
    "moi_like": _moi_like_sgrid,
}


def list_datasets() -> list[str]:
    return sorted(_DATASETS)


def open_dataset(name: str, **kwargs):
    """Open a named tutorial dataset (generated in memory, no download)."""
    try:
        factory = _DATASETS[name]
    except KeyError:
        raise ValueError(
            f"Unknown tutorial dataset {name!r}. Available: {list_datasets()}"
        ) from None
    return factory(**kwargs)
