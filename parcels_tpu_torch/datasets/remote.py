"""Remote-dataset registry (capability parity with reference
_datasets/remote.py:205-320).

The reference downloads these through pooch. The port downloads nothing: it
has no download tier, by design, and serves two tiers:

1. **Cache-backed** entries: if ``PARCELS_DATA_HOME`` (default
   ``~/.parcels_tpu_data``) holds a file or zarr store of the registry name,
   it is opened from there with the port's own readers (``io``).
2. **Local-equivalent** entries (the benchmark datasets): generated in
   memory at reduced resolution with the same structure, a MOi-shaped global
   curvilinear C-grid (datasets/moi.py) and a FESOM2-style unstructured set.

Everything else raises an error that names the registry entry and the
cache path to place a copy at, so user code written against the
reference's ``open_remote_dataset``/``list_remote_datasets`` API ports
unchanged and fails informatively. Where the JAX package would try the
network (its ``_try_download``), the port falls straight through to the
generated tier.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Literal

__all__ = ["list_remote_datasets", "open_remote_dataset"]

_TUTORIAL = "tutorial"
_TESTING = "testing"

# Registry names mirror reference _datasets/remote.py:214-258 exactly.
_REGISTRY: dict[str, str] = {
    "MITgcm_example_data/mitgcm_UV_surface_zonally_reentrant": _TUTORIAL,
    "CopernicusMarine_data_for_Argo_tutorial/data": _TUTORIAL,
    "Delft3D_data/Rotterdam_tiny": _TUTORIAL,
    "CopernicusMarine_data_for_stuck_particles_tutorial/data": _TUTORIAL,
    "FESOM_periodic_channel/fesom_channel": _TUTORIAL,
    "FESOM_periodic_channel/u.fesom_channel": _TUTORIAL,
    "FESOM_periodic_channel/v.fesom_channel": _TUTORIAL,
    "FESOM_periodic_channel/w.fesom_channel": _TUTORIAL,
    "SCHISM_LakeOntario/out2d": _TUTORIAL,
    "SCHISM_LakeOntario/horizontalVelX": _TUTORIAL,
    "SCHISM_LakeOntario/horizontalVelY": _TUTORIAL,
    "NemoCurvilinear_data_zonal/U": _TUTORIAL,
    "NemoCurvilinear_data_zonal/V": _TUTORIAL,
    "NemoCurvilinear_data_zonal/mesh_mask": _TUTORIAL,
    "NemoNorthSeaORCA025-N006_data/U": _TUTORIAL,
    "NemoNorthSeaORCA025-N006_data/V": _TUTORIAL,
    "NemoNorthSeaORCA025-N006_data/W": _TUTORIAL,
    "NemoNorthSeaORCA025-N006_data/mesh_mask": _TUTORIAL,
    "CROCOidealized_data/data": _TUTORIAL,
    "Benchmarks_FESOM2-baroclinic-gyre/data": _TESTING,
    "Benchmarks_FESOM2-baroclinic-gyre/grid": _TESTING,
    "Benchmarks_MOi_data_metadata-only/U": _TESTING,
    "Benchmarks_MOi_data_metadata-only/V": _TESTING,
    "Benchmarks_MOi_data_metadata-only/W": _TESTING,
    "Benchmarks_MOi_data_metadata-only/mesh": _TESTING,
}


def _data_home() -> Path:
    return Path(os.environ.get("PARCELS_DATA_HOME", "~/.parcels_tpu_data")).expanduser()


def _moi_component(component: str):
    """Reduced-resolution MOi-shaped local equivalent (the real entry is
    metadata-only zarr of the global 1/12-degree MOi fields)."""
    from parcels_tpu_torch import xrlite as xr
    from parcels_tpu_torch.datasets.moi import moi_like_inputs

    fields, coords = moi_like_inputs(xdim=120, ydim=80, zdim=8, tdim=2)
    if component == "mesh":
        return coords
    if component == "W":
        import numpy as np

        u = fields["vozocrtx"]
        name, da = "vovecrtz", xr.DataArray(
            1e-4 * np.asarray(u.values), ("time_counter", "depthw", "y", "x"),
            {"units": "m s-1", "standard_name": "upward_sea_water_velocity"}, name="vovecrtz")
    else:
        name = {"U": "vozocrtx", "V": "vomecrty"}[component]
        da = fields[name]
    ds = xr.Dataset({name: da}, coords={
        "time_counter": coords["time_counter"],
        "depthw": coords["depthw"],
    })
    return ds


def _fesom2_gyre(which: str):
    """FESOM2 baroclinic-gyre-shaped local equivalent (unstructured)."""
    from parcels_tpu_torch.datasets.unstructured import fesom2_style_dataset

    return fesom2_style_dataset(which=which)


_LOCAL_EQUIVALENTS = {
    "Benchmarks_MOi_data_metadata-only/U": lambda: _moi_component("U"),
    "Benchmarks_MOi_data_metadata-only/V": lambda: _moi_component("V"),
    "Benchmarks_MOi_data_metadata-only/W": lambda: _moi_component("W"),
    "Benchmarks_MOi_data_metadata-only/mesh": lambda: _moi_component("mesh"),
    "Benchmarks_FESOM2-baroclinic-gyre/data": lambda: _fesom2_gyre("data"),
    "Benchmarks_FESOM2-baroclinic-gyre/grid": lambda: _fesom2_gyre("grid"),
}


def list_remote_datasets(purpose: Literal["testing", "tutorial", "any"] = "any") -> list[str]:
    """Names of registered remote datasets (reference remote.py:260-282)."""
    if purpose == "any":
        return list(_REGISTRY)
    if purpose not in (_TESTING, _TUTORIAL):
        raise ValueError(f"purpose must be 'testing', 'tutorial' or 'any'. Got {purpose!r}")
    return [k for k, p in _REGISTRY.items() if p == purpose]


def open_remote_dataset(name: str, purpose: Literal["testing", "tutorial", "any"] = "any"):
    """Open a registered remote dataset (reference remote.py:284-320).

    Resolution order: local cache under ``PARCELS_DATA_HOME`` -> generated
    local equivalent (benchmark entries) -> an error naming the cache path.
    Nothing is downloaded.
    """
    if name not in _REGISTRY:
        available = list_remote_datasets(purpose)
        raise ValueError(f"Unknown remote dataset {name!r}. Available: {available}")

    cached = _data_home() / name
    for candidate in (cached, cached.with_suffix(".nc"), cached.with_suffix(".zarr")):
        if candidate.exists():
            if candidate.suffix == ".zarr" or candidate.is_dir():
                from parcels_tpu_torch.io import open_zarr_dataset

                return open_zarr_dataset(candidate)
            from parcels_tpu_torch.io import open_netcdf_dataset

            return open_netcdf_dataset(candidate)

    if name in _LOCAL_EQUIVALENTS:
        import warnings

        warnings.warn(
            f"No download tier: serving a generated reduced-resolution local "
            f"equivalent of {name!r}.",
            UserWarning,
            stacklevel=2,
        )
        return _LOCAL_EQUIVALENTS[name]()

    raise RuntimeError(
        f"Remote dataset {name!r} requires network access, which the port does not "
        f"use. Place the file under {_data_home() / name} to use a local copy."
    )
