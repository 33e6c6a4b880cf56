"""v3 -> v4 transition helpers (capability parity with reference _v3to4.py).

Patches datasets written by Parcels v3 era tooling (e.g. ``Unit`` attrs) so
they ingest cleanly; works on xrlite or real xarray datasets.
"""

from __future__ import annotations

from collections.abc import Callable

__all__ = ["Unit_to_units", "patch_dataset_v4_compat", "xarray_patch_metadata"]


def Unit_to_units(d: dict) -> dict:  # noqa: N802 (reference name)
    if "Unit" in d:
        d["units"] = d.pop("Unit")
    return d


def xarray_patch_metadata(ds, f: Callable[[dict], dict]):
    """Apply ``f`` to every variable's attrs dict, in place; returns ``ds``."""
    for var in list(getattr(ds, "variables", {})):
        new = f(dict(ds[var].attrs))
        ds[var].attrs.clear()
        ds[var].attrs.update(new)
    return ds


def patch_dataset_v4_compat(ds):
    """Patch a dataset for v4 compatibility (reference _v3to4.py:24-27)."""
    return xarray_patch_metadata(ds, Unit_to_units)
