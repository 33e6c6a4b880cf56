"""Builds cmems-glo-phy-024 on the card: the product's native uo/vo on
(time, depth, latitude, longitude) through
``convert.copernicusmarine_to_sgrid``, then the seeded currents, zero on
land, written into the field tensors there (no host copy of the fields).
"""

from __future__ import annotations

import numpy as np
import torch

from reference import inputs


def axes(cfg: dict):
    lon = cfg["lon_first"] + np.arange(cfg["columns"]) * (360.0 / cfg["columns"])
    lat = np.linspace(cfg["lat_first"], cfg["lat_last"], cfg["rows"])
    return lon, lat


def build(cfg: dict, seed: int, device):
    from parcels_tpu_torch import FieldSet, convert
    from parcels_tpu_torch import xrlite as xr

    T, Z, Y, X = cfg["frames"], cfg["levels"], cfg["rows"], cfg["columns"]
    lon, lat = axes(cfg)
    zero = np.broadcast_to(np.float32(0.0), (T, Z, Y, X))
    dims = ("time", "depth", "latitude", "longitude")
    fields = {
        name: xr.DataArray(zero, dims, {"units": "m s-1", "standard_name": std}, name=name)
        for name, std in (("uo", "eastward_sea_water_velocity"),
                          ("vo", "northward_sea_water_velocity"))
    }
    hours = np.arange(T) * cfg["frame_hours"]
    coords = xr.Dataset(coords={
        "time": (("time",), np.datetime64("2024-01-01T00:30") + hours.astype("timedelta64[h]")),
        "depth": (("depth",), np.full(Z, cfg["depth_m"]), {"units": "m", "positive": "down"}),
        "latitude": (("latitude",), lat, {"units": "degrees_north"}),
        "longitude": (("longitude",), lon, {"units": "degrees_east"}),
    })
    fs = FieldSet.from_sgrid_conventions(
        convert.copernicusmarine_to_sgrid(fields=fields, coords=coords), device=device)
    data = fs.device_arrays()["fields"]
    dev = data["U"].device
    ocean = torch.as_tensor(~inputs.land_mask(cfg["land_seed"], Y, X), device=dev).float()
    m = inputs.modes(seed)
    for t in range(T):
        u, v = inputs.planes(m, lon, lat, float(hours[t]), dev)
        data["U"][t, 0].copy_(u.float() * ocean)
        data["V"][t, 0].copy_(v.float() * ocean)
        del u, v
    return fs, float(hours[-1]) * 3600.0
