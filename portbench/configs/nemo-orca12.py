"""Builds nemo-orca12 on the card: the ORCA-like f-point mesh and NEMO's
native variable names through ``convert.nemo_to_sgrid``, then the seeded
currents written into the field tensors there (no host copy of the fields).
"""

from __future__ import annotations

import numpy as np
import torch

from reference import inputs


def build(cfg: dict, seed: int, device):
    from parcels_tpu_torch import FieldSet, convert
    from parcels_tpu_torch import xrlite as xr

    T, Z, Y, X = cfg["frames"], cfg["levels"], cfg["rows"], cfg["columns"]
    lon1, lat1 = inputs.orca_like_axes(X, Y)
    glamf, gphif = inputs.orca_like_nodes(*np.meshgrid(lon1, lat1), X, lat1[1] - lat1[0])
    zero = np.broadcast_to(np.float32(0.0), (T, Z, Y, X))
    fields = {
        "vozocrtx": xr.DataArray(zero, dims=("time_counter", "depthu", "y", "x"), name="vozocrtx",
                                 attrs={"units": "m s-1", "standard_name": "sea_water_x_velocity"}),
        "vomecrty": xr.DataArray(zero, dims=("time_counter", "depthv", "y", "x"), name="vomecrty",
                                 attrs={"units": "m s-1", "standard_name": "sea_water_y_velocity"}),
    }
    hours = np.arange(T) * cfg["frame_hours"]
    coords = xr.Dataset(coords={
        "time_counter": (("time_counter",),
                         np.datetime64("2000-01-01") + hours.astype("timedelta64[h]")),
        "glamf": (("y", "x"), glamf, {"units": "degrees_east"}),
        "gphif": (("y", "x"), gphif, {"units": "degrees_north"}),
        "depthw": (("depthw",), inputs.stretched_depth(Z), {"units": "m", "positive": "down"}),
    })
    fs = FieldSet.from_sgrid_conventions(convert.nemo_to_sgrid(fields=fields, coords=coords),
                                         device=device)
    data = fs.device_arrays()["fields"]
    m = inputs.modes(seed)
    fac = torch.as_tensor(inputs.depth_factor(Z), device=data["U"].device)[:, None, None]
    for t in range(T):
        u, v = inputs.planes(m, lon1, lat1, float(hours[t]), data["U"].device)
        data["U"][t].copy_(u.float()[None] * fac)
        data["V"][t].copy_(v.float()[None] * fac)
        del u, v
    return fs, float(hours[-1]) * 3600.0
