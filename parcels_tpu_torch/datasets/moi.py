"""Global-1/12°-shaped MOi (Mercator Ocean International) fieldset generator.

Mimics the layout of the reference's metadata-only MOi benchmark registry
entry (`Benchmarks_MOi_data_metadata-only/{U,V,W,mesh}`, reference
_datasets/remote.py:252-257): global NEMO ORCA-style curvilinear C-grid
forcing with native MOi naming (``vozocrtx``/``vomecrty`` per-component
files plus a mesh file carrying ``glamf``/``gphif`` f-point coordinates),
scaled to a requested resolution. This is the JAX package's config-5 shape;
``chip_smoke.py`` drives it on the card, and the port's tests use small
instances on the CPU. Copied from the JAX package's ``datasets/moi.py``;
``moi_like_fieldset`` also takes the fieldset's ``device``.

The horizontal grid is curvilinear: an ORCA-like distortion grows toward the
northern boundary (NEMO's tripolar fold), forcing the 2-D curvilinear search
path rather than the rectilinear fast path. Depth levels follow NEMO's
stretched z (fine near the surface, ~450 m spacing at depth).
"""

from __future__ import annotations

import numpy as np

from parcels_tpu_torch import convert
from parcels_tpu_torch import xrlite as xr

__all__ = ["moi_like_fieldset", "moi_like_inputs"]


def _stretched_depth(zdim: int, zmax: float = 5728.0) -> np.ndarray:
    """NEMO DRAKKAR-style stretched w-levels: dz ~ 1 m at surface."""
    k = np.arange(zdim, dtype=np.float64)
    return zmax * (np.exp(k / (zdim / 3.3)) - 1.0) / (np.exp((zdim - 1) / (zdim / 3.3)) - 1.0)


def moi_like_inputs(
    xdim: int = 120,
    ydim: int = 80,
    zdim: int = 8,
    tdim: int = 2,
    seed: int = 0,
    u: float | None = None,
    v: float | None = None,
    data_dtype=np.float32,
    zero_data: bool = False,
    with_w: bool = False,
    w: float | None = None,
):
    """(fields, coords) with native MOi naming, ready for ``nemo_to_sgrid``.

    ``u``/``v`` set uniform velocities (for closed-form tests); by default
    velocities are random in ±0.3 m/s (bench realism). ``zero_data=True``
    allocates U/V as broadcast views of a scalar zero — effectively free on
    host — for benchmarks that overwrite the device arrays in place.
    ``with_w`` adds the vertical component ``vovecrtz`` on w-levels (the
    reference MOi registry ships U, V AND W —
    reference _datasets/remote.py:252-257), making the fieldset 3-D
    (RK4_3D-capable); ``w`` sets it uniform.
    """
    rng = np.random.default_rng(seed)
    # f-point coordinates: global longitudes, -75..85 latitudes, with an
    # ORCA-ish distortion that grows toward the north pole fold
    lon1 = np.linspace(-180.0, 180.0, xdim, endpoint=False)
    lat1 = np.linspace(-75.0, 85.0, ydim)
    glamf, gphif = np.meshgrid(lon1, lat1)
    dlat = lat1[1] - lat1[0]
    northness = np.clip((gphif - 20.0) / 65.0, 0.0, 1.0) ** 2
    glamf = glamf + 0.35 * (360.0 / xdim) * northness * np.sin(np.deg2rad(glamf) * 3)
    gphif = gphif + 0.35 * dlat * northness * np.cos(np.deg2rad(glamf) * 2)

    shape = (tdim, zdim, ydim, xdim)
    if zero_data:
        U = np.broadcast_to(np.float32(0.0), shape)
        V = np.broadcast_to(np.float32(0.0), shape)
    elif u is not None or v is not None:
        U = np.full(shape, 0.0 if u is None else u, data_dtype)
        V = np.full(shape, 0.0 if v is None else v, data_dtype)
    else:
        U = rng.uniform(-0.3, 0.3, shape).astype(data_dtype)
        V = rng.uniform(-0.3, 0.3, shape).astype(data_dtype)

    fields = {
        "vozocrtx": xr.DataArray(
            U,
            dims=("time_counter", "depthu", "y", "x"),
            attrs={"units": "m s-1", "standard_name": "sea_water_x_velocity"},
            name="vozocrtx",
        ),
        "vomecrty": xr.DataArray(
            V,
            dims=("time_counter", "depthv", "y", "x"),
            attrs={"units": "m s-1", "standard_name": "sea_water_y_velocity"},
            name="vomecrty",
        ),
    }
    if with_w:
        if zero_data:
            W = np.broadcast_to(np.float32(0.0), shape)
        elif w is not None:
            W = np.full(shape, w, data_dtype)
        else:
            W = rng.uniform(-1e-4, 1e-4, shape).astype(data_dtype)
        # NEMO convention: vovecrtz is positive-up; the convert layer negates
        # it into the positive-down frame (convert._negate_w)
        fields["vovecrtz"] = xr.DataArray(
            W,
            dims=("time_counter", "depthw", "y", "x"),
            attrs={"units": "m s-1", "standard_name": "upward_sea_water_velocity"},
            name="vovecrtz",
        )
    coords = xr.Dataset(
        coords={
            "time_counter": (
                ("time_counter",),
                np.array(
                    [np.datetime64("2000-01-01") + np.timedelta64(i, "D") for i in range(tdim)]
                ),
            ),
            "glamf": (("y", "x"), glamf, {"units": "degrees_east"}),
            "gphif": (("y", "x"), gphif, {"units": "degrees_north"}),
            "depthw": (("depthw",), _stretched_depth(zdim), {"units": "m", "positive": "down"}),
        }
    )
    return fields, coords


def moi_like_fieldset(xdim=120, ydim=80, zdim=8, tdim=2, seed=0, u=None, v=None, device=None,
                      **kw):
    """MOi-shaped curvilinear C-grid FieldSet (spherical mesh autodetected)
    on ``device`` (``cuda`` unless the caller names another)."""
    from parcels_tpu_torch import FieldSet

    fields, coords = moi_like_inputs(xdim, ydim, zdim, tdim, seed=seed, u=u, v=v, **kw)
    ds = convert.nemo_to_sgrid(fields=fields, coords=coords)
    return FieldSet.from_sgrid_conventions(ds, device=device)
