"""Miniature datasets mimicking real circulation-model output conventions.

Capability parity with reference src/parcels/_datasets/structured/
circulation_models.py: small in-memory datasets carrying each model's
*native* variable/dimension naming, for exercising the ``parcels_tpu_torch.convert``
normalizers end-to-end without network downloads.

Each function returns ``(fields, coords)`` ready to pass to the matching
``convert.*_to_sgrid`` function.
"""

from __future__ import annotations

import numpy as np

from parcels_tpu_torch import xrlite as xr

__all__ = [
    "cesm_style",
    "copernicusmarine_style",
    "copernicusmarine_waves_style",
    "croco_style",
    "datasets",
    "delft3d_style",
    "ecco4_style",
    "era5_wind_style",
    "fes_tides_style",
    "hycom_espc_style",
    "mitgcm_mds_style",
    "mitgcm_style",
    "nemo_moi_u_style",
    "nemo_moi_v_style",
    "nemo_style",
]


def _times(n=2):
    return np.array([np.datetime64("2000-01-01") + np.timedelta64(i, "D") for i in range(n)])


def nemo_style(nx=8, ny=6, nz=3, nt=2, u=0.1, v=0.0):
    """NEMO naming: uo/vo on (time, depthu/v, y, x); glamf/gphif f-points."""
    glamf = np.broadcast_to(np.linspace(0, 7, nx), (ny, nx)).copy()
    gphif = np.broadcast_to(np.linspace(40, 45, ny)[:, None], (ny, nx)).copy()
    fields = {
        "U": xr.DataArray(
            np.full((nt, nz, ny, nx), u, np.float32), dims=("time", "depthu", "y", "x"), name="U"
        ),
        "V": xr.DataArray(
            np.full((nt, nz, ny, nx), v, np.float32), dims=("time", "depthv", "y", "x"), name="V"
        ),
    }
    coords = xr.Dataset(
        coords={
            "time": (("time",), _times(nt)),
            "glamf": (("y", "x"), glamf),
            "gphif": (("y", "x"), gphif),
            "depthw": (("depthw",), np.linspace(0, 100, nz)),
        }
    )
    return fields, coords


def mitgcm_style(nx=10, ny=10, nz=3, nt=2, u=1.0, v=0.0, extent=9000.0):
    """MITgcm naming: XG/YG node coords, Zl decreasing depth."""
    fields = {
        "U": xr.DataArray(
            np.full((nt, nz, ny, nx), u, np.float32), dims=("time", "Zl", "YG", "XG"), name="U"
        ),
        "V": xr.DataArray(
            np.full((nt, nz, ny, nx), v, np.float32), dims=("time", "Zl", "YG", "XG"), name="V"
        ),
    }
    coords = xr.Dataset(
        coords={
            "time": (("time",), _times(nt)),
            "XG": (("XG",), np.linspace(0, extent, nx), {"units": "m"}),
            "YG": (("YG",), np.linspace(0, extent, ny), {"units": "m"}),
            "Zl": (("Zl",), np.linspace(100, 0, nz)),
        }
    )
    return fields, coords


def croco_style(nx=6, ny=6, nz=4, nt=3, u=1.0, v=0.0, extent=5000.0):
    """CROCO naming: x_rho/y_rho 2-D coords, s_w sigma levels, float time."""
    x_rho = np.broadcast_to(np.linspace(0, extent, nx), (ny, nx)).copy()
    y_rho = np.broadcast_to(np.linspace(0, extent, ny)[:, None], (ny, nx)).copy()
    fields = {
        "U": xr.DataArray(
            np.full((nt, nz, ny, nx - 1), u, np.float32),
            dims=("time", "s_rho", "eta_rho", "xi_u"),
            name="U",
        ),
        "V": xr.DataArray(
            np.full((nt, nz, ny - 1, nx), v, np.float32),
            dims=("time", "s_rho", "eta_v", "xi_rho"),
            name="V",
        ),
    }
    coords = xr.Dataset(
        coords={
            "time": (("time",), np.arange(nt) * 3600.0, {"units": "seconds"}),
            "x_rho": (("eta_rho", "xi_rho"), x_rho, {"units": "m"}),
            "y_rho": (("eta_rho", "xi_rho"), y_rho, {"units": "m"}),
            "s_w": (("s_w",), np.linspace(-1, 0, nz)),
        }
    )
    return fields, coords


def copernicusmarine_style(nx=8, ny=8, nz=3, nt=2, u=1.0, v=0.0, extent=10000.0):
    """Copernicus Marine naming: longitude/latitude/depth/time A-grid."""
    dims = ("time", "depth", "latitude", "longitude")
    fields = {
        "U": xr.DataArray(np.full((nt, nz, ny, nx), u, np.float32), dims=dims, name="U"),
        "V": xr.DataArray(np.full((nt, nz, ny, nx), v, np.float32), dims=dims, name="V"),
    }
    coords = xr.Dataset(
        coords={
            "time": (("time",), _times(nt)),
            "depth": (("depth",), np.linspace(0, 100, nz)),
            "latitude": (("latitude",), np.linspace(0, extent, ny), {"units": "m"}),
            "longitude": (("longitude",), np.linspace(0, extent, nx), {"units": "m"}),
        }
    )
    return fields, coords


def delft3d_style(n=5, nz=3, nt=2, u=1.0, v=0.0, extent=4.0):
    """Structured Delft3D naming: XZETA/YZETA on (N, M), SIGMA_C layers."""
    fields = {
        "U": xr.DataArray(
            np.full((nt, nz, n, n), u, np.float32), dims=("time", "LAYER", "N", "M"), name="U"
        ),
        "V": xr.DataArray(
            np.full((nt, nz, n, n), v, np.float32), dims=("time", "LAYER", "N", "M"), name="V"
        ),
    }
    coords = xr.Dataset(
        coords={
            "TIME": (("time",), _times(nt)),
            "XZETA": (("N", "M"), np.broadcast_to(np.linspace(0, extent, n), (n, n)).copy(), {"units": "m"}),
            "YZETA": (("N", "M"), np.broadcast_to(np.linspace(0, extent, n)[:, None], (n, n)).copy(), {"units": "m"}),
            "SIGMA_C": (("LAYER",), np.linspace(-1, 0, nz)),
        }
    )
    return fields, coords

# ---------------------------------------------------------------------------
# Native-convention dataset mimics (reference circulation_models.py:13-1251).
#
# Unlike the ``*_style`` helpers above (which return (fields, coords) pairs
# pre-split for the convert layer), these return complete datasets carrying
# each model's *raw* variable names, dimension names, and CF attributes,
# exactly as downloaded — the fixture surface the reference registers in its
# ``datasets`` dict (reference circulation_models.py:1251-1264).
# ---------------------------------------------------------------------------

_rng = np.random.default_rng(1234)


def _rand(*shape, dtype=np.float32):
    return _rng.random(shape).astype(dtype)


def nemo_moi_u_style(nx=6, ny=5, nz=3):
    """NEMO U-component file as serviced by Mercator Ocean International.

    Native naming (reference circulation_models.py:170-266): var ``vozocrtx``
    on (deptht, y, x) with 2-D ``nav_lon``/``nav_lat`` coords, plus a
    surface-only diagnostic.
    """
    return xr.Dataset(
        {
            "vozocrtx": (("deptht", "y", "x"), _rand(nz, ny, nx),
                         {"units": "m s-1", "long_name": "Zonal velocity",
                          "standard_name": "sea_water_x_velocity"}),
            "sotkeavmu1": (("y", "x"), _rand(ny, nx),
                           {"units": "m2 s-1",
                            "standard_name": "ocean_vertical_eddy_viscosity_u_1m"}),
        },
        coords={
            "nav_lon": (("y", "x"),
                        np.tile(np.linspace(-179, 179, nx, endpoint=False), (ny, 1)),
                        {"units": "degrees_east", "standard_name": "longitude"}),
            "nav_lat": (("y", "x"),
                        np.tile(np.linspace(-75, 85, ny).reshape(-1, 1), (1, nx)),
                        {"units": "degrees_north", "standard_name": "latitude"}),
            "x": (("x",), np.arange(nx, dtype="int32"),
                  {"standard_name": "projection_x_coordinate", "axis": "X"}),
            "y": (("y",), np.arange(ny, dtype="int32"),
                  {"standard_name": "projection_y_coordinate", "axis": "Y"}),
            "deptht": (("deptht",), np.linspace(1, 5500, nz),
                       {"units": "m", "positive": "down", "standard_name": "depth",
                        "axis": "Z"}),
        },
    )


def nemo_moi_v_style(nx=6, ny=5, nz=3):
    """NEMO V-component MOi file: ``vomecrty`` (reference :267-347)."""
    ds = nemo_moi_u_style(nx, ny, nz)
    u = ds.data_vars.pop("vozocrtx")
    ds.data_vars.pop("sotkeavmu1")
    ds.data_vars["vomecrty"] = xr.DataArray(
        u.values, u.dims,
        {"units": "m s-1", "long_name": "Meridional velocity",
         "standard_name": "sea_water_y_velocity"},
        name="vomecrty",
    )
    return ds


def cesm_style(nx=6, ny=5, nz=3, nt=2):
    """CESM/POP output: UVEL/VVEL/WVEL in cm/s on z_t / z_w_top with
    ULONG/ULAT 2-D coords (reference circulation_models.py:348-433)."""
    return xr.Dataset(
        {
            "UVEL": (("time", "z_t", "nlat", "nlon"), _rand(nt, nz, ny, nx),
                     {"long_name": "Velocity in grid-x direction",
                      "units": "centimeter/s", "grid_loc": "3221"}),
            "VVEL": (("time", "z_t", "nlat", "nlon"), _rand(nt, nz, ny, nx),
                     {"long_name": "Velocity in grid-y direction",
                      "units": "centimeter/s", "grid_loc": "3221"}),
            "WVEL": (("time", "z_w_top", "nlat", "nlon"), _rand(nt, nz, ny, nx),
                     {"long_name": "Vertical Velocity",
                      "units": "centimeter/s", "grid_loc": "3112"}),
        },
        coords={
            "time": (("time",), np.linspace(0, 5000, nt), {"long_name": "time"}),
            "z_t": (("z_t",), np.linspace(500, 537500, nz).astype("float32"),
                    {"units": "centimeters", "positive": "down"}),
            "z_w_top": (("z_w_top",), np.linspace(0, 525000, nz).astype("float32"),
                        {"units": "centimeters", "positive": "down"}),
            "ULONG": (("nlat", "nlon"),
                      np.tile(np.linspace(-179, 179, nx, endpoint=False), (ny, 1)),
                      {"units": "degrees_east"}),
            "ULAT": (("nlat", "nlon"),
                     np.tile(np.linspace(-75, 85, ny).reshape(-1, 1), (1, nx)),
                     {"units": "degrees_north"}),
        },
    )


def mitgcm_mds_style(nx=6, ny=5, nz=3, nt=2):
    """MITgcm .mds (xmitgcm) layout: U on (Z,YC,XG), V on (Z,YG,XC), W on
    (Zl,YC,XC) — fully staggered (reference circulation_models.py:536-671)."""
    return xr.Dataset(
        {
            "U": (("time", "Z", "YC", "XG"), _rand(nt, nz, ny, nx),
                  {"standard_name": "sea_water_x_velocity", "units": "m s-1",
                   "mate": "V"}),
            "V": (("time", "Z", "YG", "XC"), _rand(nt, nz, ny, nx),
                  {"standard_name": "sea_water_y_velocity", "units": "m s-1",
                   "mate": "U"}),
            "W": (("time", "Zl", "YC", "XC"), _rand(nt, nz, ny, nx),
                  {"standard_name": "upward_sea_water_velocity", "units": "m s-1"}),
            "S": (("time", "Z", "YC", "XC"), _rand(nt, nz, ny, nx),
                  {"standard_name": "sea_water_salinity", "units": "psu"}),
            "T": (("time", "Z", "YC", "XC"), _rand(nt, nz, ny, nx),
                  {"standard_name": "sea_water_potential_temperature", "units": "degC"}),
        },
        coords={
            "time": (("time",), _times(nt)),
            "Z": (("Z",), -np.linspace(0.5, 99.5, nz),
                  {"standard_name": "depth", "positive": "up", "axis": "Z"}),
            "Zl": (("Zl",), -np.linspace(0, 99, nz),
                   {"standard_name": "depth_at_upper_w_location", "positive": "up",
                    "axis": "Z", "c_grid_axis_shift": -0.5}),
            "YC": (("YC",), np.linspace(0.5, 4.5, ny) * 1000.0,
                   {"standard_name": "plane_y_coordinate", "units": "m", "axis": "Y"}),
            "YG": (("YG",), np.linspace(0.0, 4.0, ny) * 1000.0,
                   {"standard_name": "plane_y_coordinate_at_f_location", "units": "m",
                    "axis": "Y", "c_grid_axis_shift": -0.5}),
            "XC": (("XC",), np.linspace(0.5, 5.5, nx) * 1000.0,
                   {"standard_name": "plane_x_coordinate", "units": "m", "axis": "X"}),
            "XG": (("XG",), np.linspace(0.0, 5.0, nx) * 1000.0,
                   {"standard_name": "plane_x_coordinate_at_f_location", "units": "m",
                    "axis": "X", "c_grid_axis_shift": -0.5}),
        },
    )


def era5_wind_style(nx=8, ny=6, nt=2):
    """ERA5 10-metre wind: u10/v10 on (time, latitude, longitude), no depth
    dimension, latitude descending (reference circulation_models.py:672-720)."""
    return xr.Dataset(
        {
            "u10": (("time", "latitude", "longitude"), _rand(nt, ny, nx),
                    {"units": "m s**-1", "long_name": "10 metre U wind component"}),
            "v10": (("time", "latitude", "longitude"), _rand(nt, ny, nx),
                    {"units": "m s**-1", "long_name": "10 metre V wind component"}),
        },
        coords={
            "time": (("time",), _times(nt)),
            "latitude": (("latitude",), np.linspace(85, -75, ny),
                         {"units": "degrees_north", "long_name": "latitude"}),
            "longitude": (("longitude",), np.linspace(-179, 179, nx, endpoint=False),
                          {"units": "degrees_east", "long_name": "longitude"}),
        },
    )


def fes_tides_style(nx=8, ny=6):
    """FES2014 tidal constituent file: amplitude/phase on (lat, lon), with no
    time dimension at all (reference circulation_models.py:721-772)."""
    return xr.Dataset(
        {
            "Ua": (("lat", "lon"), _rand(ny, nx),
                   {"units": "cm/s", "long_name": "Eastward velocity amplitude"}),
            "Ug": (("lat", "lon"), 360.0 * _rand(ny, nx),
                   {"units": "degrees", "long_name": "Eastward velocity phase lag"}),
        },
        coords={
            "lat": (("lat",), np.linspace(-75, 85, ny), {"units": "degrees_north"}),
            "lon": (("lon",), np.linspace(0, 360, nx, endpoint=False),
                    {"units": "degrees_east"}),
        },
    )


def hycom_espc_style(nx=6, ny=5, nz=3, nt=2):
    """HYCOM ESPC-D-V02 daily file: water_u/water_v/water_temp + scalar tau
    (reference circulation_models.py:773-854)."""
    return xr.Dataset(
        {
            "water_u": (("time", "depth", "lat", "lon"), _rand(nt, nz, ny, nx),
                        {"units": "m/s", "standard_name": "eastward_sea_water_velocity",
                         "long_name": "Eastward Water Velocity"}),
            "water_v": (("time", "depth", "lat", "lon"), _rand(nt, nz, ny, nx),
                        {"units": "m/s", "standard_name": "northward_sea_water_velocity",
                         "long_name": "Northward Water Velocity"}),
            "tau": (("time",), np.arange(nt, dtype="float64"),
                    {"units": "hours since analysis", "standard_name": "forecast_period"}),
        },
        coords={
            "time": (("time",), _times(nt)),
            "depth": (("depth",), np.linspace(0, 5000, nz).astype("float32"),
                      {"units": "m", "positive": "down", "axis": "Z"}),
            "lat": (("lat",), np.linspace(-75, 85, ny), {"units": "degrees_north",
                    "axis": "Y"}),
            "lon": (("lon",), np.linspace(0, 360, nx, endpoint=False),
                    {"units": "degrees_east", "axis": "X"}),
        },
    )


def ecco4_style(nx=6, ny=5, nz=3, nt=2, ntile=2):
    """ECCOv4 llc-tiled output: UVEL on (time,k,tile,j,i_g), VVEL on
    (time,k,tile,j_g,i), WVEL on (time,k_l,tile,j,i) with 3-D tile coords
    (reference circulation_models.py:855-1078)."""
    yc = np.tile(np.linspace(-75, 85, ny).reshape(1, -1, 1), (ntile, 1, nx))
    xc = np.tile(np.linspace(-179, 179, nx, endpoint=False).reshape(1, 1, -1),
                 (ntile, ny, 1))
    return xr.Dataset(
        {
            "UVEL": (("time", "k", "tile", "j", "i_g"), _rand(nt, nz, ntile, ny, nx),
                     {"units": "m/s", "mate": "VVEL",
                      "long_name": "Zonal velocity"}),
            "VVEL": (("time", "k", "tile", "j_g", "i"), _rand(nt, nz, ntile, ny, nx),
                     {"units": "m/s", "mate": "UVEL",
                      "long_name": "Meridional velocity"}),
            "WVEL": (("time", "k_l", "tile", "j", "i"), _rand(nt, nz, ntile, ny, nx),
                     {"units": "m/s", "long_name": "Vertical velocity"}),
        },
        coords={
            "time": (("time",), _times(nt)),
            "tile": (("tile",), np.arange(ntile)),
            "k": (("k",), np.arange(nz), {"axis": "Z"}),
            "k_l": (("k_l",), np.arange(nz), {"axis": "Z", "c_grid_axis_shift": -0.5}),
            "j": (("j",), np.arange(ny), {"axis": "Y"}),
            "j_g": (("j_g",), np.arange(ny), {"axis": "Y", "c_grid_axis_shift": -0.5}),
            "i": (("i",), np.arange(nx), {"axis": "X"}),
            "i_g": (("i_g",), np.arange(nx), {"axis": "X", "c_grid_axis_shift": -0.5}),
            "Z": (("k",), -np.linspace(5, 5000, nz), {"units": "m", "positive": "up"}),
            "Zl": (("k_l",), -np.linspace(0, 4900, nz), {"units": "m", "positive": "up"}),
            "YC": (("tile", "j", "i"), yc, {"units": "degrees_north"}),
            "XC": (("tile", "j", "i"), xc, {"units": "degrees_east"}),
        },
    )


def copernicusmarine_waves_style(nx=8, ny=8, nz=1, nt=2):
    """Copernicus Marine wave product: Stokes drift VSDX/VSDY with CF
    standard names (reference circulation_models.py:91-169)."""
    dims = ("time", "depth", "latitude", "longitude")
    return xr.Dataset(
        {
            "VSDX": (dims, _rand(nt, nz, ny, nx),
                     {"units": "m s-1",
                      "standard_name": "sea_surface_wave_stokes_drift_x_velocity"}),
            "VSDY": (dims, _rand(nt, nz, ny, nx),
                     {"units": "m s-1",
                      "standard_name": "sea_surface_wave_stokes_drift_y_velocity"}),
        },
        coords={
            "time": (("time",), _times(nt)),
            "depth": (("depth",), np.zeros(nz), {"units": "m", "positive": "down"}),
            "latitude": (("latitude",), np.linspace(30, 40, ny),
                         {"units": "degrees_north"}),
            "longitude": (("longitude",), np.linspace(-10, 0, nx),
                          {"units": "degrees_east"}),
        },
    )


def _croco_idealized_ds():
    """CROCO idealized run as one raw dataset (reference :1079-1250)."""
    fields, coords = croco_style()
    nt, nz, ny, nx = 3, 4, 6, 6
    ds = xr.Dataset(
        {
            "u": fields["U"], "v": fields["V"],
            "w": (("time", "s_rho", "eta_rho", "xi_rho"), _rand(nt, nz, ny, nx)),
            "h": (("eta_rho", "xi_rho"), 100.0 + 10.0 * _rand(ny, nx, dtype=np.float64)),
            "zeta": (("time", "eta_rho", "xi_rho"), 0.1 * _rand(nt, ny, nx)),
            "Cs_w": (("s_w",), np.linspace(-1, 0, nz)),
            "hc": np.float64(5.0),
        },
        coords=dict(coords.coords),
    )
    ds.coords["s_rho"] = xr.DataArray(np.linspace(-1, 0, nz), ("s_rho",))
    return ds


def _build_datasets():
    """Registry mirroring reference circulation_models.py:1251-1264."""
    return {
        "ds_copernicusmarine": _copernicusmarine_ds(),
        "ds_copernicusmarine_waves": copernicusmarine_waves_style(),
        "ds_NEMO_MOI_U": nemo_moi_u_style(),
        "ds_NEMO_MOI_V": nemo_moi_v_style(),
        "ds_CESM": cesm_style(),
        "ds_MITgcm_netcdf": _mitgcm_netcdf_ds(),
        "ds_MITgcm_mds": mitgcm_mds_style(),
        "ds_ERA5_wind": era5_wind_style(),
        "ds_FES_tides": fes_tides_style(),
        "ds_hycom_espc": hycom_espc_style(),
        "ds_ecco4": ecco4_style(),
        "ds_CROCO_idealized": _croco_idealized_ds(),
    }


def _copernicusmarine_ds():
    """Copernicus Marine physics product with native uo/vo names
    (reference circulation_models.py:13-90)."""
    nt, nz, ny, nx = 2, 3, 8, 8
    dims = ("time", "depth", "latitude", "longitude")
    return xr.Dataset(
        {
            "uo": (dims, _rand(nt, nz, ny, nx),
                   {"units": "m s-1",
                    "standard_name": "eastward_sea_water_velocity"}),
            "vo": (dims, _rand(nt, nz, ny, nx),
                   {"units": "m s-1",
                    "standard_name": "northward_sea_water_velocity"}),
        },
        coords={
            "time": (("time",), _times(nt)),
            "depth": (("depth",), np.linspace(0, 100, nz), {"units": "m",
                      "positive": "down"}),
            "latitude": (("latitude",), np.linspace(30, 40, ny),
                         {"units": "degrees_north"}),
            "longitude": (("longitude",), np.linspace(-10, 0, nx),
                          {"units": "degrees_east"}),
        },
    )


def _mitgcm_netcdf_ds():
    """MITgcm netcdf-diagnostics layout: UVEL/VVEL on shared XG/YG dims
    (reference circulation_models.py:434-535)."""
    fields, coords = mitgcm_style()
    return xr.Dataset(
        {"UVEL": fields["U"], "VVEL": fields["V"]},
        coords=dict(coords.coords),
    )


datasets = _build_datasets()
