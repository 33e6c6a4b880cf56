"""The benchmark's inputs, made from the seed: the grids' coordinates, the
land mask and smooth surface currents.

Both sides take their inputs from here: a configuration's builder writes the
currents into the program's field tensors on the card, and the reference
evaluates the same formulas at the nodes it needs. Nothing here imports the
program.

The currents stand in for the products' data, which the repository does not
hold. They derive from a streamfunction of ``N_MODES`` plane waves with
wavelengths from 50 to 500 km, each drifting in phase with a period of about
five days, scaled to a root-mean-square surface speed of 0.2 m/s. Positions
map to metres as ``x = R * lon``, ``y = R * lat`` (radians), with R the
radius at which a degree is 1852 * 60 m, as in the program's mesh. The
wavelengths and amplitudes are the same for every seed; the seed draws the
directions, phases and drift rates.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: metres in a degree of arc, as the program's spherical mesh takes it
DEG2M = 1852.0 * 60.0
EARTH_R = DEG2M * 180.0 / math.pi
N_MODES = 64
WAVELENGTHS_M = (50e3, 500e3)
RMS_SPEED = 0.2
DRIFT_PERIOD_H = 120.0


def seed_sequence(seed: int, stream: int) -> np.random.SeedSequence:
    """One numpy stream of ``seed`` (any whole number) for one purpose."""
    return np.random.SeedSequence([int(seed) % 2**64, stream])


def modes(seed: int) -> dict:
    """The plane waves of the streamfunction: (N_MODES,) float64 arrays."""
    rng = np.random.default_rng(seed_sequence(seed, 1))
    k = 2 * math.pi / np.geomspace(*WAVELENGTHS_M, N_MODES)
    angle = rng.uniform(0.0, 2 * math.pi, N_MODES)
    phase = rng.uniform(0.0, 2 * math.pi, N_MODES)
    omega = rng.uniform(-1.0, 1.0, N_MODES) * 2 * math.pi / DRIFT_PERIOD_H
    # equal energy in every mode: mean(u^2 + v^2) = sum(amp^2 k^2) / 2 = RMS^2
    amp = RMS_SPEED / math.sqrt(N_MODES / 2) / k
    kx, ky = k * np.cos(angle), k * np.sin(angle)
    return {"kx": kx, "ky": ky, "phase": phase, "omega": omega,
            "wu": -amp * ky, "wv": amp * kx}


def _t(m, device):
    return {k: torch.as_tensor(v, dtype=torch.float64, device=device) for k, v in m.items()}


def planes(m: dict, lon_deg, lat_deg, t_h: float, device):
    """(U, V) float64 of shape (len(lat), len(lon)) on a product grid at
    ``t_h`` hours: two matrix products a component."""
    m = _t(m, device)
    xs = torch.as_tensor(np.deg2rad(np.asarray(lon_deg, np.float64)) * EARTH_R, device=device)
    ys = torch.as_tensor(np.deg2rad(np.asarray(lat_deg, np.float64)) * EARTH_R, device=device)
    row = m["ky"][None, :] * ys[:, None] + m["phase"] + m["omega"] * t_h
    col = m["kx"][:, None] * xs[None, :]
    cr, sr, cc, sc = torch.cos(row), torch.sin(row), torch.cos(col), torch.sin(col)
    out = []
    for w in (m["wu"], m["wv"]):
        out.append((cr * w) @ cc - (sr * w) @ sc)
    return out[0], out[1]


def at_points(m: dict, lon_deg, lat_deg, t_h):
    """(U, V) float64 at single points: (n,) tensors of lon, lat and hours."""
    m = _t(m, lon_deg.device)
    theta = (m["kx"] * (torch.deg2rad(lon_deg) * EARTH_R)[:, None]
             + m["ky"] * (torch.deg2rad(lat_deg) * EARTH_R)[:, None]
             + m["phase"] + m["omega"] * t_h[:, None])
    c = torch.cos(theta)
    return (c * m["wu"]).sum(1), (c * m["wv"]).sum(1)


def depth_factor(nz: int) -> np.ndarray:
    """float32 scale of the currents on each depth level (1 at the surface),
    so that a sample taken at the wrong level reads another value."""
    return (1.0 / (1.0 + np.arange(nz) / 4.0)).astype(np.float32)


def orca_like_axes(nx: int, ny: int):
    """The 1-D longitudes and latitudes the ORCA-like mesh is bent from
    (f-points), float64."""
    return np.linspace(-180.0, 180.0, nx, endpoint=False), np.linspace(-75.0, 85.0, ny)


def orca_like_nodes(lon, lat, nx: int, dlat: float):
    """The ORCA-like f-point coordinates (glamf, gphif) of the nodes whose
    unbent coordinates are ``lon`` and ``lat`` (numpy arrays or torch
    tensors, float64, broadcast): the bend grows toward the north as NEMO's
    tripolar fold does, scaled by the zonal step 360 / ``nx`` and the
    meridional step ``dlat``. The mesh of the MOi layout."""
    lib = torch if isinstance(lon, torch.Tensor) else np
    north = lib.clip((lat - 20.0) / 65.0, 0.0, 1.0) ** 2
    glam = lon + 0.35 * (360.0 / nx) * north * lib.sin(lib.deg2rad(lon) * 3)
    gphi = lat + 0.35 * dlat * north * lib.cos(lib.deg2rad(glam) * 2)
    return glam, gphi


def stretched_depth(nz: int, zmax: float = 5728.0) -> np.ndarray:
    """NEMO's stretched w-levels of the MOi layout (about 1 m apart at the
    surface), float64."""
    k = np.arange(nz, dtype=np.float64)
    return zmax * (np.exp(k / (nz / 3.3)) - 1.0) / (np.exp((nz - 1) / (nz / 3.3)) - 1.0)


def land_mask(land_seed: int, ny: int, nx: int) -> np.ndarray:
    """A fixed synthetic coast, (ny, nx) bool, True on land: 64-cell blocks
    of a coarse random field under its 30th percentile. It depends on the
    configuration's ``land_seed`` and not on the run's seed: the geography
    stays, the currents change."""
    rng = np.random.default_rng(land_seed)
    coarse = rng.random((ny // 64 + 2, nx // 64 + 2))
    return np.kron(coarse < np.quantile(coarse, 0.3), np.ones((64, 64), bool))[:ny, :nx]
