"""2-D (Y x X) tile decomposition over ``torch.distributed``.

Port of the JAX package's ``parallel/tiles.py``: a ``(tiles_y, tiles_x)``
grid of rectangular tiles over a RECTILINEAR grid, one tile a rank
(row-major). A rank holds its tile's slab of every tiled field: its own
cell rows and columns plus ``halo`` cells on every side (corner halos come
with the rectangle). Migration routes each lane straight to the tile that
owns it (``domain._exchange``, one ragged exchange a step), so a diagonal
crosser reaches its corner neighbour at once; the halo diagnostic is the
band path's, on both axes. Curvilinear tiling, time windows and
rebalancing are out of scope, as in the JAX package.

Three differences from the JAX package, each deliberate: a 1-wide tile
grid (``tiles=(1, k)`` or ``(k, 1)``) has an empty edge array on that axis
instead of a crash; the views mark the persistent-cache owner as the band
views do; and the host judges ownership on the same f32 edges as the
migration, so a lane is never placed in one tile and routed to another.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from parcels_tpu_torch._core.field import Field
from parcels_tpu_torch._core.fieldset import _device_copy
from parcels_tpu_torch._core.statuscodes import MIN_ERROR_CODE
from parcels_tpu_torch.parallel import _comm
from parcels_tpu_torch.parallel.domain import (
    _capacity,
    _exchange,
    _own_lanes,
    _owners,
    _views,
    lockstep_chunk,
)

__all__ = ["XYTileDomain", "build_tile_executor"]


class XYTileDomain:
    """A (tiles_y, tiles_x) rectangular tile decomposition, one tile a rank.

    Parameters mirror :class:`YBandDomain`; ``tiles`` is the (ty, tx)
    grid, and ``ty * tx`` must equal the world size.
    """

    def __init__(self, fieldset, tiles: tuple[int, int], halo: int = 2, devices=None,
                 headroom: float = 2.0, migration_capacity: int | None = None,
                 axis: str = "tiles"):
        ty, tx = (int(t) for t in tiles)
        if ty < 1 or tx < 1 or ty * tx < 2:
            raise ValueError(f"tiles must be a grid of >= 2 ranks. Got {tiles}.")
        self.rank, world = _comm.world()
        if ty * tx != world:
            raise ValueError(f"tiles={tiles} needs {ty * tx} ranks; the world has {world}.")
        self.ty, self.tx = ty, tx
        self.n = ty * tx
        self.device = fieldset.device if devices is None else torch.device(
            devices[self.rank] if isinstance(devices, (list, tuple)) else devices)
        self.axis = axis
        self.halo = int(halo)
        self.headroom = float(headroom)
        self.migration_capacity = migration_capacity
        self.fieldset = fieldset
        self.curvilinear = False
        self.stats = {"steps": 0, "sent": 0}
        self._static = None
        self._build_plans()

    @property
    def migration_mode(self) -> str:
        return "all2all"

    def _build_plans(self):
        h = self.halo
        ty, tx = self.ty, self.tx
        self._grid_plans: list[dict] = []
        main = None
        for grid in self.fieldset.gridset:
            spec = grid.spec
            axes = getattr(spec, "axes", ())
            if not ("Y" in axes and "X" in axes and not getattr(spec, "curvilinear", False)
                    and spec.ydim >= ty and spec.xdim >= tx):
                self._grid_plans.append({"tiled": False, "grid": grid, "spec": spec})
                continue
            la = np.asarray(grid.lat, dtype=np.float64)
            lo = np.asarray(grid.lon, dtype=np.float64)
            ydim, xdim = spec.ydim, spec.xdim
            ry = math.ceil(ydim / ty) * np.arange(ty + 1, dtype=np.int64)
            rx = math.ceil(xdim / tx) * np.arange(tx + 1, dtype=np.int64)
            Yl = int(np.diff(ry).max()) + 2 * h
            Xl = int(np.diff(rx).max()) + 2 * h

            def ext_axis(nodes, starts, Ll, dim):
                extra = max(0, int(starts.max()) + (Ll - 2 * h) - dim)
                d0 = nodes[1] - nodes[0]
                dN = nodes[-1] - nodes[-2]
                lo_pad = nodes[0] - d0 * np.arange(h, 0, -1)
                hi_pad = nodes[-1] + dN * np.arange(1, extra + h + 1)
                return np.concatenate([lo_pad, nodes, hi_pad]), extra

            la_ext, extra_y = ext_axis(la, ry[:-1], Yl, ydim)
            lo_ext, extra_x = ext_axis(lo, rx[:-1], Xl, xdim)
            plan = {
                "tiled": True,
                "grid": grid,
                "spec": dataclasses.replace(
                    spec, ydim=Yl, xdim=Xl, lat_uniform=None, lon_uniform=None,
                    has_lookup=False, y_oob_bounds=(float(la[0]), float(la[-1])),
                    x_oob_bounds=(float(lo[0]), float(lo[-1])),
                ),
                "ry": ry, "rx": rx, "Yl": Yl, "Xl": Xl,
                "pad_s": h, "pad_n": extra_y + h, "pad_w": h, "pad_e": extra_x + h,
                "lat_ext": la_ext, "lon_ext": lo_ext,
                "ey": la_ext[h + np.minimum(ry, ydim + extra_y)],
                "ex": lo_ext[h + np.minimum(rx, xdim + extra_x)],
            }
            self._grid_plans.append(plan)
            if main is None:
                main = plan
        if main is None:
            raise ValueError("FieldSet has no rectilinear grid tileable along Y and X.")
        self._main = main
        # interior ownership thresholds, in the f32 the migration compares
        # with (a 1-wide axis has none)
        self._ey_int = main["ey"][1:-1].astype(np.float32)
        self._ex_int = main["ex"][1:-1].astype(np.float32)

    def _tile_rows(self, plan):
        """Extended-frame row and column starts of this rank's tile."""
        ry, rx = divmod(self.rank, self.tx)
        return int(plan["ry"][ry]), int(plan["rx"][rx])

    def stacked_farrays(self) -> dict:
        """This rank's tile tensors: its slab of the tiled grids and fields,
        the others whole, and its tile's halo box and ownership edges."""
        if self._static is not None:
            return self._static
        if self.fieldset._time_window is not None:
            raise NotImplementedError(
                "XYTileDomain does not support windowed streaming yet; "
                "use YBandDomain for out-of-core runs."
            )
        dev = self.device
        out = {"fields": {}, "grids": [], "band": {}}
        for plan in self._grid_plans:
            grid = plan["grid"]
            garrs = grid.device_arrays(dev)
            if plan["tiled"]:
                sy, sx = self._tile_rows(plan)
                lat = plan["lat_ext"][sy:sy + plan["Yl"] + 1]
                lon = plan["lon_ext"][sx:sx + plan["Xl"] + 1]
                garrs["lat"] = torch.as_tensor(lat.astype(np.float32), device=dev)
                garrs["lon"] = torch.as_tensor(lon.astype(np.float32), device=dev)
                if "cgrid_geom" in garrs:
                    # the per-cell C-grid geometry in the tile's frame (the
                    # global table would be read at tile-local cells)
                    from parcels_tpu_torch._core.grid import cgrid_geometry_from_coords

                    garrs["cgrid_geom"] = torch.as_tensor(
                        cgrid_geometry_from_coords(lon, lat, plan["spec"].spherical), device=dev)
            out["grids"].append(garrs)
        for name, f in self.fieldset.fields.items():
            if not isinstance(f, Field):
                continue
            plan = self._grid_plans[f.igrid]
            if not plan["tiled"]:
                out["fields"][name] = _device_copy(f.data, dev)
                continue
            sy, sx = self._tile_rows(plan)
            Y, X = f.data.shape[2], f.data.shape[3]
            iy = np.clip(np.arange(sy, sy + plan["Yl"]) - plan["pad_s"], 0, Y - 1)
            ix = np.clip(np.arange(sx, sx + plan["Xl"]) - plan["pad_w"], 0, X - 1)
            slab = np.asarray(f.data, dtype=np.float32)[:, :, iy][:, :, :, ix]
            out["fields"][name] = torch.as_tensor(np.ascontiguousarray(slab), device=dev)
        main = self._main
        sy, sx = self._tile_rows(main)
        lat = main["lat_ext"][sy:sy + main["Yl"] + 1].astype(np.float32)
        lon = main["lon_ext"][sx:sx + main["Xl"] + 1].astype(np.float32)
        out["band"] = {
            "halo_y": (float(lat[0]), float(lat[-1])),
            "halo_x": (float(lon[0]), float(lon[-1])),
            "edges_y": torch.as_tensor(self._ey_int, device=dev),
            "edges_x": torch.as_tensor(self._ex_int, device=dev),
        }
        self._static = out
        return out

    def stacked_windowed(self, t_lo, t_hi):
        return self.stacked_farrays()

    def prefetch_window(self, t_anchor) -> None:
        return None

    def _static_arrays(self) -> dict:
        return self.stacked_farrays()

    def build_views(self, farrays: dict):
        from parcels_tpu_torch.ops.stagecache import soa_cache_owner

        return _views(self.fieldset, self._grid_plans, farrays, "tiled",
                      soa_cache_owner(self.fieldset)[0])

    def tile_of(self, y, x) -> np.ndarray:
        """Owning tile per particle, on the f32 edges the migration uses."""
        ry = np.searchsorted(self._ey_int, np.asarray(y, dtype=np.float32), side="right")
        cx = np.searchsorted(self._ex_int, np.asarray(x, dtype=np.float32), side="right")
        return (ry * self.tx + cx).astype(np.int64)

    band_of = tile_of

    def lane_capacity(self, pdata: dict) -> int:
        return _capacity(self, _owners(self.tile_of, pdata)[1])

    def shard_soa(self, pdata: dict, lane_capacity: int | None = None) -> dict:
        """This rank's lanes: its tile's active particles, padded to the lane
        capacity, with its own RNG key and overflow counters."""
        return _own_lanes(self, pdata, lane_capacity, self.tile_of)

    def _cap(self, lanes: int) -> int:
        cap = self.migration_capacity or max(lanes // 8, 64)
        return min(cap, lanes)


def _migrate_tiles(pd, dom: XYTileDomain, band, cap):
    """Route every lane to the tile that owns it: (row of y) * tx + (column
    of x); the halo box is checked on both axes."""
    (ylo, yhi), (xlo, xhi) = band["halo_y"], band["halo_x"]
    y, x = pd["y"], pd["x"]
    viol = (pd["_active"] & (pd["state"] < MIN_ERROR_CODE)
            & ((y < ylo) | (y > yhi) | (x < xlo) | (x > xhi)))
    pd["_haloof"] = pd["_haloof"] + viol.sum().to(torch.int32)
    ry = torch.searchsorted(band["edges_y"], pd["y"].contiguous(), right=True)
    cx = torch.searchsorted(band["edges_x"], pd["x"].contiguous(), right=True)
    dest = ry * dom.tx + cx
    return _exchange(pd, pd["_active"] & (dest != dom.rank), dest, cap, dom)


def build_tile_executor(kernel_fns, dom: XYTileDomain, *, sign_dt: int, rk45_mode: bool,
                        z_occ=None):
    """The per-rank chunk executor of a tile decomposition (as
    ``build_domain_executor``)."""
    kernel_fns = tuple(kernel_fns)

    def chunk(farrays, pdata, endtime, dt0):
        return lockstep_chunk(dom, _migrate_tiles, kernel_fns, farrays, pdata, endtime, dt0,
                              sign_dt=sign_dt, rk45_mode=rk45_mode, z_occ=z_occ)

    return chunk

