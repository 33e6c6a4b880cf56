"""Y-band domain decomposition with per-step particle migration, over
``torch.distributed``.

Port of the JAX package's ``parallel/domain.py``. Each rank is a process
and owns one band of grid rows; it holds only its own band's slab of every
banded field, with ``halo`` rows on each side, so a particle can advance
while up to ``halo`` cells outside its band without communication.
Rectilinear grids band by latitude value; curvilinear grids (e.g. NEMO
tripolar) band by cell row index, with a lookup raster per band and
ownership judged on the cached cell row. Grids that are not banded are
replicated.

The band plans (edges, slab row starts, the coverage banding of secondary
grids, balancing) are the JAX package's host numpy, copied. The executor is
a per-rank step loop over the port's ``engine_step``; after every step the
lanes that left the band migrate:

- **neighbor** (uniform bands): each lane that left goes to the rank above
  or below (a particle crosses at most one band a step under the halo
  condition);
- **all2all** (non-uniform, e.g. balanced bands): one ragged exchange that
  delivers a lane to the band that owns it, however far.

Both are one ``_comm.all_to_all_rows`` a step (counts, then packed lanes):
at most ``migration_capacity`` lanes a destination; received lanes
fill inactive lanes; an overflow on either side is counted and raised on
the host, never dropped silently. Out-of-bounds is judged against the
GLOBAL domain edges (``GridSpec.y_oob_bounds``): a particle that leaves the
domain gets the single-card error, one that leaves its band migrates.

Lockstep: every rank makes the same collectives in the same order every
step, a rank with no live lane too. The loop condition is the max over
ranks of (busy, halt, failed), where halt includes a halo or migration
overflow, so such a chunk ends on every rank at once and its successor is a
no-op; a rank whose step raises finishes that step's collectives, and then
every rank raises.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from parcels_tpu_torch._core.engine import (
    RESORT_EVERY,
    _pick_sort_field,
    _sort_mode_enabled,
    _sort_soa,
    _sort_worthwhile,
    compute_loop_masks,
    engine_step,
    rk45_chunk_start_dt,
)
from parcels_tpu_torch._core.field import Field, FieldView, GridView, VectorField, VectorFieldView
from parcels_tpu_torch._core.fieldset import FieldSetView
from parcels_tpu_torch._core.statuscodes import MIN_ERROR_CODE, StatusCode
from parcels_tpu_torch._core.windowing import TimeWindow, _device_dtype
from parcels_tpu_torch.parallel import _comm
from parcels_tpu_torch.parallel.sharding import _SENTINEL_KEYS, rank_key

__all__ = ["YBandDomain", "build_domain_executor"]

#: SoA keys that are per-rank scalars or keys rather than particle lanes
_NON_LANE_KEYS = ("_rng", "_migof", "_haloof")


def _rank_and_world(n_bands):
    rank, world = _comm.world()
    if n_bands is not None and int(n_bands) != world:
        raise ValueError(f"n_bands={n_bands} must equal the world size ({world}): one band a "
                         "rank (torch.distributed.init_process_group, or init_distributed).")
    return rank, world


def _slab_rows(data, idx: np.ndarray) -> np.ndarray:
    """Rows ``idx`` (axis 2) of a (T, Z, Y, X) host array, as f32."""
    if getattr(data, "_parcels_lazy", False):
        host = np.empty(data.shape, np.float32)
        data.read_window(0, data.shape[0], host)
        data = host
    return np.ascontiguousarray(np.asarray(data)[:, :, idx, :], dtype=np.float32)


class YBandDomain:
    """Y-band domain decomposition of a structured-grid FieldSet, one band a rank.

    Parameters are the JAX package's: ``n_bands`` (default and only
    allowed value: the world size), ``halo`` rows on each side of a band
    (at least the largest per-step displacement in cells), ``headroom``
    (lane capacity over the largest band's initial occupancy),
    ``migration_capacity`` (lanes a destination a step; default an eighth
    of a band's lanes, at least 64), ``row_edges`` (``n_bands + 1``
    monotone global cell-row edges), ``migration`` (``auto``, ``neighbor``
    or ``all2all``) and ``slab_headroom`` (extra slab rows, so that
    ``rebalance`` can grow a band). ``devices`` is this rank's device (by
    default the fieldset's).
    """

    def __init__(self, fieldset, n_bands: int | None = None, halo: int = 2, devices=None,
                 headroom: float = 2.0, migration_capacity: int | None = None,
                 axis: str = "bands", row_edges=None, migration: str = "auto",
                 slab_headroom: int = 0):
        if migration not in ("auto", "neighbor", "all2all"):
            raise ValueError(
                f"migration must be 'auto', 'neighbor' or 'all2all'. Got {migration!r}"
            )
        self.migration = migration
        self.rank, self.n = _rank_and_world(n_bands)
        self.device = fieldset.device if devices is None else torch.device(
            devices[self.rank] if isinstance(devices, (list, tuple)) else devices)
        self.axis = axis
        self.halo = int(halo)
        self.headroom = float(headroom)
        self.slab_headroom = int(slab_headroom)
        self.migration_capacity = migration_capacity
        self.fieldset = fieldset
        self._static = None
        self._resident = None
        self._window = None
        #: lanes this rank sent, over the steps it ran (``last_run_stats``)
        self.stats = {"steps": 0, "sent": 0}
        self._row_edges = None if row_edges is None else np.asarray(row_edges, dtype=np.int64)
        #: per-grid slab row counts locked by the first build: a rebalance
        #: keeps every slab's shape
        self._Yl_locks: dict[int, int] = {}
        self._build_plans()

    @property
    def migration_mode(self) -> str:
        """The migration transport: neighbor hops for uniform bands,
        all2all when the partition is non-uniform."""
        if self.migration != "auto":
            return self.migration
        main = self._grid_plans[self._main_igrid]
        own = np.diff(main["row_edges"])
        return "all2all" if np.any(own != own[0]) else "neighbor"

    # -- plans (the JAX package's host numpy) ---------------------------------
    def _edges_for(self, ydim: int):
        """Per-grid row edges: the custom partition verbatim when this grid's
        ydim matches the main grid's, rescaled when it differs, uniform
        without a custom partition."""
        n = self.n
        r = self._row_edges
        if r is None:
            Yb = math.ceil(ydim / n)
            return Yb * np.arange(n + 1, dtype=np.int64)
        if r[-1] == ydim:
            return r.copy()
        main_ydim = int(r[-1])
        scaled = np.round(r.astype(np.float64) * (ydim / main_ydim)).astype(np.int64)
        scaled[0], scaled[-1] = 0, ydim
        for i in range(1, n + 1):
            scaled[i] = max(scaled[i], scaled[i - 1] + 1)
        for i in range(n, 0, -1):
            scaled[i - 1] = min(scaled[i - 1], scaled[i] - 1)
        if scaled[0] != 0 or np.any(np.diff(scaled) < 1):
            raise ValueError(
                f"row_edges {r} cannot be rescaled onto a banded grid with "
                f"ydim={ydim} ({n} bands need at least {n} rows)."
            )
        return scaled

    def _locked_Yl(self, igrid: int, computed: int) -> int:
        """Slab rows for banded grid ``igrid``: the first build locks them;
        later partitions pad up to the lock and refuse to exceed it."""
        lock = self._Yl_locks.get(igrid)
        if lock is None:
            computed += self.slab_headroom
            self._Yl_locks[igrid] = computed
            return computed
        if computed > lock:
            raise ValueError(
                f"rebalanced row_edges imply slab rows {computed} > locked "
                f"{lock}; cap band sizes (balanced_row_edges(max_rows=...))."
            )
        return lock

    def _build_plans(self):
        """Per-grid banding plans: one MAIN grid (curvilinear preferred)
        judges ownership and migration; other Y grids are banded by
        coverage of the main band's slab latitude range."""
        h, n = self.halo, self.n
        grids = list(self.fieldset.gridset)
        elig = ["Y" in getattr(g.spec, "axes", ()) and g.spec.ydim >= n for g in grids]
        curv = [bool(getattr(g.spec, "curvilinear", False)) for g in grids]
        main_pos = next((i for i in range(len(grids)) if elig[i] and curv[i]), None)
        if main_pos is None:
            main_pos = next((i for i in range(len(grids)) if elig[i]), None)
        if main_pos is None:
            raise ValueError("FieldSet has no grid decomposable along Y.")
        if self._row_edges is not None:
            r = self._row_edges
            main_ydim = grids[main_pos].spec.ydim
            if len(r) != n + 1 or r[0] != 0 or r[-1] != main_ydim or np.any(np.diff(r) < 1):
                raise ValueError(
                    f"row_edges must be {n + 1} monotone ints from 0 to the "
                    f"main banded grid's ydim ({main_ydim}) with at least 1 "
                    f"row per band. Got {r}."
                )
        r_main = self._edges_for(grids[main_pos].spec.ydim)
        Yl_main = self._locked_Yl(main_pos, int(np.diff(r_main).max()) + 2 * h)
        build = self._curv_plan if curv[main_pos] else self._rect_plan
        main_plan = build(grids[main_pos], r_main[:-1].astype(np.int64), Yl_main, r_main,
                          main=True)
        lo_b, hi_b = self._band_y_ranges(main_plan)
        self._grid_plans = []
        for i, grid in enumerate(grids):
            if i == main_pos:
                self._grid_plans.append(main_plan)
                continue
            if not elig[i]:
                self._grid_plans.append({"banded": False, "grid": grid, "spec": grid.spec})
                continue
            starts, Ylc = self._coverage_starts(grid, curv[i], lo_b, hi_b)
            Yl = self._locked_Yl(i, Ylc)
            # pseudo-edges whose diffs equal the start deltas: migration
            # rebasing only reads starts and their differences
            pseudo = np.concatenate([starts, [starts[-1] + max(Yl - 2 * h, 1)]])
            build = self._curv_plan if curv[i] else self._rect_plan
            self._grid_plans.append(build(grid, starts, Yl, pseudo, main=False))
        self._main_igrid = main_pos
        self.curvilinear = bool(main_plan.get("curvilinear", False))
        if self.curvilinear:
            self.band_lo = self.band_hi = self._interior_edges = None
        else:
            self.band_lo = main_plan["band_lo"]
            self.band_hi = main_plan["band_hi"]
            self._interior_edges = main_plan["band_hi"][:-1]

    def _rect_plan(self, grid, starts, Yl, row_edges, main: bool):
        """Banded plan for a rectilinear grid (slab b = extended nodes
        [s_b, s_b + Yl])."""
        h = self.halo
        spec = grid.spec
        la = np.asarray(grid.lat, dtype=np.float64)
        ydim = spec.ydim
        starts = np.asarray(starts, dtype=np.int64)
        extra = max(0, int(starts.max()) + (Yl - 2 * h) - ydim)
        d0 = la[1] - la[0]
        dN = la[-1] - la[-2]
        north = la[-1] + dN * np.arange(1, extra + h + 1)
        south = la[0] - d0 * np.arange(h, 0, -1)
        lax_ext = np.concatenate([south, la, north])
        plan = {
            "banded": True,
            "grid": grid,
            "spec": dataclasses.replace(spec, ydim=Yl, lat_uniform=None, has_lookup=False,
                                        y_oob_bounds=(float(la[0]), float(la[-1]))),
            "row_starts": starts,
            "rows": Yl + 1,
            "pad_south": h,
            "pad_north": extra + h,
            "lat_slabs": np.stack([lax_ext[s:s + Yl + 1] for s in starts]).astype(np.float32),
            "lat_ext64": lax_ext,
            "row_edges": np.asarray(row_edges, dtype=np.int64),
            "ydim_nodes": ydim + 1,
        }
        if main:
            r = np.asarray(row_edges, dtype=np.int64)
            edges = lax_ext[h + np.minimum(r, ydim + extra)]
            band_lo = edges[:-1].copy()
            band_hi = edges[1:].copy()
            band_lo[0] = -np.inf
            band_hi[-1] = np.inf
            plan["band_lo"] = band_lo
            plan["band_hi"] = band_hi
        return plan

    def _curv_plan(self, grid, starts, Yl, row_edges, main: bool):
        """Banded plan for a curvilinear grid (index-space banding; edge rows
        replicated outward, so a lane past the grid fails its walk as on one
        card). The lookup rasters are built for this rank's band only."""
        h = self.halo
        spec = grid.spec
        la2 = np.asarray(grid.lat, dtype=np.float64)
        lo2 = np.asarray(grid.lon, dtype=np.float64)
        ydim = spec.ydim
        starts = np.asarray(starts, dtype=np.int64)
        extra = max(0, int(starts.max()) + (Yl - 2 * h) - ydim)
        lat_ext = np.concatenate([np.repeat(la2[:1], h, 0), la2,
                                  np.repeat(la2[-1:], extra + h, 0)])
        lon_ext = np.concatenate([np.repeat(lo2[:1], h, 0), lo2,
                                  np.repeat(lo2[-1:], extra + h, 0)])
        return {
            "banded": True,
            "curvilinear": True,
            "grid": grid,
            "spec": dataclasses.replace(spec, ydim=Yl, has_lookup=True, y_oob_bounds=None),
            "row_starts": starts,
            "rows": Yl + 1,
            "pad_south": h,
            "pad_north": extra + h,
            "lat_slabs": np.stack([lat_ext[s:s + Yl + 1] for s in starts]).astype(np.float32),
            "lon_slabs": np.stack([lon_ext[s:s + Yl + 1] for s in starts]).astype(np.float32),
            "lat_ext64": lat_ext,
            "lon_ext64": lon_ext,
            "row_edges": np.asarray(row_edges, dtype=np.int64),
            "ydim_nodes": ydim + 1,
        }

    def _band_y_ranges(self, main_plan):
        """Per-band latitude coverage of the MAIN plan's slabs."""
        n = self.n
        rows = main_plan["rows"]
        lo = np.empty(n)
        hi = np.empty(n)
        lat = main_plan["lat_ext64"]
        for b, s in enumerate(main_plan["row_starts"]):
            sl = lat[s:s + rows]
            lo[b] = float(np.min(sl))
            hi[b] = float(np.max(sl))
        lo[0] = -np.inf
        hi[-1] = np.inf
        return lo, hi

    def _coverage_starts(self, grid, is_curv: bool, lo_b, hi_b):
        """Slab row starts and the slab height a SECONDARY banded grid needs
        so that band b covers latitudes [lo_b, hi_b]."""
        h = self.halo
        m = 1  # interpolation-stencil margin rows
        if is_curv:
            la2 = np.asarray(grid.lat, dtype=np.float64)
            ny_nodes = la2.shape[0]
            cummax = np.maximum.accumulate(la2.max(axis=1))
            sufmin = np.minimum.accumulate(la2.min(axis=1)[::-1])[::-1]
            a = np.clip(np.searchsorted(cummax, lo_b, side="right") - 1, 0, ny_nodes - 1)
            bnd = np.clip(np.searchsorted(sufmin, hi_b, side="left"), 0, ny_nodes - 1)
        else:
            la = np.asarray(grid.lat, dtype=np.float64)
            nn = la.shape[0]
            a = np.clip(np.searchsorted(la, lo_b, side="right") - 1, 0, nn - 1)
            bnd = np.clip(np.searchsorted(la, hi_b, side="left"), 0, nn - 1)
        a = np.minimum(a, bnd)
        Yl_needed = int(np.max(bnd - a)) + 2 * m
        starts = np.maximum(a - m + h, 0).astype(np.int64)
        starts = np.maximum.accumulate(starts)
        return starts, Yl_needed

    # -- this rank's slab on its device ----------------------------------------
    def _tensor(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _band_grid(self, plan) -> dict:
        """This rank's tensors of one banded grid: its slab's node
        coordinates, lookup raster, search and C-grid geometry tables."""
        from parcels_tpu_torch._core.grid import _build_curvilinear_lookup, cgrid_geometry_from_coords
        from parcels_tpu_torch._core.index_search import build_pic_table

        b, grid = self.rank, plan["grid"]
        s, rows = plan["row_starts"][b], plan["rows"]
        curv = plan.get("curvilinear", False)
        lat_b = plan["lat_ext64"][s:s + rows]
        lon_b = plan["lon_ext64"][s:s + rows] if curv else np.asarray(grid.lon, np.float64)
        g = {
            "lon": self._tensor(plan["lon_slabs"][b] if curv else grid.lon.astype(np.float32)),
            "lat": self._tensor(plan["lat_slabs"][b]),
            "depth": self._tensor(grid.depth.astype(np.float32)),
            "time": self._tensor(grid.time.astype(np.float32)),
        }
        spherical = plan["spec"].spherical
        if curv:
            Yl = plan["rows"] - 1
            nx_nodes = plan["lon_slabs"].shape[2]
            lk = _build_curvilinear_lookup(
                plan["lon_slabs"][b], plan["lat_slabs"][b],
                shape=(min(4 * Yl, 1024), min(4 * max(nx_nodes - 1, 1), 2048)))
            g["lookup_yi"] = self._tensor(lk["yi"])
            g["lookup_xi"] = self._tensor(lk["xi"])
            plan["lookup_meta"] = {"origin": lk["origin"], "step": lk["step"]}
            g["pic_table"] = self._tensor(build_pic_table(lon_b, lat_b, spherical))
        if grid._needs_cgrid_geom and "X" in grid.axes and "Y" in grid.axes:
            # per-cell geometry in the band's frame, from its halo-extended
            # node coordinates (f64, the global table's math)
            g["cgrid_geom"] = self._tensor(cgrid_geometry_from_coords(lon_b, lat_b, spherical))
        return g

    def _static_arrays(self) -> dict:
        """What every chunk of this rank shares: the grids (banded ones as
        this band's slab), the time-invariant fields and the band metadata."""
        if self._static is not None:
            return self._static
        from parcels_tpu_torch.ops.stagecache import attach_derived_tables

        b, n = self.rank, self.n
        out = {"fields": {}, "grids": [], "band": {"rows_meta": {}, "row_starts": {}}}
        band = out["band"]
        for i, plan in enumerate(self._grid_plans):
            if not plan["banded"]:
                out["grids"].append(plan["grid"].device_arrays(self.device))
                continue
            out["grids"].append(self._band_grid(plan))
            own = np.diff(plan["row_edges"])
            # frame shifts of a send to the band above (own[b]) or below
            # (own[b - 1]), and the full partition for all2all rebasing
            band["rows_meta"][i] = (int(own[b]), int(own[b]) if b < n - 1 else 0,
                                    int(own[b - 1]) if b > 0 else 0)
            band["row_starts"][i] = self._tensor(plan["row_edges"][:-1].astype(np.int64))
        for name, f in self.fieldset.fields.items():
            if isinstance(f, Field) and f.data.shape[0] <= 1:
                out["fields"][name] = self._field_slab(f, f.data)
        main = self._grid_plans[self._main_igrid]
        if self.curvilinear:
            band["halo"] = None
            band["lo"] = band["hi"] = 0.0
            edges = main["row_edges"][1:-1].astype(np.int64)
        else:
            slab = main["lat_slabs"][b]
            # the slab's node extent: a lane landing beyond it had its samples
            # clamped at the slab edge this step (halo too small: raise)
            band["halo"] = (float(slab[0]), float(slab[-1]))
            band["lo"] = float(np.float32(self.band_lo[b]))
            band["hi"] = float(np.float32(self.band_hi[b]))
            edges = np.asarray(self._interior_edges, dtype=np.float32)
        band["edges"] = self._tensor(edges)
        attach_derived_tables(self.fieldset, out)
        self._static = out
        return out

    def _field_slab(self, f, data) -> torch.Tensor:
        """Field ``f``'s (window of) data as this rank holds it: its band's
        slab rows (edge rows repeated past the grid) if its grid is banded."""
        plan = self._grid_plans[f.igrid]
        if not plan["banded"]:
            from parcels_tpu_torch._core.fieldset import _device_copy

            return _device_copy(data, self.device)
        Y = data.shape[2]
        s = plan["row_starts"][self.rank]
        idx = np.clip(np.arange(s, s + plan["rows"]) - plan["pad_south"], 0, Y - 1)
        return self._tensor(_slab_rows(data, idx))

    def stacked_farrays(self) -> dict:
        """This rank's field and grid tensors (the whole time axis)."""
        if self._resident is None:
            farrays = _copy_farrays(self._static_arrays())
            for name, f in self.fieldset.fields.items():
                if isinstance(f, Field) and name not in farrays["fields"]:
                    farrays["fields"][name] = self._field_slab(f, f.data)
            self._resident = farrays
        return self._resident

    # -- time windows (the band twin of FieldSet.windowed_arrays) --------------
    def _ensure_windowed_specs(self):
        """A window's time values are no uniform axis (as for the fieldset's
        own grids under ``set_time_window``)."""
        for plan in self._grid_plans:
            if (plan["banded"] and plan["spec"].time_uniform is not None
                    and plan["grid"].time.shape[0] > 1):
                plan["spec"] = dataclasses.replace(plan["spec"], time_uniform=None)

    def _time_window(self) -> TimeWindow:
        if self._window is None:
            self._window = TimeWindow(self.device, self.fieldset._time_window)
        return self._window

    def _build_window(self, offsets: tuple):
        """Read the window's levels of every time-varying field, keep this
        band's slab rows, and stage them (the fieldset's pinned buffers and
        copy stream, ``windowing.Stager``); counted in its window_stats as
        the whole levels read, at the device's f32, as the JAX package
        counts them."""
        from parcels_tpu_torch._core.fieldset import _copier, _level_reader

        L = self.fieldset._time_window
        parts, loads, nbytes = [], 0, 0
        for i, (i0, grid) in enumerate(zip(offsets, self.fieldset.gridset)):
            if grid.time.shape[0] > 1:
                t = grid.time[i0:i0 + L].astype(np.float32)
                parts.append((("grid", i), t.shape, t.dtype, _copier(t)))
        for name, f in self.fieldset.fields.items():
            if not (isinstance(f, Field) and f.data.shape[0] > 1):
                continue
            i0 = offsets[f.igrid]
            lv = min(L, f.data.shape[0] - i0)
            full = (lv,) + tuple(f.data.shape[1:])
            plan = self._grid_plans[f.igrid]
            if plan["banded"]:
                s = plan["row_starts"][self.rank]
                idx = np.clip(np.arange(s, s + plan["rows"]) - plan["pad_south"], 0,
                              f.data.shape[2] - 1)
                shape = full[:2] + (idx.size,) + full[3:]
            else:
                idx, shape = None, full
            parts.append((("field", name), shape, np.float32,
                          _band_reader(_level_reader(f.data, i0, lv), full, idx)))
            loads += 1
            nbytes += int(np.prod(full)) * _device_dtype(f.data.dtype).itemsize
        return self.fieldset._window.stage(parts, loads, nbytes)

    def _publish(self, window) -> dict:
        farrays = _copy_farrays(self._static_arrays())
        for (kind, key), tensor in window.publish().items():
            if kind == "grid":
                farrays["grids"][key]["time"] = tensor
            else:
                farrays["fields"][key] = tensor
        return farrays

    def stacked_windowed(self, t_lo: float, t_hi: float) -> dict:
        """This rank's tensors with time axes covering [t_lo, t_hi]."""
        if self.fieldset._time_window is None:
            return self.stacked_farrays()
        self._ensure_windowed_specs()
        key = self.fieldset._window_offsets(t_lo, t_hi)
        return self._time_window().take(key, self._build_window, self._publish)

    def prefetch_window(self, t_anchor: float) -> None:
        """Stage the band's window anchored at ``t_anchor`` on the prefetch thread."""
        if self.fieldset._time_window is None:
            return
        self._ensure_windowed_specs()
        key = self.fieldset._window_offsets(t_anchor, t_anchor, check=False)
        self._time_window().prefetch(key, self._build_window)

    def build_views(self, farrays: dict) -> FieldSetView:
        """The kernels' fieldset view over this rank's tensors (as
        ``FieldSet.build_views``, with the banded grid specs)."""
        from parcels_tpu_torch.ops.stagecache import soa_cache_owner

        return _views(self.fieldset, self._grid_plans, farrays, "banded",
                      soa_cache_owner(self.fieldset)[0])

    # -- ownership -------------------------------------------------------------
    def global_row_of(self, y, x=None) -> np.ndarray:
        """Global cell-row index per particle on the main banded grid (a
        search on the host)."""
        main = self._grid_plans[self._main_igrid]
        grid = main["grid"]
        y = np.asarray(y, dtype=np.float32)
        x = np.zeros_like(y) if x is None else np.asarray(x, dtype=np.float32)
        yt, xt = torch.from_numpy(y), torch.from_numpy(x)
        gpos = grid.make_view(grid.device_arrays("cpu")).search(torch.zeros_like(yt), yt, xt)
        yi = gpos["Y"]["index"].numpy()
        return np.clip(yi, 0, grid.spec.ydim - 1)

    def band_of(self, y, x=None) -> np.ndarray:
        """Owning band per particle: latitude thresholds (the f32 edges the
        migration compares with), or the global cell row on a curvilinear
        main grid."""
        if not self.curvilinear:
            edges = np.asarray(self._interior_edges, dtype=np.float32)
            return np.searchsorted(edges, np.asarray(y, dtype=np.float32), side="right")
        yi = self.global_row_of(y, x)
        r = self._grid_plans[self._main_igrid]["row_edges"]
        return np.clip(np.searchsorted(r[1:-1], yi, side="right"), 0, self.n - 1).astype(np.int64)

    def balanced_row_edges(self, y, x=None, max_rows: int | None = None,
                           min_rows: int = 1) -> np.ndarray:
        """Row edges that split a particle sample evenly over the bands
        (greedy equal-count partition of the per-row histogram, each band
        within [min_rows, max_rows] rows)."""
        n = self.n
        main = self._grid_plans[self._main_igrid]
        ydim = int(main["grid"].spec.ydim)
        rows = self.global_row_of(y, x)
        hist = np.bincount(rows, minlength=ydim).astype(np.float64)
        if max_rows is None:
            max_rows = ydim
        if max_rows * n < ydim:
            raise ValueError(f"max_rows={max_rows} cannot cover ydim={ydim} with {n} bands.")
        edges = np.zeros(n + 1, dtype=np.int64)
        edges[-1] = ydim
        remaining = hist.sum()
        pos = 0
        for b in range(n - 1):
            bands_left = n - b
            target = remaining / bands_left
            cum = np.cumsum(hist[pos:])
            k = int(np.searchsorted(cum, target, side="left")) + 1
            hi = ydim - pos - (bands_left - 1) * min_rows
            lo_needed = ydim - pos - (bands_left - 1) * max_rows
            k = int(np.clip(k, max(min_rows, lo_needed), min(max_rows, hi)))
            pos += k
            edges[b + 1] = pos
            remaining -= hist[edges[b]:pos].sum()
        if np.any(np.diff(edges) < 1) or np.any(np.diff(edges) > max_rows):
            raise ValueError(f"balanced edges infeasible: {edges} (max_rows={max_rows})")
        return edges

    def rebalance(self, y, x=None) -> np.ndarray:
        """Re-derive the band edges from particle positions, within the
        locked slab size; the next ``execute`` re-shards. Returns the edges.
        Every rank passes the same positions (a gathered SoA)."""
        max_rows = int(self._Yl_locks[self._main_igrid]) - 2 * self.halo
        main_ydim = int(self._grid_plans[self._main_igrid]["grid"].spec.ydim)
        if max_rows * self.n <= main_ydim:
            warnings.warn(
                f"rebalance(): the locked slab ({max_rows} rows/band x "
                f"{self.n} bands) leaves no room to move any edge on "
                f"ydim={main_ydim}; pass slab_headroom= at construction.",
                stacklevel=2,
            )
        edges = self.balanced_row_edges(y, x, max_rows=max_rows)
        self.set_row_edges(edges)
        return edges

    def set_row_edges(self, edges) -> None:
        """Apply a new band partition (see rebalance)."""
        self._row_edges = np.asarray(edges, dtype=np.int64)
        self._static = self._resident = None
        if self._window is not None:
            self._window.current = None
            self._window.futures.clear()
        self._build_plans()

    def lane_capacity(self, pdata: dict) -> int:
        return _capacity(self, _owners(self.band_of, pdata)[1])

    def shard_soa(self, pdata: dict, lane_capacity: int | None = None) -> dict:
        """This rank's lanes of the global SoA: its band's active particles,
        padded with inactive lanes to the lane capacity (equal on every
        rank), on its device, with its own RNG key (the set's split once per
        band) and its overflow counters ``_migof``/``_haloof``."""
        return _own_lanes(self, pdata, lane_capacity, self.band_of)

    def _cap(self, lanes: int) -> int:
        cap = self.migration_capacity or max(lanes // 8, 64)
        return min(cap, lanes)


# ---------------------------------------------------------------------------
# shared by the band and tile domains
# ---------------------------------------------------------------------------


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _copy_farrays(static: dict) -> dict:
    """A farrays dict over the static tensors that a chunk may extend."""
    out = {"fields": dict(static["fields"]), "grids": [dict(g) for g in static["grids"]],
           "band": static["band"]}
    if "celltables" in static:
        out["celltables"] = static["celltables"]
    return out


def _band_reader(read_levels, full_shape, idx):
    """Writes a band's slab rows of a window: the levels are read whole (a
    store reads whole levels), then the rows are kept."""
    if idx is None:
        return read_levels

    def fill(out):
        tmp = np.empty(full_shape, np.float32)
        read_levels(tmp)
        np.copyto(out, tmp[:, :, idx, :])

    return fill


def _views(fieldset, plans, farrays, flag: str, sc_owner) -> FieldSetView:
    """Field views over a rank's tensors; ``plans[i][flag]`` marks the
    grids that are the rank's slab (their plan's spec and lookup)."""
    grid_views = []
    for i, plan in enumerate(plans):
        garrs = farrays["grids"][i]
        if plan[flag]:
            grid_views.append(GridView(plan["spec"], garrs, plan.get("lookup_meta")))
        else:
            grid_views.append(plan["grid"].make_view(garrs))
    celltables = farrays.get("celltables", {})
    tables = farrays.setdefault("tables", {})
    views: dict[str, object] = {}
    for name, f in fieldset.fields.items():
        if isinstance(f, Field):
            views[name] = FieldView(name, farrays["fields"][name], grid_views[f.igrid], f.igrid,
                                    f.interp_method, f.data.shape[0] > 1,
                                    tables.setdefault(name, {}))
    for name, f in fieldset.fields.items():
        if isinstance(f, VectorField):
            views[name] = VectorFieldView(
                name, views[f.U.name], views[f.V.name],
                views[f.W.name] if f.W is not None else None, f.interp_method,
                sc_owner=(name == sc_owner), tables=tables.setdefault(name, {}),
            )
            if f.igrid in celltables:
                views[name]._cell_table = celltables[f.igrid]
    return FieldSetView(views, dict(fieldset.context))


def _owners(owner_of, pdata: dict):
    """(active lane indices, their owning ranks) of the global SoA."""
    idx_act = np.flatnonzero(_np(pdata["_active"]).astype(bool))
    return idx_act, owner_of(_np(pdata["y"])[idx_act], _np(pdata["x"])[idx_act])


def _capacity(dom, owner) -> int:
    """Lanes a rank: the fullest rank's particles times the headroom, in 8s."""
    counts = np.bincount(owner, minlength=dom.n)
    cap = max(int(counts.max(initial=0) * dom.headroom), 8)
    return -(-cap // 8) * 8


def _own_lanes(dom, pdata: dict, L: int | None, owner_of) -> dict:
    """This rank's lanes: the active particles ``owner_of`` assigns to it,
    padded to ``L`` lanes (default: ``_capacity``); band-local cell indices
    recomputed on its slab, persistent-cache cells invalidated (they are
    slab-local)."""
    idx_act, owner = _owners(owner_of, pdata)
    L = L or _capacity(dom, owner)
    counts = np.bincount(owner, minlength=dom.n)
    if counts.max(initial=0) > L:
        raise ValueError(f"Band occupancy {counts.max()} exceeds lane capacity {L}.")
    rows = torch.as_tensor(idx_act[owner == dom.rank])
    out = {}
    for k, v in pdata.items():
        if k == "_rng":
            out[k] = rank_key(v, dom.rank, dom.n)
            continue
        mine = v[rows.to(v.device)].to(dom.device)
        fill = torch.full((L - mine.shape[0],) + tuple(mine.shape[1:]),
                          -1 if k in _SENTINEL_KEYS else 0, dtype=v.dtype, device=dom.device)
        out[k] = torch.cat([mine, fill])
    i32 = dict(dtype=torch.int32, device=dom.device)
    out["_migof"] = torch.zeros((), **i32)
    out["_haloof"] = torch.zeros((), **i32)
    return _restart_cache(dom, _local_indices(dom, out))


def _local_indices(dom, pd: dict) -> dict:
    """Cell indices of the lanes on the rank's slab grids (warm start and
    sort key in the slab's frame).

    On a curvilinear slab the search starts from each lane's cell on the
    whole grid (a search on the host), shifted into the slab's rows: a
    search that starts from cell (0, 0) can take an antipodal point for
    inside a band's degenerate edge-row cells (the JAX package's band
    executor does, and then fails the lane's walk)."""
    farrays = dom._static_arrays()
    ei = pd["ei"].clone()
    flag = "banded" if "banded" in dom._grid_plans[0] else "tiled"
    for g, plan in enumerate(dom._grid_plans):
        if not plan[flag]:
            continue
        spec = plan["spec"]
        view = GridView(spec, farrays["grids"][g], plan.get("lookup_meta"))
        guess = _global_cells(dom, plan, pd) if plan.get("curvilinear") else None
        gpos = view.search(pd["z"], pd["y"], pd["x"], ei=guess)
        ydim, xdim = max(spec.ydim, 1), max(spec.xdim, 1)
        zi = torch.clamp(gpos["Z"]["index"], 0, max(spec.zdim - 1, 0))
        yi = torch.clamp(gpos["Y"]["index"], 0, ydim - 1)
        xi = torch.clamp(gpos["X"]["index"], 0, xdim - 1)
        ei[:, g] = ((zi * ydim + yi) * xdim + xi).to(ei.dtype)
    pd["ei"] = ei
    return pd


def _global_cells(dom, plan, pd: dict) -> torch.Tensor:
    """Each lane's cell on ``plan``'s whole grid (searched on the host),
    as a cell index of this rank's slab."""
    grid = plan["grid"]
    y, x = pd["y"].cpu(), pd["x"].cpu()
    gpos = grid.make_view(grid.device_arrays("cpu")).search(torch.zeros_like(y), y, x)
    xdim, ydim = max(plan["spec"].xdim, 1), max(plan["spec"].ydim, 1)
    row = gpos["Y"]["index"].clamp(0, grid.spec.ydim - 1) + plan["pad_south"]
    row = (row - int(plan["row_starts"][dom.rank])).clamp(0, ydim - 1)
    col = gpos["X"]["index"].clamp(0, xdim - 1)
    return (row * xdim + col).to(pd["ei"].dtype).to(pd["ei"].device)


def _exchange(pd: dict, mover, dest, cap: int, dom, on_send=None):
    """Send the ``mover`` lanes to rank ``dest`` (one rank, or one a lane),
    at most ``cap`` a destination; merge the lanes received into inactive
    lanes. Returns (pd, overflow, lanes sent): the overflow counts lanes
    left unsent (send buffer full) or dropped (no free lane), which the
    host raises on."""
    n = dom.n
    lane_keys = [k for k in pd if k not in _NON_LANE_KEYS and k != "_active"]
    if not isinstance(dest, torch.Tensor):
        dest = torch.full_like(pd["state"], int(dest), dtype=torch.int64)
    key = torch.where(mover, dest.to(torch.int64), n)
    counts = torch.bincount(key, minlength=n + 1)[:n].tolist()
    sent = [min(c, cap) for c in counts]
    order = torch.sort(key, stable=True).indices
    starts = np.concatenate([[0], np.cumsum(counts)])
    sel = torch.cat([order[int(starts[d]):int(starts[d]) + sent[d]] for d in range(n)])
    buf = {k: pd[k][sel] for k in lane_keys}
    if on_send is not None and sel.numel():
        dst = torch.repeat_interleave(torch.arange(n, device=sel.device),
                                      torch.as_tensor(sent, device=sel.device))
        buf = on_send(buf, dst)
    active = pd["_active"].clone()
    active[sel] = False
    recv, rcounts = _comm.all_to_all_rows(buf, sent, dom.device)
    nrecv = sum(rcounts)
    overflow = sum(counts) - sum(sent)
    if nrecv:
        free = torch.nonzero(~active).flatten()
        take = min(nrecv, int(free.numel()))
        overflow += nrecv - take
        dst_lanes = free[:take]
        for k in lane_keys:
            pd[k] = pd[k].index_put((dst_lanes,), recv[k][:take])
        active[dst_lanes] = True
    pd["_active"] = active
    return pd, overflow, sum(sent)


def _restart_cache(dom, pd: dict) -> dict:
    """Invalidate the lanes' persistent-cache entries (their cells are in
    another slab's frame), keeping each lane's current cell (from ``ei``,
    in this frame) as where its repair starts: the time index is set to -1,
    which no sample matches. (The JAX package sets the cell to -1, so the
    repair starts from cell (0, 0), which on the first band is a degenerate
    edge-row cell that an antipodal point can pass.)"""
    if "_sc_key" not in pd:
        return pd
    from parcels_tpu_torch.ops.stagecache import soa_cache_owner

    owner = soa_cache_owner(dom.fieldset)[0]
    if owner is None:
        return pd
    g = dom.fieldset.fields[owner].igrid
    spec = dom._grid_plans[g]["spec"]
    key = pd["_sc_key"].clone()
    key[:, 0] = (pd["ei"][:, g] % (max(spec.ydim, 1) * max(spec.xdim, 1))).to(key.dtype)
    key[:, 1] = -1
    return dict(pd, _sc_key=key)


def _rebase_ei(dom, buf, delta_of):
    """Shift the migrated lanes' cached row indices of every banded grid by
    ``delta_of(g)`` (a scalar or one a lane) into the receiver's frame,
    and invalidate their persistent-cache entries (``_restart_cache``)."""
    ei = buf["ei"].clone()
    for g, plan in enumerate(dom._grid_plans):
        if not plan["banded"]:
            continue
        sp = plan["spec"]
        xd, yd = max(sp.xdim, 1), max(sp.ydim, 1)
        col = ei[:, g]
        xi, yi, zi = col % xd, (col // xd) % yd, col // (xd * yd)
        yi = torch.clamp(yi - delta_of(g), 0, yd - 1)
        ei[:, g] = ((zi * yd + yi) * xd + xi).to(ei.dtype)
    return _restart_cache(dom, dict(buf, ei=ei))


def _count_halo(pd, lo, hi):
    """Rectilinear halo diagnostic: a live lane beyond its slab's node
    extent had its samples clamped at the slab edge this step."""
    viol = pd["_active"] & (pd["state"] < MIN_ERROR_CODE) & ((pd["y"] < lo) | (pd["y"] > hi))
    pd["_haloof"] = pd["_haloof"] + viol.sum().to(torch.int32)


def _count_walk_failures(pd):
    """Curvilinear halo diagnostic: a lane that out-ran its slab failed its
    point-in-cell walk (the host tells a halo breach from leaving the grid)."""
    viol = pd["_active"] & (pd["state"] == StatusCode.ErrorGridSearching)
    pd["_haloof"] = pd["_haloof"] + viol.sum().to(torch.int32)


def _migrate_neighbor(pd, dom, band, cap):
    """Rectilinear bands: the lanes above the band go to the rank above, the
    lanes below it to the rank below, in one exchange (the JAX package's
    two ``ppermute`` hops: under the halo condition no lane crosses two
    bands, so a received lane is never sent on in the same step)."""
    if band["halo"] is not None:
        _count_halo(pd, *band["halo"])
    up, down = pd["y"] >= band["hi"], pd["y"] < band["lo"]
    dest = torch.where(up, dom.rank + 1, dom.rank - 1)
    return _exchange(pd, pd["_active"] & (up | down), dest, cap, dom)


def _migrate_curvilinear(pd, dom, band, cap):
    """Curvilinear bands: movers judged on the cached cell row of the main
    grid (refreshed at every sample; the halo absorbs its one-step lag), in
    one exchange as on rectilinear bands; their rows rebased by the row
    shift between the two bands into the receiver's frame."""
    _count_walk_failures(pd)
    h = dom.halo
    main_i = dom._main_igrid
    spec = dom._grid_plans[main_i]["spec"]
    xdim, ydim_l = max(spec.xdim, 1), max(spec.ydim, 1)
    meta = band["rows_meta"]
    yi_local = (pd["ei"][:, main_i] // xdim) % ydim_l
    up = (yi_local >= h + meta[main_i][0]) & (dom.rank < dom.n - 1)
    down = (yi_local < h) & (dom.rank > 0)
    dest = torch.where(up, dom.rank + 1, dom.rank - 1)

    def on_send(buf, dst):
        return _rebase_ei(dom, buf, lambda g: torch.where(dst > dom.rank, meta[g][1],
                                                          -meta[g][2]))

    return _exchange(pd, pd["_active"] & (up | down), dest, cap, dom, on_send=on_send)


def _migrate_all2all(pd, dom, band, cap):
    """Ownership-routed migration: each lane goes straight to the band that
    owns it (latitude thresholds, or the global cell row)."""
    if dom.curvilinear:
        _count_walk_failures(pd)
        main_i = dom._main_igrid
        spec = dom._grid_plans[main_i]["spec"]
        xdim, ydim_l = max(spec.xdim, 1), max(spec.ydim, 1)
        starts = band["row_starts"][main_i]
        yi_local = (pd["ei"][:, main_i] // xdim) % ydim_l
        grow = yi_local.to(torch.int64) - dom.halo + starts[dom.rank]
        dest = torch.searchsorted(band["edges"], grow.contiguous(), right=True)

        def on_send(buf, dst):
            return _rebase_ei(dom, buf, lambda g: (band["row_starts"][g][dst]
                                                   - band["row_starts"][g][dom.rank]))
    else:
        if band["halo"] is not None:
            _count_halo(pd, *band["halo"])
        dest = torch.searchsorted(band["edges"], pd["y"].contiguous(), right=True)
        on_send = None
    mover = pd["_active"] & (dest != dom.rank)
    return _exchange(pd, mover, dest, cap, dom, on_send=on_send)


def lockstep_chunk(dom, migrate, kernel_fns, farrays, pd, endtime, dt0, *, sign_dt,
                   rk45_mode, z_occ=None):
    """Advance this rank's lanes to ``endtime``, in step with every rank.

    The port's ``run_chunk`` ends its loop on local state; here the loop
    condition is the max over ranks of (busy, halt, failed), so every rank
    runs the same steps and migrations. All local lanes run as one block
    (as in the JAX band executor): a migration changes the lane set every
    step, so the SoA is sorted for the slab sampler at the chunk's start and
    every ``RESORT_EVERY`` steps, as ``run_chunk`` does; lanes merged in
    between have corners outside their windows, which K2 reads from the
    field with the same arithmetic. Lanes never interact, so the lanes' order changes
    no value.
    """
    from parcels_tpu_torch.ops import stagecache

    fsview = dom.build_views(farrays)
    stagecache.prebuild_tables(fsview)
    pd = dict(pd)
    st = pd["state"]
    # requeue keeps halt states, so a chunk after a halted one is a no-op
    pd["state"] = torch.where(
        pd["_active"] & (st < MIN_ERROR_CODE) & (st != StatusCode.StopAllExecution),
        int(StatusCode.Evaluate), st).to(torch.int32)
    if rk45_mode:
        pd["dt"] = rk45_chunk_start_dt(fsview, pd, sign_dt)
    fs = dom.fieldset

    def shape_of(f):
        return tuple(farrays["fields"][f.name].shape)

    n = pd["state"].shape[0]
    sort_field = _pick_sort_field(fs, shape_of) if _sort_mode_enabled(fs, shape_of) else None
    sorting = sort_field is not None and _sort_worthwhile(fs, sort_field, n, z_occ, shape_of)
    if sorting:
        pd = _sort_soa(fsview, sort_field, pd, z_occ)[0]
    band = farrays["band"]
    cap = dom._cap(n)
    failure = None
    it = 0
    while True:
        busy, halt = compute_loop_masks(pd, endtime, sign_dt)
        halt_any = halt.any() | (pd["_migof"] > 0) | (pd["_haloof"] > 0)
        failed = torch.tensor(failure is not None, device=halt_any.device)
        flags = _comm.allreduce_max(torch.stack([busy.any(), halt_any, failed]))
        if flags[2] or not flags[0] or flags[1]:
            break
        try:
            pd = engine_step(fsview, pd, endtime, dt0, kernel_fns, sign_dt, rk45_mode,
                             sorting, z_occ)
        except Exception as e:  # noqa: BLE001 - the other ranks wait in this step's collectives
            failure = e
        pd, overflow, sent = migrate(pd, dom, band, cap)
        pd["_migof"] = pd["_migof"] + overflow
        dom.stats["steps"] += 1
        dom.stats["sent"] += sent
        it += 1
        if sorting and it % RESORT_EVERY == 0:
            pd = _sort_soa(fsview, sort_field, pd, z_occ)[0]
    if failure is not None:
        raise failure
    if flags[2]:
        raise RuntimeError("another rank raised in this chunk's steps; see its error")
    return pd


def build_domain_executor(kernel_fns, dom: YBandDomain, *, sign_dt: int, rk45_mode: bool,
                          z_occ=None):
    """The per-rank chunk executor of a Y-band decomposition:
    ``(farrays, pdata, endtime, dt0) -> pdata``, as the single-card
    ``run_chunk``. The migration transport is chosen here (a changed
    partition needs a new executor)."""
    kernel_fns = tuple(kernel_fns)
    if dom.n > 1 and dom.migration_mode == "all2all":
        migrate = _migrate_all2all
    elif dom.curvilinear:
        migrate = _migrate_curvilinear
    else:
        migrate = _migrate_neighbor

    def chunk(farrays, pdata, endtime, dt0):
        return lockstep_chunk(dom, migrate, kernel_fns, farrays, pdata, endtime, dt0,
                              sign_dt=sign_dt, rk45_mode=rk45_mode, z_occ=z_occ)

    return chunk
