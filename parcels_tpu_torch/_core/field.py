"""Field / VectorField: host containers + device sampling views (torch).

Port of the JAX package's ``_core/field.py``. Host side (``Field``,
``VectorField``) wraps the ingested numpy data, (T, Z, Y, X) on structured
grids and (T, Z, N) on unstructured ones, and its grid;
device side (``FieldView``, ``VectorFieldView``) pairs the static spec with
the field tensors. Sampling semantics mirror the reference: search -> ei
cache -> state escalation -> interpolate -> NaN state -> zero out-of-bounds
samples.
"""

from __future__ import annotations

import numpy as np
import torch

from parcels_tpu_torch._core import index_search
from parcels_tpu_torch._core.basegrid import BaseGrid
from parcels_tpu_torch._core.grid import grid_search
from parcels_tpu_torch._core.particles_view import Particles
from parcels_tpu_torch._core.statuscodes import StatusCode

__all__ = ["Field", "FieldView", "GridView", "VectorField", "VectorFieldView"]


class Field:
    """Host-side scalar field: name + dense numpy data + grid + interpolator.

    Data layout is (T, Z, Y, X) on structured grids and (T, Z, N) on
    unstructured grids (N = n_face or n_node). ``data`` may be a lazy
    store handle (``io.LazyZarrArray``), read only a window at a time.
    """

    def __init__(self, name: str, data: np.ndarray, grid: BaseGrid, interp_method=None):
        if not name.isidentifier():
            raise ValueError(f"Field name must be a valid identifier, got {name!r}")
        if not getattr(data, "_parcels_lazy", False):
            data = np.asarray(data)
        if data.ndim not in (3, 4):
            raise ValueError(
                f"Field data must be (T, Z, Y, X) or unstructured (T, Z, N); got shape {data.shape}"
            )
        self.name = name
        self.data = data
        self.grid = grid
        self.interp_method = interp_method
        self.igrid = -1  # assigned by FieldSet
        self._fieldset = None
        self._registered_name = name

    @property
    def time_interval(self):
        if self.data.shape[0] <= 1:
            return None
        return self.grid.time_interval

    def eval(self, t, z, y, x, particles=None):
        """Host-side sampling through the owning FieldSet (reference field.py:145)."""
        if self._fieldset is None:
            raise ValueError(f"Field {self.name!r} is not part of a FieldSet")
        return self._fieldset.eval(self._registered_name, t, z, y, x)

    def __getitem__(self, key):
        if hasattr(key, "x") and hasattr(key, "t"):
            return self.eval(key.t, key.z, key.y, key.x, key)
        return self.eval(*key)

    def __repr__(self):
        return f"Field(name={self.name!r}, shape={self.data.shape})"

    def _repr_sections(self):
        interp = type(self.interp_method).__name__ if self.interp_method else "-"
        return [
            (
                "attributes",
                [
                    f"name: {self.name!r}",
                    f"shape: {tuple(self.data.shape)}  dtype: {self.data.dtype}",
                    f"interp_method: {interp}",
                    f"grid: {self.grid!r}",
                ],
            )
        ]

    def describe(self, buf=None) -> None:
        from parcels_tpu_torch._repr import write_sections

        write_sections(f"Field {self.name!r}", self._repr_sections(), buf)

    def _repr_html_(self):
        from parcels_tpu_torch._repr import html_sections

        return html_sections(f"Field {self.name!r}", self._repr_sections())


class VectorField:
    """Host-side vector field referencing 2-3 component Fields."""

    def __init__(self, name: str, U: Field, V: Field, W: Field | None = None, interp_method=None):
        if interp_method is None:
            raise ValueError("interp_method must be provided for VectorField initialization.")
        self.name = name
        self.U = U
        self.V = V
        self.W = W
        self.grid = U.grid
        self.interp_method = interp_method
        self.vector_type = "3D" if W is not None else "2D"
        self._fieldset = None
        self._registered_name = name

    def eval(self, t, z, y, x, particles=None):
        if self._fieldset is None:
            raise ValueError(f"VectorField {self.name!r} is not part of a FieldSet")
        return self._fieldset.eval(self._registered_name, t, z, y, x)

    def __getitem__(self, key):
        if hasattr(key, "x") and hasattr(key, "t"):
            return self.eval(key.t, key.z, key.y, key.x, key)
        return self.eval(*key)

    @property
    def igrid(self):
        return self.U.igrid

    @property
    def time_interval(self):
        return self.U.time_interval

    def __repr__(self):
        return f"VectorField(name={self.name!r}, {self.vector_type})"

    def _repr_sections(self):
        comps = [repr(c) for c in (self.U, self.V, self.W) if c is not None]
        interp = type(self.interp_method).__name__ if self.interp_method else "-"
        return [
            ("attributes", [f"name: {self.name!r}", f"vector_type: {self.vector_type}",
                            f"interp_method: {interp}"]),
            ("components", comps),
        ]

    def describe(self, buf=None) -> None:
        from parcels_tpu_torch._repr import write_sections

        write_sections(f"VectorField {self.name!r}", self._repr_sections(), buf)

    def _repr_html_(self):
        from parcels_tpu_torch._repr import html_sections

        return html_sections(f"VectorField {self.name!r}", self._repr_sections())


# ---------------------------------------------------------------------------
# device views
# ---------------------------------------------------------------------------


class GridView:
    __slots__ = ("spec", "garrs", "lookup_meta")

    def __init__(self, spec, garrs, lookup_meta=None):
        self.spec = spec
        self.garrs = garrs
        self.lookup_meta = lookup_meta

    def search(self, z, y, x, ei=None):
        return grid_search(self.spec, self.garrs, z, y, x, ei, self.lookup_meta)


class FieldView:
    __slots__ = ("name", "data", "grid", "igrid", "interp_method", "has_time", "_tables")

    def __init__(self, name, data, grid: GridView, igrid, interp_method, has_time, tables=None):
        self.name = name
        self.data = data
        self.grid = grid
        self.igrid = igrid
        self.interp_method = interp_method
        self.has_time = has_time
        # derived tables of the data (ops/uxcol.py), shared by every view of
        # one fieldset's device arrays
        self._tables = {} if tables is None else tables

    def eval(self, t, z, y, x, particles: Particles | None = None):
        ppos, gpos = _get_positions(self, t, z, y, x, particles)
        value = self.interp_method.interp(ppos, gpos, self)
        if particles is not None:
            _escalate(particles, torch.isnan(value), StatusCode.ErrorInterpolation)
        return _mask_oob_values(gpos, value)

    def __getitem__(self, key):
        if isinstance(key, Particles):
            return self.eval(key.t, key.z, key.y, key.x, key)
        return self.eval(*key)


class VectorFieldView:
    __slots__ = (
        "name", "U", "V", "W", "grid", "igrid", "interp_method", "vector_type",
        "_stage_cache", "_sc_owner", "_cell_table", "_tables",
    )

    def __init__(self, name, U, V, W, interp_method, sc_owner=False, tables=None):
        self.name = name
        self.U = U
        self.V = V
        self.W = W
        self.grid = U.grid
        self.igrid = U.igrid
        self.interp_method = interp_method
        self.vector_type = "3D" if W is not None else "2D"
        # per-kernel-invocation cell cache (ops/stagecache.py); the engine
        # resets it before every kernel call
        self._stage_cache = None
        # does this view own the persistent SoA cache columns
        # (stagecache.soa_cache_owner)?
        self._sc_owner = bool(sc_owner)
        # fused per-cell [pic | geometry] row table (stagecache.cell_table)
        self._cell_table = None
        # fused [U | V] z-row table (uxcol.ux_colT_uv_table), shared as FieldView._tables
        self._tables = {} if tables is None else tables

    def eval(self, t, z, y, x, particles: Particles | None = None):
        from parcels_tpu_torch.ops import stagecache, uxcache

        if stagecache.enabled(self):
            return stagecache.cgrid_cached_eval(self, t, z, y, x, particles)
        if uxcache.enabled(self):
            return uxcache.ux_cached_eval(self, t, z, y, x, particles)
        ppos, gpos = _get_positions(self.U, t, z, y, x, particles)
        u, v, w = self.interp_method.interp(ppos, gpos, self)
        if particles is not None:
            # one combined NaN check -> one masked state write
            bad = torch.isnan(u) | torch.isnan(v)
            if w is not None and w.dim() > 0:
                bad = bad | torch.isnan(w)
            _escalate(particles, bad, StatusCode.ErrorInterpolation)
        u = _mask_oob_values(gpos, u)
        v = _mask_oob_values(gpos, v)
        w = _mask_oob_values(gpos, w)
        if self.vector_type == "3D":
            return (u, v, w)
        return (u, v)

    def __getitem__(self, key):
        if isinstance(key, Particles):
            return self.eval(key.t, key.z, key.y, key.x, key)
        return self.eval(*key)


# ---------------------------------------------------------------------------
# sampling plumbing
# ---------------------------------------------------------------------------


def _get_positions(field: FieldView, t, z, y, x, particles: Particles | None):
    """Search time + grid, cache ei, escalate particle states (reference field.py:394-403)."""
    spec = field.grid.spec
    garrs = field.grid.garrs
    if field.has_time:
        ti, tau, t_oob = index_search.search_time(garrs["time"], t, spec.time_uniform)
    else:
        ti = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
        tau = torch.zeros_like(t)
        t_oob = None

    # the cached element index warm-starts the curvilinear search
    ei = particles._get_ei(field.igrid) if particles is not None else None
    gpos = field.grid.search(z, y, x, ei=ei)
    gpos["T"] = {"index": ti, "bcoord": tau}
    # the engine keeps the SoA sorted -> the binned slab sampler applies
    gpos["_sorted"] = bool(particles is not None and particles._sorted_hint)
    # quantized occupied-z fraction (binned-sampler planning)
    gpos["_z_occ"] = particles._z_occ_hint if particles is not None else None
    if particles is not None:
        # lane activity: the binned sampler skips all-inactive chunks and
        # drops dead lanes from its overflow budget
        gpos["active"] = particles._data["_active"]
        _update_particles_ei(particles, gpos, field)
        _update_state_position(particles, gpos, t_oob)

    ppos = {"t": t, "z": z, "y": y, "x": x}
    return ppos, gpos


def _update_particles_ei(particles: Particles, gpos, field: FieldView):
    spec = field.grid.spec
    if "FACE" in gpos:
        # unstructured: ei caches the face index (z is re-bracketed per eval)
        particles._set_ei(field.igrid, torch.clamp(gpos["FACE"]["index"], 0, spec.n_face - 1))
        return
    if _ei_cache_pointless(spec, field):
        return
    ydim = max(spec.ydim, 1)
    xdim = max(spec.xdim, 1)
    zi = torch.clamp(gpos["Z"]["index"], 0, max(spec.zdim - 1, 0))
    yi = torch.clamp(gpos["Y"]["index"], 0, max(spec.ydim - 1, 0))
    xi = torch.clamp(gpos["X"]["index"], 0, max(spec.xdim - 1, 0))
    particles._set_ei(field.igrid, (zi * ydim + yi) * xdim + xi)


def _ei_cache_pointless(spec, field: FieldView) -> bool:
    """The ei cache (warm start and sort key) buys nothing when every axis
    is uniform (O(1) search) and the field takes K1 (never binned)."""
    from parcels_tpu_torch.ops.interp_kernels import fits_fast_path

    return (
        not spec.curvilinear
        and spec.lon_uniform is not None
        and spec.lat_uniform is not None
        and (spec.zdim <= 1 or spec.depth_uniform is not None)
        and fits_fast_path(tuple(field.data.shape))
    )


def _escalate(particles: Particles, cond, code):
    """Max-merge a status code into particle states where ``cond`` holds."""
    particles.state = torch.maximum(
        particles.state, torch.where(cond, int(code), 0).to(torch.int32)
    )


def _update_state_position(particles: Particles, gpos, t_oob):
    """State escalation from search sentinels, merged into one masked
    state write (reference field.py:327-357)."""
    esc = torch.zeros_like(particles.state)

    def mark(cond, code):
        nonlocal esc
        esc = torch.maximum(esc, torch.where(cond, int(code), 0).to(torch.int32))

    for dim in ("X", "Y", "FACE"):
        if dim not in gpos:
            continue
        idx = gpos[dim]["index"]
        mark(idx == index_search.RIGHT_OUT_OF_BOUNDS, StatusCode.ErrorOutOfBounds)
        mark(idx == index_search.GRID_SEARCH_ERROR, StatusCode.ErrorGridSearching)
    zidx = gpos["Z"]["index"]
    mark(zidx == index_search.RIGHT_OUT_OF_BOUNDS, StatusCode.ErrorOutOfBounds)
    mark(zidx == index_search.LEFT_OUT_OF_BOUNDS, StatusCode.ErrorThroughSurface)
    if t_oob is not None:
        mark(t_oob, StatusCode.ErrorOutsideTimeInterval)
    particles.state = torch.maximum(particles.state, esc)


def _mask_oob_values(gpos, value):
    """Out-of-bounds samples are returned as 0 (reference field.py:359-370)."""
    if value is None:
        return None
    mask = torch.zeros(value.shape, dtype=torch.bool, device=value.device)
    for dim in ("X", "Y", "Z", "FACE"):
        if dim in gpos:
            mask = mask | (gpos[dim]["index"] < 0)
    return torch.where(mask, torch.zeros((), dtype=value.dtype, device=value.device), value)
