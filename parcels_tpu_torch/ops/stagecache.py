"""C-grid RK-stage cell cache: reuse search + face reads across stages (torch).

Port of the JAX package's ``ops/stagecache.py``. RK stages revisit the same
cell: with dt under the advective CFL the 2nd-4th stage positions (and
usually the next step's 1st) lie in the 1st stage's cell, at the same time
bracket and depth level. So everything those stages read is already known:

- the cell's tangent-frame pic row        -> in-cell check + (xsi, eta)
- the cell's C-grid geometry row          -> edge lengths + Jacobian
- the 4 U/V face values x 2 time levels   -> re-blend with fresh weights
- the W column's 2 z-levels x 2 times     -> re-blend with fresh zeta

and a cache-hit stage is elementwise arithmetic with no gather. The cache
lives on the VectorFieldView for ONE kernel invocation (the engine resets it
around every kernel call); its final entries persist across steps in the
particle SoA (``_sc_*`` columns, owner field only).

Misses (lanes that crossed a cell edge or a time/depth bracket mid-step) are
repaired in compacted rounds of K lanes through the full search + gather
path (``ops/cgrid_repair.py``: on the card one K5 call a stage checks every
lane, compacts the misses, repairs every round and gives every lane's
(xsi, eta), with no host read). Out-of-bounds samples return 0 and escalate
states as ``field.py`` does: the cache is semantically invisible.

Not ported, by design: the JAX package's corner-column tables
(``_col_quad``, ``ops/colgather.py``). They are a TPU row-gather layout, and
their one-hot reduce returns exactly the gathered value, so ``_flat_quad``
is the quad here.
"""

from __future__ import annotations

import os

import torch

from parcels_tpu_torch import profiling
from parcels_tpu_torch._core import index_search

__all__ = ["cgrid_cached_eval", "enabled", "flush", "prebuild_tables", "reset", "table_bytes"]

#: miss repair round capacity, as n/K_DIV lanes (floor 1024), as in the JAX
#: package; ceil(misses/K) rounds run per stage
K_DIV = 1024


def _mode() -> str:
    return os.environ.get("PARCELS_TPU_STAGECACHE", "auto")


def enabled(vf) -> bool:
    """Gate: C-grid velocity on a curvilinear grid with its tables.

    ``PARCELS_TPU_STAGECACHE`` (set by ``EngineOptions(stagecache=...)``)
    is ``auto``, ``force`` or ``off``. ``auto`` follows the JAX package's
    gate, which is on for every backend but the CPU: here, on when the
    field tensors are on CUDA.
    """
    from parcels_tpu_torch.interpolators.xinterp import CGrid_Velocity

    mode = _mode()
    if mode in ("0", "off"):
        return False
    if not isinstance(vf.interp_method, CGrid_Velocity):
        return False
    spec = vf.grid.spec
    garrs = vf.grid.garrs
    if not (spec.curvilinear and "pic_table" in garrs and "cgrid_geom" in garrs):
        return False
    return mode == "force" or vf.U.data.device.type == "cuda"


def reset(fsview) -> None:
    """Drop the stage caches of every vector-field view (engine: around each
    kernel call; the cache must never cross a kernel-call boundary)."""
    for v in fsview.fields.values():
        if hasattr(v, "_stage_cache"):
            v._stage_cache = None


#: fused-row layout: cols 0-15 pic row (index_search.PIC_TABLE_COLS), cols
#: 16-24 the C-grid geometry row (grid.cgrid_geometry), then zero padding
GEOM_OFF = 16
ROW_COLS = GEOM_OFF + 9
CELL_TABLE_WIDTH = 64


def _fused_table(garrs):
    pic = garrs["pic_table"].reshape(-1, index_search.PIC_TABLE_COLS)
    geom = garrs["cgrid_geom"]
    pad = torch.zeros((pic.shape[0], CELL_TABLE_WIDTH - ROW_COLS), dtype=pic.dtype,
                      device=pic.device)
    return torch.cat([pic, geom, pad], dim=1)


def cell_table(vf):
    """Fused per-cell row table (cells, 64) f32: [pic (16) | geometry (9) | 0].

    One row read per lane replaces the pic and geometry table pair; built
    once per farrays (``attach_derived_tables``) or lazily per view.
    """
    if vf._cell_table is None:
        vf._cell_table = _fused_table(vf.grid.garrs)
    return vf._cell_table


def _cached_vector_fields(fieldset):
    from parcels_tpu_torch._core.field import VectorField
    from parcels_tpu_torch.interpolators.xinterp import CGrid_Velocity

    for name, f in fieldset.fields.items():
        if (isinstance(f, VectorField) and isinstance(f.interp_method, CGrid_Velocity)
                and f.grid.spec.curvilinear):
            yield name, f


def attach_derived_tables(fieldset, farrays) -> None:
    """Build the fused cell tables once per ``farrays`` under
    ``farrays["celltables"][igrid]``; ``FieldSet.build_views`` pre-seeds the
    views from them. Fieldsets on the CPU skip, as the JAX package's CPU
    backend does (the views then build their tables lazily)."""
    if fieldset.device.type == "cpu" or _mode() in ("0", "off"):
        return
    cellt = farrays.setdefault("celltables", {})
    for _, f in _cached_vector_fields(fieldset):
        garrs = farrays["grids"][f.igrid]
        if f.igrid not in cellt and "pic_table" in garrs and "cgrid_geom" in garrs:
            cellt[f.igrid] = _fused_table(garrs)


def prebuild_tables(fsview) -> None:
    """Materialize the fused cell tables, and the UGRID corner-column tables
    of the tier in use, before the step loop (engine: right after
    build_views). On the card the stage's two libraries (K5's and the
    prologue's and epilogue's) build here, in parallel, where one is
    missing."""
    from parcels_tpu_torch.ops import _build, uxcache, uxcol

    for v in fsview.fields.values():
        is_vector = hasattr(v, "_stage_cache")
        for comp in (v.U, v.V, v.W) if is_vector else (v,):
            if (comp is None or comp.data.dim() != 3 or "face_table" not in comp.grid.garrs
                    or not uxcol.col_usable(comp.data.shape)):
                continue
            if is_vector and uxcache.enabled(v):
                uxcol.ux_colT_uv_table(v)
                if v.W is not None:
                    uxcol.ux_colT_table(v.W)
            else:
                uxcol.ux_col_table(comp)
        if is_vector and enabled(v):
            cell_table(v)
            if v.U.data.device.type == "cuda":
                _build.build_all(["cgrid_repair", "cgrid_stage"])


def table_bytes(fieldset) -> dict:
    """Bytes of the tables that ``attach_derived_tables`` and
    ``prebuild_tables`` add to a fieldset's tensors, reckoned from shapes
    without building them (``FieldSet.memory_report``):
    ``{"cell_table": {igrid: B}, "ux_tables": {field name: B}}``.

    A curvilinear C-grid gets its fused (cells, 64) f32 row table where the
    stage cache runs (``auto`` on CUDA, or ``force``). A UGRID grid whose
    fused face-row tier is on gets, for each (T, Z, N) field within
    ``uxcol.MAX_COLS``, its (N, max(T*Z, 64)) column table, and a vector
    field under the per-face cache its (N*T, 2*max(Z, 64)) [U | V] z-row
    table plus W's (N*T, max(Z, 64)).
    """
    from parcels_tpu_torch._core.field import Field, VectorField
    from parcels_tpu_torch.ops import uxcache, uxcol

    dev = fieldset.device
    cell = {}
    mode = _mode()
    if mode not in ("0", "off") and (mode == "force" or dev.type == "cuda"):
        for _, f in _cached_vector_fields(fieldset):
            g = f.grid
            if g._needs_cgrid_geom and "X" in g.axes and "Y" in g.axes:
                cells = max(g.spec.ydim, 1) * max(g.spec.xdim, 1)
                cell[f.igrid] = cells * CELL_TABLE_WIDTH * 4
    ux = {}
    uxc_mode = uxcache._mode()
    for name, f in fieldset.fields.items():
        n_face = getattr(f.grid.spec, "n_face", 0)
        if n_face <= 0 or not uxcol.enabled(n_face, dev):
            continue
        if isinstance(f, Field):
            T, Z, N = fieldset._device_shape(f)
            if uxcol.col_usable((T, Z, N)):
                ux[name] = N * max(T * Z, uxcol.ROW_WIDTH) * 4
        elif (isinstance(f, VectorField) and uxc_mode not in ("0", "off")
              and (uxc_mode == "force" or dev.type == "cuda") and uxcache._vf_meta(f) is not None):
            comps = [c for c in (f.U, f.V, f.W) if c is not None]
            if any(uxcol.col_usable(fieldset._device_shape(c)) for c in comps):
                T, Z, N = fieldset._device_shape(f.U)
                ux[name] = N * T * 2 * max(Z, uxcol.ROW_WIDTH) * 4
                if f.W is not None:
                    T, Z, N = fieldset._device_shape(f.W)
                    ux[name] += N * T * max(Z, uxcol.ROW_WIDTH) * 4
    return {"cell_table": cell, "ux_tables": ux}


# ---------------------------------------------------------------------------
# cross-step persistence: the cache lives on in the particle SoA
# ---------------------------------------------------------------------------
#
# Stage 1 of a step starts from the previous step's entries, so full passes
# happen only for the lanes that crossed a cell. The ParticleSet injects the
# columns before a run when the fieldset qualifies; the engine flushes the
# final kernel-call cache back after each kernel. Only the key and the face
# quads persist; the pic/geometry rows are re-read by the cached cell.

SC_KEY = "_sc_key"  # (n, 4) i32: [cell | -1, ti, zi, wzi]
SC_ARRAYS = {"_sc_u4": 4, "_sc_v4": 4}
SC_W = "_sc_w4"  # (n, 4) f32, only for 3-D (UVW) fieldsets


def soa_cache_owner(fieldset):
    """The single vector field that owns the persistent cache columns.

    A second C-grid vector field reading them would blend the wrong face
    values, so exactly one owner loads and flushes them: the first 3-D
    curvilinear C-grid vector field, else the first 2-D one. Returns
    (registered_name | None, has_w). ``PARCELS_TPU_STAGECACHE_PERSIST=0``
    (``EngineOptions(stagecache_persist=False)``) turns persistence off.
    """
    mode = _mode()
    if mode in ("0", "off"):
        return None, False
    if os.environ.get("PARCELS_TPU_STAGECACHE_PERSIST", "1") in ("0", "off"):
        return None, False
    if mode != "force" and fieldset.device.type != "cuda":
        return None, False
    owner = None
    for name, f in _cached_vector_fields(fieldset):
        if f.W is not None:
            return name, True
        owner = owner or name
    return owner, False


def soa_cache_applicable(fieldset):
    """(applicable, has_w) for the designated owner (see soa_cache_owner)."""
    owner, has_w = soa_cache_owner(fieldset)
    return owner is not None, has_w


def make_soa_cache(n: int, has_w: bool, device) -> dict:
    """Fresh (invalid) cache columns for ``n`` lanes on ``device``."""
    out = {SC_KEY: torch.full((n, 4), -1, dtype=torch.int32, device=device)}
    for k, w in SC_ARRAYS.items():
        out[k] = torch.zeros((n, w), dtype=torch.float32, device=device)
    if has_w:
        out[SC_W] = torch.zeros((n, 4), dtype=torch.float32, device=device)
    return out


def invalidate_soa_cache(dev: dict) -> dict:
    """Mark every lane's persistent cache invalid, the UGRID cache's too."""
    from parcels_tpu_torch.ops import uxcache

    if SC_KEY in dev:
        dev = dict(dev)
        key = dev[SC_KEY].clone()
        key[:, 0] = -1
        dev[SC_KEY] = key
    return uxcache.invalidate_soa_cache(dev)


def _rows(vf, cell):
    """The fused rows (n, 25) of cells ``cell`` (clamped to the table)."""
    tbl = cell_table(vf)
    return tbl[:, :ROW_COLS][cell.long().clamp(0, tbl.shape[0] - 1)]


def _load_soa_cache(particles, vf):
    """The cache of a kernel call's first stage, from the SoA columns. Its
    columns are copies, contiguous and the kernel call's own: the miss
    repair writes them in place, and the SoA is never updated in place
    (particles_view)."""
    pd = particles._data
    key = pd[SC_KEY]
    cell = torch.clamp_min(key[:, 0], 0)
    cx = max(vf.grid.spec.xdim, 1)

    def own(t):
        return t.clone(memory_format=torch.contiguous_format)

    return {
        "cell": own(key[:, 0]),
        "ti": own(key[:, 1]),
        "zi": own(key[:, 2]),
        "wzi": own(key[:, 3]),
        "yi": torch.div(cell, cx, rounding_mode="floor").to(torch.int32),
        "xi": (cell % cx).to(torch.int32),
        "row": _rows(vf, cell),
        "u4": own(pd["_sc_u4"]),
        "v4": own(pd["_sc_v4"]),
        "w4": own(pd[SC_W]) if vf.W is not None and SC_W in pd else None,
        "esc": torch.zeros_like(key[:, 0]),
        "oob": torch.zeros_like(key[:, 0], dtype=torch.bool),
    }


def flush(fsview, pd) -> None:
    """Write the owner view's final kernel-call cache back into the SoA
    (engine: after every kernel call). Entries of lanes that were not
    evaluated were loaded unchanged from the SoA."""
    from parcels_tpu_torch.ops import uxcache

    if SC_KEY not in pd and uxcache.UXC_KEY not in pd:
        return
    for v in fsview.fields.values():
        c = getattr(v, "_stage_cache", None)
        if c is None or not v._sc_owner:
            continue
        if "face" in c:  # the UGRID per-face cache (ops/uxcache.py)
            if uxcache.UXC_KEY in pd:
                uxcache.flush_one(c, pd)
            continue
        if SC_KEY not in pd:
            continue
        with profiling.span("parcels.cgrid.flush"):
            pd[SC_KEY] = torch.stack([c["cell"], c["ti"], c["zi"], c["wzi"]],
                                     dim=1).to(torch.int32)
            pd["_sc_u4"] = c["u4"]
            pd["_sc_v4"] = c["v4"]
            if c["w4"] is not None and SC_W in pd:
                pd[SC_W] = c["w4"]


# ---------------------------------------------------------------------------
# face-value quads
# ---------------------------------------------------------------------------


def _flat_quad(field, ti, t1i, zcol, y0, x0, y1, x1):
    """[(i0,t0), (i0,t1), (i1,t0), (i1,t1)] values at depth ``zcol`` via 4 gathers."""
    from parcels_tpu_torch.interpolators.xinterp import _flat_gather

    d = field.data
    return torch.stack([
        _flat_gather(d, ti, zcol, y0, x0),
        _flat_gather(d, t1i, zcol, y0, x0),
        _flat_gather(d, ti, zcol, y1, x1),
        _flat_gather(d, t1i, zcol, y1, x1),
    ], dim=1)


def _w_quad(field, ti, t1i, wzi, yi_o, xi_o):
    """W quad: [(z, t0), (z, t1), (z+1, t0), (z+1, t1)] at one column (the
    JAX package's ``_col_or_flat_w`` without its column-table branch)."""
    from parcels_tpu_torch.interpolators.xinterp import _flat_gather

    d = field.data
    z1 = torch.clamp(wzi + 1, 0, d.shape[1] - 1)
    return torch.stack([
        _flat_gather(d, ti, wzi, yi_o, xi_o),
        _flat_gather(d, t1i, wzi, yi_o, xi_o),
        _flat_gather(d, ti, z1, yi_o, xi_o),
        _flat_gather(d, t1i, z1, yi_o, xi_o),
    ], dim=1)


# ---------------------------------------------------------------------------
# the blended C-grid velocity from cache columns (the operands of
# interpolators/xinterp.CGrid_Velocity's geometry-table path)
# ---------------------------------------------------------------------------


def _blend(spec, row, xsi, eta, tau, zeta, u4, v4, w4, Zw, y_deg):
    """C-grid blend from the fused cell row (geometry at cols GEOM_OFF+)."""
    from parcels_tpu_torch.interpolators.xinterp import (
        cgrid_edge_lengths,
        cgrid_velocity_from_fluxes,
    )

    geo = [row[:, GEOM_OFF + k] for k in range(9)]
    c1, c2, c3, c4 = cgrid_edge_lengths(spec, *geo, xsi, eta)
    u_w = u4[:, 0] * (1.0 - tau) + u4[:, 1] * tau
    u_e = u4[:, 2] * (1.0 - tau) + u4[:, 3] * tau
    v_s = v4[:, 0] * (1.0 - tau) + v4[:, 1] * tau
    v_n = v4[:, 2] * (1.0 - tau) + v4[:, 3] * tau
    Uvel = (1.0 - xsi) * c4 * u_w + xsi * c2 * u_e
    Vvel = (1.0 - eta) * c1 * v_s + eta * c3 * v_n
    u, v = cgrid_velocity_from_fluxes(spec, Uvel, Vvel, *geo[:8], xsi, eta, y_deg)

    if w4 is not None:
        zb = torch.clamp(zeta, 0.0, 1.0) if Zw > 1 else torch.zeros_like(zeta)
        w_lo = w4[:, 0] * (1.0 - tau) + w4[:, 1] * tau
        w_hi = w4[:, 2] * (1.0 - tau) + w4[:, 3] * tau
        w = w_lo * (1.0 - zb) + w_hi * zb
    else:
        w = torch.zeros_like(u)
    return u, v, w


# ---------------------------------------------------------------------------
# the cached eval
# ---------------------------------------------------------------------------


def stage_brackets(vf, t, z):
    """The time and depth brackets of a stage's lanes, as the cache keys
    them: (ti, t1i, tau, t_oob, zi_raw, zc, zeta, wzi, Zw)."""
    spec = vf.grid.spec
    garrs = vf.grid.garrs
    i32 = dict(dtype=torch.int32, device=z.device)
    if vf.U.has_time:
        ti, tau, t_oob = index_search.search_time(garrs["time"], t, spec.time_uniform)
    else:
        ti = torch.zeros(z.shape, **i32)
        tau = torch.zeros_like(z)
        t_oob = None
    T = vf.U.data.shape[0]
    t1i = torch.clamp(ti + 1, 0, T - 1)

    if "Z" in spec.axes:
        zi_raw, zeta = index_search.search_1d(garrs["depth"], z, spec.depth_uniform)
    else:
        zi_raw = torch.zeros(z.shape, **i32)
        zeta = torch.zeros_like(z)
    Z = vf.U.data.shape[1]
    zc = torch.clamp(zi_raw, 0, Z - 1)
    if vf.W is not None:
        Zw = vf.W.data.shape[1]
        wzi = torch.clamp(zi_raw + spec.offset_z, 0, max(Zw - 2, 0))
    else:
        Zw = 1
        wzi = torch.zeros_like(zc)
    return ti, t1i, tau, t_oob, zi_raw, zc, zeta, wzi, Zw


def cgrid_cached_eval(vf, t, z, y, x, particles):
    """Drop-in replacement for VectorFieldView.eval on curvilinear C-grids.

    The JAX package runs a stage as XLA ops on its device: the hit check,
    a ``while_loop`` over rounds of K compacted misses whose search holds
    the curvilinear walk's early-exit ``while_loop``, and (xsi, eta) from
    the cached rows. Here a stage is three calls, each on every lane: the
    prologue (``cgrid_stage.stage_prologue``: the time and depth brackets,
    their escalation codes, the query coordinates), K5
    (``cgrid_repair.cgrid_stage``, or one ``cgrid_full`` for a kernel
    call's first eval: the hit check, the repair of every round and every
    lane's (xsi, eta)) and the epilogue (``cgrid_stage.stage_epilogue``:
    the C-grid blend, the state's escalations, the ``ei`` refresh, the
    zeroed out-of-bounds samples). On the card each is a hand-written
    kernel and nothing is read back to the host; on the CPU their plain
    versions run.
    """
    from parcels_tpu_torch.ops import cgrid_repair, cgrid_stage

    with profiling.span("parcels.cgrid.stage"):
        spec = vf.grid.spec
        b = cgrid_stage.stage_prologue(vf, t, z, y, x)

        c = vf._stage_cache
        n = y.shape[0]
        if c is None and particles is not None and SC_KEY in particles._data and vf._sc_owner:
            # cross-step persistence: stage 1 starts from the last step's cache
            c = _load_soa_cache(particles, vf)

        if c is None:
            # first eval of this kernel invocation: full batch
            cgrid_cached_eval.full_evals += 1
            cy, cx = max(spec.ydim, 1), max(spec.xdim, 1)
            if particles is not None:
                ei = particles._get_ei(vf.igrid)
                xi_g = ei % cx
                yi_g = torch.div(ei, cx, rounding_mode="floor") % cy
            else:
                yi_g = torch.zeros(y.shape, dtype=torch.int32, device=y.device)
                xi_g = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
            # K5 on the card (its plain version on the CPU): one call, every lane
            c = cgrid_repair.cgrid_full(vf, y, x, b.q, b.ti, b.t1i, b.zc, b.wzi, yi_g, xi_g)
            xsi, eta = c.pop("xsi"), c.pop("eta")
            c["ti"] = b.ti
            c["zi"] = b.zc
            c["wzi"] = b.wzi
            if particles is not None:
                # only engine-driven evals cache (a host-side fieldset.eval has
                # no kernel-call boundary to reset it)
                vf._stage_cache = c
        else:
            K = min(n, max(1024, n // K_DIV))
            c = dict(c)
            # the JAX package checks the cache and runs the repair rounds in a
            # while_loop over ceil(cnt/K); on the card one K5 call checks, plans
            # and repairs every round and the counts stay device tensors, on the
            # CPU the plain loop reads the misses once
            mask = particles._mask if particles is not None else None
            st = cgrid_repair.cgrid_stage(vf, c, y, x, b.q, b.ti, b.t1i, b.zc, b.wzi, mask, K)
            xsi, eta = st.xsi, st.eta
            cgrid_cached_eval.checked_lanes += n
            cgrid_cached_eval.misses = cgrid_cached_eval.misses + st.cnt
            cgrid_cached_eval.miss_rounds = cgrid_cached_eval.miss_rounds + st.rounds
            vf._stage_cache = c

        return cgrid_stage.stage_epilogue(vf, c, xsi, eta, b, y, particles)


#: counters, read by chip_smoke.py: full-batch evals, miss repair rounds,
#: lanes checked against a cache and lanes that missed. Integers, except
#: ``miss_rounds`` and ``misses`` after a repair on the card, which are 0-d
#: device tensors (read them with ``int()``): counting there reads nothing back
cgrid_cached_eval.full_evals = 0
cgrid_cached_eval.miss_rounds = 0
cgrid_cached_eval.checked_lanes = 0
cgrid_cached_eval.misses = 0
