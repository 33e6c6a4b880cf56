"""Per-face persistent stage cache for unstructured (UGRID) velocity fields (torch).

Port of the JAX package's ``ops/uxcache.py``, the UGRID twin of
``ops/stagecache.py``. Without it, every RK stage re-runs the warm
barycentric check, the walk and the corner reads. With it:

- the particle SoA persists, per lane, the face id, the (ti, zi) bracket
  key, and the 4 corner data values [(z_lo, t0), (z_lo, t1), (z_hi, t0),
  (z_hi, t1)] per lateral tap (3 nodes barycentric, 1 face constant) per
  velocity component;
- a stage whose lane is still inside the cached face (a barycentric check
  against the cached triangle) with the same (ti, zi) bracket blends the
  cached corners with fresh (tau, zeta, bc) weights, with no gather;
- the lanes that miss are compacted (one device-to-host read) and repaired
  in one batch: a walk warm-started from the stale face, then the corner
  reads. The JAX package repairs at most one compacted round of
  ``n / 32`` lanes or rebuilds the whole batch; each lane's repair reads
  only that lane, so the values are the same.

The corners are read as single elements of the per-(node, time) z-row
tables (``ops/uxcol.ux_colT_uv_table``): the JAX package's one-hot reduce
over such a row returns exactly the element it selects.
"""

from __future__ import annotations

import os

import torch

from parcels_tpu_torch._core import index_search
from parcels_tpu_torch._core.statuscodes import StatusCode

__all__ = [
    "UXC_KEY",
    "enabled",
    "flush_one",
    "invalidate_soa_cache",
    "make_soa_cache",
    "soa_cache_applicable",
    "soa_cache_owner",
    "ux_cached_eval",
]

UXC_KEY = "_uxc_key"  # (n, 4) i32: [face | -1, ti, zi, 0]
UXC_U = "_uxc_u"  # (n, 4*ntaps) f32 corner values, U component
UXC_V = "_uxc_v"  # (n, 4*ntaps) f32, V component
UXC_W = "_uxc_w"  # (n, 4*ntaps_w) f32, W component (3-D fieldsets)


def _mode() -> str:
    return os.environ.get("PARCELS_TPU_UXCACHE", "auto")


def _comp_meta(comp):
    """(supported, node, zf) of one scalar field's UGRID interpolator."""
    from parcels_tpu_torch.interpolators.uxinterp import (
        UxConstantFaceConstantZC,
        UxConstantFaceLinearZF,
        UxLinearNodeConstantZC,
        UxLinearNodeLinearZF,
    )

    m = comp.interp_method
    if isinstance(m, UxLinearNodeLinearZF):
        return True, True, True
    if isinstance(m, UxLinearNodeConstantZC):
        return True, True, False
    if isinstance(m, UxConstantFaceLinearZF):
        return True, False, True
    if isinstance(m, UxConstantFaceConstantZC):
        return True, False, False
    return False, False, False


def _vf_meta(vf):
    """Cache meta of a UGRID vector field or view, or None if unsupported:
    dict(node_u, zf_u, has_w, node_w, zf_w). U and V share one placement
    (``from_ugrid_conventions`` always does); W may differ."""
    from parcels_tpu_torch.interpolators.uxinterp import Ux_Velocity
    from parcels_tpu_torch.ops import uxcol

    if not isinstance(vf.interp_method, Ux_Velocity):
        return None
    ok_u, node_u, zf_u = _comp_meta(vf.U)
    ok_v, node_v, zf_v = _comp_meta(vf.V)
    if not (ok_u and ok_v) or (node_u, zf_u) != (node_v, zf_v):
        return None
    if not uxcol.col_usable(vf.U.data.shape):
        return None
    meta = {"node_u": node_u, "zf_u": zf_u, "has_w": vf.W is not None,
            "node_w": False, "zf_w": False}
    if vf.W is not None:
        ok_w, node_w, zf_w = _comp_meta(vf.W)
        if not ok_w or not uxcol.col_usable(vf.W.data.shape):
            return None
        meta["node_w"] = node_w
        meta["zf_w"] = zf_w
    return meta


def soa_cache_owner(fieldset):
    """(registered name | None, meta) of the UGRID vector field owning the
    persistent SoA columns: the first supported one. ``auto`` engages on
    CUDA fieldsets, ``force`` anywhere; ``EngineOptions(uxcache="off")``
    or ``stagecache_persist=False`` turns persistence off."""
    from parcels_tpu_torch._core.field import VectorField

    if _mode() in ("0", "off"):
        return None, None
    if os.environ.get("PARCELS_TPU_STAGECACHE_PERSIST", "1") in ("0", "off"):
        return None, None
    if _mode() != "force" and fieldset.device.type != "cuda":
        return None, None
    for name, f in fieldset.fields.items():
        if not isinstance(f, VectorField) or getattr(f.grid.spec, "n_face", 0) <= 0:
            continue
        meta = _vf_meta(f)
        if meta is not None:
            return name, meta
    return None, None


def soa_cache_applicable(fieldset):
    name, meta = soa_cache_owner(fieldset)
    return name is not None, meta


def _widths(meta):
    wu = 4 * (3 if meta["node_u"] else 1)
    ww = 4 * (3 if meta["node_w"] else 1) if meta["has_w"] else 0
    return wu, ww


def make_soa_cache(n: int, meta, device) -> dict:
    """Fresh (invalid) cache columns for ``n`` lanes on ``device``."""
    wu, ww = _widths(meta)
    f32 = dict(dtype=torch.float32, device=device)
    out = {
        UXC_KEY: torch.full((n, 4), -1, dtype=torch.int32, device=device),
        UXC_U: torch.zeros((n, wu), **f32),
        UXC_V: torch.zeros((n, wu), **f32),
    }
    if ww:
        out[UXC_W] = torch.zeros((n, ww), **f32)
    return out


def invalidate_soa_cache(dev: dict) -> dict:
    """Mark every lane's UGRID cache invalid."""
    if UXC_KEY not in dev:
        return dev
    dev = dict(dev)
    key = dev[UXC_KEY].clone()
    key[:, 0] = -1
    dev[UXC_KEY] = key
    return dev


def enabled(vf) -> bool:
    """Gate: is the cached eval used for this vector view? ``auto`` is on
    when the field tensors are on CUDA, as the JAX package's is on every
    backend but the CPU; it needs the grid's fused face table."""
    mode = _mode()
    if mode in ("0", "off"):
        return False
    if getattr(vf.grid.spec, "n_face", 0) <= 0 or "face_table" not in vf.grid.garrs:
        return False
    if _vf_meta(vf) is None:
        return False
    return mode == "force" or vf.U.data.device.type == "cuda"


# ---------------------------------------------------------------------------
# corner reads (repaired lanes only)
# ---------------------------------------------------------------------------


def _corners(tbl, T, N, taps_idx, ti, t1i, zlo, zhi, col0=0):
    """(k, 4*ntaps) corners [(zlo,t0), (zlo,t1), (zhi,t0), (zhi,t1)] per tap,
    flattened tap-major, from a per-(node, time) z-row table whose rows
    start at column ``col0``."""
    lo, hi = (zlo + col0).long(), (zhi + col0).long()
    cols = []
    for idx in taps_idx:
        base = torch.clamp(idx, 0, N - 1).long() * T
        r0 = base + ti.long()
        r1 = base + t1i.long()
        cols += [tbl[r0, lo], tbl[r1, lo], tbl[r0, hi], tbl[r1, hi]]
    return torch.stack(cols, dim=1)


def _corner4(comp, taps_idx, ti, t1i, zlo, zhi):
    """(k, 4*ntaps) corner values of one component."""
    from parcels_tpu_torch.ops import uxcol

    T, _, N = comp.data.shape
    return _corners(uxcol.ux_colT_table(comp), T, N, taps_idx, ti, t1i, zlo, zhi)


def _corner4_uv(vf, taps_idx, ti, t1i, zlo, zhi):
    """(u4, v4) corner values from the fused [U | V] z-row table."""
    from parcels_tpu_torch.ops import uxcol

    T, _, N = vf.U.data.shape
    tbl = uxcol.ux_colT_uv_table(vf)
    P = tbl.shape[1] // 2
    return (_corners(tbl, T, N, taps_idx, ti, t1i, zlo, zhi),
            _corners(tbl, T, N, taps_idx, ti, t1i, zlo, zhi, col0=P))


def _z_brackets(vf, meta, zi_c):
    """Per-component (zlo, zhi) data-space z taps from the clipped interface
    bracket ``zi_c`` (zf: linear between interfaces zi, zi+1; zc: pinned
    layer centre)."""

    def taps(comp, zf):
        Zd = comp.data.shape[1]
        if zf:
            lo = torch.clamp(zi_c, 0, max(Zd - 2, 0))
            return lo, torch.clamp(lo + 1, 0, Zd - 1)
        lo = torch.clamp(zi_c, 0, Zd - 1)
        return lo, lo

    out = {"u": taps(vf.U, meta["zf_u"])}
    if meta["has_w"]:
        out["w"] = taps(vf.W, meta["zf_w"])
    return out


def _ux_full(vf, meta, y, x, ti, t1i, zi_c, fi_stale):
    """Walk + corner reads for one (possibly compacted) batch of lanes."""
    from parcels_tpu_torch._core.uxgrid import _in_cell, _query_points, raster_seed, ux_walk
    from parcels_tpu_torch.ops import uxcol

    spec = vf.grid.spec
    garrs = vf.grid.garrs
    nf = spec.n_face
    ftbl = garrs["face_table"]
    pts = _query_points(y, x, spec.spherical)

    # warm-start from the stale cached face; raster-seed the lanes that
    # face no longer holds
    fi0 = torch.clamp(fi_stale, 0, nf - 1)
    bc0 = uxcol.bary_from_rows(uxcol.face_rows(ftbl, fi0), pts, spec.spherical)
    hit0 = _in_cell(bc0) & (fi_stale >= 0)
    fi, _ = ux_walk(spec, garrs, pts, torch.where(hit0, fi0, raster_seed(spec, garrs, y, x)))

    esc = torch.maximum(
        torch.where(fi == index_search.RIGHT_OUT_OF_BOUNDS, int(StatusCode.ErrorOutOfBounds), 0),
        torch.where(fi == index_search.GRID_SEARCH_ERROR, int(StatusCode.ErrorGridSearching), 0),
    ).to(torch.int32)
    valid = fi >= 0
    fic = torch.clamp(fi, 0, nf - 1)
    row = uxcol.face_rows(ftbl, fic)
    nids = uxcol.nids_from_rows(row)
    node_taps = [nids[:, 0], nids[:, 1], nids[:, 2]]

    zb = _z_brackets(vf, meta, zi_c)
    u4, v4 = _corner4_uv(vf, node_taps if meta["node_u"] else [fic], ti, t1i, *zb["u"])
    out = {
        "face": torch.where(valid, fic, -1).to(torch.int32),
        "verts": uxcol.verts_from_rows(row, spec.spherical),
        "u": u4,
        "v": v4,
        "w": None,
        "esc": esc,
        "oob": ~valid,
    }
    if meta["has_w"]:
        out["w"] = _corner4(vf.W, node_taps if meta["node_w"] else [fic], ti, t1i, *zb["w"])
    return out


def _load_soa_cache(particles, vf):
    """Stage 1 from the SoA: the persistent columns and one row read for the
    triangle frame of each cached face."""
    from parcels_tpu_torch.ops import uxcol

    pd = particles._data
    key = pd[UXC_KEY]
    spec = vf.grid.spec
    row = uxcol.face_rows(vf.grid.garrs["face_table"], key[:, 0])
    return {
        "face": key[:, 0],
        "ti": key[:, 1],
        "zi": key[:, 2],
        "verts": uxcol.verts_from_rows(row, spec.spherical),
        "u": pd[UXC_U],
        "v": pd[UXC_V],
        "w": pd.get(UXC_W),
        "esc": torch.zeros_like(key[:, 0]),
        "oob": torch.zeros_like(key[:, 0], dtype=torch.bool),
    }


def flush_one(c, pd) -> None:
    """Write a UGRID view's final kernel-call cache back into the SoA."""
    pd[UXC_KEY] = torch.stack(
        [c["face"], c["ti"], c["zi"], torch.zeros_like(c["face"])], dim=1
    ).to(torch.int32)
    pd[UXC_U] = c["u"]
    pd[UXC_V] = c["v"]
    if c["w"] is not None and UXC_W in pd:
        pd[UXC_W] = c["w"]


# ---------------------------------------------------------------------------
# blend
# ---------------------------------------------------------------------------


def _z_weights(meta, comp_key, z, zi_c, depth):
    """(w_lo, w_hi) vertical tap weights of one component at positions z."""
    zf = meta["zf_u"] if comp_key == "u" else meta["zf_w"]
    if not zf:
        one = torch.ones_like(z)
        return one, torch.zeros_like(one)
    nzd = depth.shape[0]
    lo = torch.clamp(zi_c, 0, max(nzd - 2, 0)).long()
    hi = torch.clamp(lo + 1, 0, nzd - 1)
    zk = depth[lo]
    zk1 = depth[hi]
    denom = torch.where(zk1 == zk, 1.0, zk1 - zk)
    return (zk1 - z) / denom, (z - zk) / denom


def _blend_comp(vals, ntaps, lat_w, tau, w_lo, w_hi, T):
    """Blend (n, 4*ntaps) cached corners with fresh weights."""
    out = None
    t1w = torch.zeros_like(tau) if T == 1 else tau
    t0w = 1.0 - t1w
    for k in range(ntaps):
        c00 = vals[:, 4 * k + 0]
        c10 = vals[:, 4 * k + 1]
        c01 = vals[:, 4 * k + 2]
        c11 = vals[:, 4 * k + 3]
        v = w_lo * (t0w * c00 + t1w * c10) + w_hi * (t0w * c01 + t1w * c11)
        if lat_w is not None:
            v = v * lat_w[:, k]
        out = v if out is None else out + v
    return out


# ---------------------------------------------------------------------------
# the cached eval
# ---------------------------------------------------------------------------

#: per-lane cache entries a repair writes back
_REPAIR_KEYS = ("face", "verts", "u", "v", "w", "esc", "oob")


def ux_cached_eval(vf, t, z, y, x, particles):
    """Drop-in replacement for VectorFieldView.eval on triangular meshes."""
    from parcels_tpu_torch._core.field import _escalate
    from parcels_tpu_torch._core.uxgrid import _in_cell, _query_points, lanes
    from parcels_tpu_torch.ops import uxcol

    meta = _vf_meta(vf)
    spec = vf.grid.spec
    garrs = vf.grid.garrs
    i32 = dict(dtype=torch.int32, device=y.device)

    if vf.U.has_time:
        ti, tau, t_oob = index_search.search_time(garrs["time"], t, spec.time_uniform)
    else:
        ti = torch.zeros(y.shape, **i32)
        tau = torch.zeros_like(y)
        t_oob = None
    T = vf.U.data.shape[0]
    t1i = torch.clamp(ti + 1, 0, T - 1)

    zi_raw, _ = index_search.search_1d(garrs["depth"], z, spec.depth_uniform)
    zi_c = torch.clamp(zi_raw, 0, max(garrs["depth"].shape[0] - 2, 0))

    esc_zt = torch.maximum(
        torch.where(zi_raw == index_search.RIGHT_OUT_OF_BOUNDS, int(StatusCode.ErrorOutOfBounds), 0),
        torch.where(zi_raw == index_search.LEFT_OUT_OF_BOUNDS,
                    int(StatusCode.ErrorThroughSurface), 0),
    )
    if t_oob is not None:
        esc_zt = torch.maximum(
            esc_zt, torch.where(t_oob, int(StatusCode.ErrorOutsideTimeInterval), 0)
        )
    esc_zt = esc_zt.to(torch.int32)
    z_oob = zi_raw < 0

    c = vf._stage_cache
    if c is None and particles is not None and UXC_KEY in particles._data and vf._sc_owner:
        # cross-step persistence: stage 1 starts from the last step's cache
        c = _load_soa_cache(particles, vf)

    pts = _query_points(y, x, spec.spherical)
    bc = None
    if c is None:
        # first eval of this kernel call: every lane, warm-started from ei
        ux_cached_eval.full_evals += 1
        ei = particles._get_ei(vf.igrid) if particles is not None else None
        fi_stale = ei if ei is not None else torch.zeros(y.shape, **i32)
        c = _ux_full(vf, meta, y, x, ti, t1i, zi_c, fi_stale)
        c["ti"] = ti
        c["zi"] = zi_c
        if particles is not None:
            # only engine-driven evals cache (a host-side fieldset.eval has
            # no kernel-call boundary to reset it)
            vf._stage_cache = c
    else:
        bc0 = uxcol.bary_from_verts(c["verts"], pts, spec.spherical)
        finite = torch.isfinite(y) & torch.isfinite(x)
        hit = _in_cell(bc0) & (ti == c["ti"]) & (zi_c == c["zi"]) & (c["face"] >= 0)
        # dead/NaN lanes can never resolve: they count as hits (the caller
        # masks their values) and take no repair
        miss = ~hit & finite
        if particles is not None:
            miss = miss & particles._mask
        idx = lanes(miss)
        ux_cached_eval.checked_lanes += y.shape[0]
        ux_cached_eval.misses += idx.numel()
        c = dict(c)
        c["esc"] = torch.zeros_like(c["esc"])
        if idx.numel() == 0:
            bc = bc0
        else:
            ux_cached_eval.repairs += 1
            sub = _ux_full(vf, meta, y[idx], x[idx], ti[idx], t1i[idx], zi_c[idx],
                           c["face"][idx])
            sub["ti"], sub["zi"] = ti[idx], zi_c[idx]
            # out of place: the loaded entries alias the SoA, which is never
            # updated in place (particles_view)
            for k in (*_REPAIR_KEYS, "ti", "zi"):
                if c[k] is not None:
                    c[k] = c[k].index_put((idx,), sub[k])
        vf._stage_cache = c
    if bc is None:
        bc = uxcol.bary_from_verts(c["verts"], pts, spec.spherical)

    ntaps_u = 3 if meta["node_u"] else 1
    lat_u = bc if meta["node_u"] else None
    wlo_u, whi_u = _z_weights(meta, "u", z, zi_c, garrs["depth"])
    u = _blend_comp(c["u"], ntaps_u, lat_u, tau, wlo_u, whi_u, T)
    v = _blend_comp(c["v"], ntaps_u, lat_u, tau, wlo_u, whi_u, T)
    if spec.spherical:
        deg2m = spec.deg2m
        u = u / (deg2m * torch.cos(torch.deg2rad(y)))
        v = v / deg2m
    if meta["has_w"]:
        lat_w = bc if meta["node_w"] else None
        wlo_w, whi_w = _z_weights(meta, "w", z, zi_c, garrs["depth"])
        w = _blend_comp(c["w"], 3 if meta["node_w"] else 1, lat_w, tau, wlo_w, whi_w, T)
    else:
        w = torch.zeros_like(u)

    if particles is not None:
        particles.state = torch.maximum(particles.state, torch.maximum(esc_zt, c["esc"]))
        _escalate(particles, torch.isnan(u) | torch.isnan(v) | torch.isnan(w),
                  StatusCode.ErrorInterpolation)
        # refresh the warm-start ei cache (field._update_particles_ei)
        particles._set_ei(vf.igrid, torch.clamp(c["face"], 0, spec.n_face - 1))

    mask0 = c["oob"] | z_oob
    u = torch.where(mask0, 0.0, u)
    v = torch.where(mask0, 0.0, v)
    w = torch.where(mask0, 0.0, w)
    if vf.vector_type == "3D":
        return (u, v, w)
    return (u, v)


#: plain integer counters, read by chip_smoke.py: full-batch evals, lanes
#: checked against a cache, lanes that missed, and stages that repaired
ux_cached_eval.full_evals = 0
ux_cached_eval.checked_lanes = 0
ux_cached_eval.misses = 0
ux_cached_eval.repairs = 0
