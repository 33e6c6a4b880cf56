"""Unstructured triangular (UGRID) grid: host descriptor + batched search (torch).

Port of the JAX package's ``_core/uxgrid.py``. The grid is parsed from
UGRID-convention variables (``node_lon``, ``node_lat``,
``face_node_connectivity``, 1-D ``zf`` interface depths). Search warm-starts
from each lane's cached face; lanes that miss are seeded from a coarse
lookup raster built on the host and walk across the edge of their most
negative barycentric coordinate into the neighbouring face until a face
holds them. Spherical meshes project queries and triangles onto the unit
sphere and use 3-D triangle areas, signed along the face normal (see
``ops/uxcol``).

Where the JAX package branches on the device (``lax.cond`` on "every lane
hit", the walk's ``while_loop`` on "some lane still walking", the straggler
rounds), eager torch reads the device. The walk here runs the JAX
package's hop budget (3 whole-batch hops, then up to 16 for the stragglers)
on the lanes still walking, compacted between rounds of hops: a lane that
found its face, or stopped at the mesh boundary, stays where it is in
every later hop, so the answer is the JAX package's. Each compaction is
one device-to-host read, counted in ``lanes.host_reads``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from parcels_tpu_torch._core import index_search
from parcels_tpu_torch._core.basegrid import BaseGrid
from parcels_tpu_torch._core.grid import _make_time_interval, _uniform_spacing
from parcels_tpu_torch._core.mesh import BaseMesh, get_mesh
from parcels_tpu_torch._core.timeutils import datetimes_to_float_seconds
from parcels_tpu_torch.ops import uxcol

__all__ = ["UxGrid", "UxGridSpec", "UxGridView", "lanes", "ux_search", "ux_walk"]

#: f32 acceptance margin of the in-face test: an edge-riding point can fall
#: fractionally outside both adjacent triangles in f32
_BC_TOL = 1e-5
#: the walk's hop budget: whole-batch hops, then straggler hops
FULL_HOPS = 3
N_WALK = 16
#: straggler hops between two compactions of the walking lanes
_HOPS_PER_ROUND = 4


@dataclasses.dataclass(frozen=True)
class UxGridSpec:
    """Static, hashable description of a triangular mesh."""

    n_face: int
    n_node: int
    nz: int  # number of zf interface levels
    spherical: bool
    deg2m: float
    depth_uniform: tuple[float, float, float] | None
    time_uniform: tuple[float, float, float] | None
    lookup_shape: tuple[int, int]  # raster (ny, nx)
    lookup_origin: tuple[float, float]
    lookup_step: tuple[float, float]


class UxGrid(BaseGrid):
    """Host-side triangular UGRID mesh with 1-D interface depths.

    Parameters
    ----------
    node_lon, node_lat : (n_node,) float arrays
    face_node_connectivity : (n_face, 3) int array
    z : (nz,) vertical interface depths (constant in time and space)
    mesh : "flat" | "spherical"
    time : optional datetime64 array for the time axis
    """

    def __init__(
        self,
        node_lon: np.ndarray,
        node_lat: np.ndarray,
        face_node_connectivity: np.ndarray,
        z: np.ndarray,
        mesh: Literal["flat", "spherical"] | BaseMesh = "flat",
        time: np.ndarray | None = None,
    ):
        self.node_lon = np.asarray(node_lon, dtype=np.float64)
        self.node_lat = np.asarray(node_lat, dtype=np.float64)
        conn = np.asarray(face_node_connectivity)
        if conn.ndim != 2 or conn.shape[1] != 3:
            raise ValueError(
                "face_node_connectivity must be (n_face, 3): only triangular meshes are supported."
            )
        self.face_node_connectivity = conn.astype(np.int32)
        self.depth = np.asarray(z, dtype=np.float64)
        if self.depth.ndim != 1:
            raise ValueError("z must be a 1D array of vertical interface coordinates")
        self._mesh = get_mesh(mesh)

        self._datetimes = np.asarray(time) if time is not None else None
        if self._datetimes is not None and len(self._datetimes) > 0:
            self.time_interval = _make_time_interval(self._datetimes)
            self.time = datetimes_to_float_seconds(self._datetimes, self.time_interval.left)
        else:
            self.time_interval = None
            self.time = np.zeros(1, dtype=np.float64)

        self._lookup = _build_face_lookup(self.node_lon, self.node_lat, self.face_node_connectivity)
        self._adjacency = _build_face_adjacency(self.face_node_connectivity)
        self._face_table = None  # built at first use (ops/uxcol.py fused rows)
        self._device_tensors = {}  # (device, dtype, name) -> tensor
        self.axes = ["Z", "FACE"]

        self.spec = UxGridSpec(
            n_face=int(conn.shape[0]),
            n_node=int(self.node_lon.shape[0]),
            nz=int(self.depth.shape[0]),
            spherical=self._mesh.is_spherical(),
            deg2m=self.deg2m,
            depth_uniform=_uniform_spacing(self.depth),
            time_uniform=_uniform_spacing(self.time),
            lookup_shape=self._lookup["fi"].shape,
            lookup_origin=self._lookup["origin"],
            lookup_step=self._lookup["step"],
        )

    @property
    def mesh(self) -> BaseMesh:
        return self._mesh

    @property
    def deg2m(self) -> float:
        return self._mesh.deg2m if self._mesh.is_spherical() else 1.0

    @property
    def n_face(self) -> int:
        return self.spec.n_face

    def get_axis_dim(self, axis: str) -> int:
        if axis == "Z":
            return self.spec.nz
        if axis == "FACE":
            return self.spec.n_face
        raise ValueError(f"Axis {axis!r} is not part of this grid. Available axes: {self.axes}")

    def ravel_index(self, zi, yi, xi):
        # ei caches the face index; z is re-bracketed at every eval
        return xi

    def unravel_index(self, ei):
        return ei * 0, ei * 0, ei

    def embedding(self) -> np.ndarray:
        """(n_node, d) node coordinates the search works in: unit-sphere XYZ
        on spherical meshes, (lon, lat) on flat ones (float64)."""
        if self._mesh.is_spherical():
            lat = np.deg2rad(self.node_lat)
            lon = np.deg2rad(self.node_lon)
            return np.stack(
                [np.cos(lon) * np.cos(lat), np.sin(lon) * np.cos(lat), np.sin(lat)], axis=-1
            )
        return np.stack([self.node_lon, self.node_lat], axis=-1)

    def face_table(self) -> np.ndarray:
        """The fused (n_face, 64) f32 face rows (``ops/uxcol.build_face_table``)."""
        if self._face_table is None:
            self._face_table = uxcol.build_face_table(
                self.embedding().astype(np.float32), self.face_node_connectivity, self._adjacency
            )
        return self._face_table

    def device_arrays(self, device, dtype=np.float32) -> dict:
        """Mesh tensors on ``device``, with the fused face table when the
        ``uxcol`` tier is on. Each tensor crosses to a device once."""
        device = torch.device(device)
        host = {
            "nodes": lambda: self.embedding().astype(dtype),
            "node_lon": lambda: self.node_lon.astype(dtype),
            "node_lat": lambda: self.node_lat.astype(dtype),
            "conn": lambda: self.face_node_connectivity,
            "depth": lambda: self.depth.astype(dtype),
            "time": lambda: self.time.astype(np.float32),
            "lookup_fi": lambda: self._lookup["fi"],
            "adj": lambda: self._adjacency,
        }
        if uxcol.enabled(self.spec.n_face, device):
            host["face_table"] = self.face_table
        out = {}
        for name, make in host.items():
            key = (device, np.dtype(dtype).str, name)
            if key not in self._device_tensors:
                self._device_tensors[key] = torch.as_tensor(np.ascontiguousarray(make()),
                                                            device=device)
            out[name] = self._device_tensors[key]
        return out

    def lookup_meta(self) -> dict:
        return {"origin": self._lookup["origin"], "step": self._lookup["step"]}

    def make_view(self, garrs: dict) -> "UxGridView":
        return UxGridView(self.spec, garrs, self.lookup_meta())

    def _search_device(self, garrs: dict, z, y, x, ei):
        return ux_search(self.spec, garrs, z, y, x, ei=ei)

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

    def __repr__(self):
        mesh = "spherical" if self.spec.spherical else "flat"
        return (
            f"UxGrid({mesh}, n_face={self.spec.n_face}, n_node={self.spec.n_node}, "
            f"nz={self.spec.nz}, lookup={self.spec.lookup_shape})"
        )

    def _repr_sections(self):
        fi = self._lookup["fi"]
        return [
            ("geometry", [repr(self)]),
            ("search", [f"lookup raster: {fi.shape[0]}x{fi.shape[1]} cells, "
                        f"{(fi >= 0).mean() * 100:.1f}% seeded",
                        f"boundary edges: {(self._adjacency < 0).sum()}"]),
        ]

    def describe(self, buf=None) -> None:
        """The JAX package's text: the repr, the raster's seeding, the
        boundary edges."""
        import sys

        search = dict(self._repr_sections())["search"]
        (buf or sys.stdout).write(f"{self!r}\n" + "".join(f"  {ln}\n" for ln in search))

    def _repr_html_(self):
        from parcels_tpu_torch._repr import html_sections

        return html_sections(type(self).__name__, self._repr_sections())


def _build_face_lookup(node_lon, node_lat, conn, cells_per_tri: float = 2.0, max_dim: int = 1024):
    """Coarse raster (lat, lon) -> covering/nearest face index, built on the host.

    Every raster cell stores the face holding its centre (exact
    point-in-triangle rasterization), or the nearest face centroid for cells
    outside the mesh. Resolution targets ~``cells_per_tri`` raster cells per
    triangle edge.
    """
    n_face = conn.shape[0]
    tx = node_lon[conn]  # (n_face, 3)
    ty = node_lat[conn]
    lon_min, lon_max = float(node_lon.min()), float(node_lon.max())
    lat_min, lat_max = float(node_lat.min()), float(node_lat.max())
    pad_x = max((lon_max - lon_min) * 1e-6, 1e-12)
    pad_y = max((lat_max - lat_min) * 1e-6, 1e-12)
    lon_min -= pad_x
    lon_max += pad_x
    lat_min -= pad_y
    lat_max += pad_y

    # raster resolution from the median triangle bbox size
    dx_tri = np.median(tx.max(axis=1) - tx.min(axis=1))
    dy_tri = np.median(ty.max(axis=1) - ty.min(axis=1))
    nx = int(np.clip((lon_max - lon_min) / max(dx_tri / cells_per_tri, 1e-12), 8, max_dim))
    ny = int(np.clip((lat_max - lat_min) / max(dy_tri / cells_per_tri, 1e-12), 8, max_dim))
    step_x = (lon_max - lon_min) / nx
    step_y = (lat_max - lat_min) / ny

    from parcels_tpu_torch import native

    tbl = native.rasterize_faces(node_lon, node_lat, conn, lat_min, lon_min, step_y, step_x, ny, nx)
    if tbl is None:  # numpy fallback (no g++)
        tbl = np.full((ny, nx), -1, dtype=np.int32)
        cx = (np.arange(nx) + 0.5) * step_x + lon_min
        cy = (np.arange(ny) + 0.5) * step_y + lat_min
        for f in range(n_face):
            x0 = int(np.clip((tx[f].min() - lon_min) / step_x, 0, nx - 1))
            x1 = int(np.clip((tx[f].max() - lon_min) / step_x, 0, nx - 1)) + 1
            y0 = int(np.clip((ty[f].min() - lat_min) / step_y, 0, ny - 1))
            y1 = int(np.clip((ty[f].max() - lat_min) / step_y, 0, ny - 1)) + 1
            PX, PY = np.meshgrid(cx[x0:x1], cy[y0:y1])
            a = _tri_area2(tx[f, 0], ty[f, 0], tx[f, 1], ty[f, 1], tx[f, 2], ty[f, 2])
            if abs(a) < 1e-14:
                continue
            b0 = _tri_area2(PX, PY, tx[f, 1], ty[f, 1], tx[f, 2], ty[f, 2]) / a
            b1 = _tri_area2(tx[f, 0], ty[f, 0], PX, PY, tx[f, 2], ty[f, 2]) / a
            b2 = 1.0 - b0 - b1
            inside = (b0 >= -1e-9) & (b1 >= -1e-9) & (b2 >= -1e-9)
            sub = tbl[y0:y1, x0:x1]
            sub[inside & (sub < 0)] = f
            tbl[y0:y1, x0:x1] = sub

    # fill uncovered cells with the nearest face centroid, so boundary
    # queries still get a seed whose neighbourhood the walk checks
    if (tbl < 0).any():
        cen_x = tx.mean(axis=1)
        cen_y = ty.mean(axis=1)
        ry = np.clip(((cen_y - lat_min) / step_y).astype(int), 0, ny - 1)
        rx = np.clip(((cen_x - lon_min) / step_x).astype(int), 0, nx - 1)
        seed = np.full((ny, nx), -1, dtype=np.int32)
        seed[ry, rx] = np.arange(n_face, dtype=np.int32)
        empty = tbl < 0
        filled = np.where(empty & (seed >= 0), seed, tbl)
        for _ in range(max(ny, nx)):
            if not (filled < 0).any():
                break
            for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                cand = np.roll(filled, (dy, dx), axis=(0, 1))
                take = (filled < 0) & (cand >= 0)
                filled[take] = cand[take]
        filled[filled < 0] = 0
        tbl = filled

    return {"origin": (lat_min, lon_min), "step": (step_y, step_x), "fi": tbl}


def _tri_area2(ax, ay, bx, by, cx, cy):
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)


def _build_face_adjacency(conn: np.ndarray) -> np.ndarray:
    """Edge-neighbour table: adj[f, k] = face sharing the edge opposite node k
    of face f (-1 on the mesh boundary). Drives the walk."""
    from parcels_tpu_torch import native

    adj = native.build_face_adjacency(conn)
    if adj is not None:
        return adj
    n_face = conn.shape[0]
    edge_owner: dict[tuple[int, int], tuple[int, int]] = {}
    adj = np.full((n_face, 3), -1, dtype=np.int32)
    for f in range(n_face):
        for k in range(3):
            a, b = conn[f, (k + 1) % 3], conn[f, (k + 2) % 3]
            key = (min(a, b), max(a, b))
            if key in edge_owner:
                g, j = edge_owner.pop(key)
                adj[f, k] = g
                adj[g, j] = f
            else:
                edge_owner[key] = (f, k)
    return adj


# ---------------------------------------------------------------------------
# device-side search
# ---------------------------------------------------------------------------


def lanes(mask) -> torch.Tensor:
    """Indices (int64) of the set lanes of ``mask``: one device-to-host read."""
    lanes.host_reads += 1
    return torch.nonzero(mask).squeeze(1)


#: device-to-host reads of the UGRID search and stage cache (read by chip_smoke.py)
lanes.host_reads = 0


def _query_points(y, x, spherical: bool):
    if spherical:
        lon = torch.deg2rad(x)
        lat = torch.deg2rad(y)
        cl = torch.cos(lat)
        return torch.stack([torch.cos(lon) * cl, torch.sin(lon) * cl, torch.sin(lat)], dim=-1)
    return torch.stack([x, y], dim=-1)


def _bary_coords(garrs, fi, pts, spherical: bool):
    """Barycentric coords of ``pts`` (n, d) in faces ``fi`` (n,) -> (n, 3),
    from the connectivity and node tables."""
    nf = garrs["conn"].shape[0]
    nids = garrs["conn"][torch.clamp(fi, 0, nf - 1).long()].long()
    nodes = garrs["nodes"]
    v = [uxcol._axes(nodes[nids[:, k]]) for k in range(3)]
    return uxcol.bary(*v, uxcol._axes(pts), spherical)


def _in_cell(bc):
    b0, b1, b2 = bc[:, 0], bc[:, 1], bc[:, 2]
    ok = (b0 >= -_BC_TOL) & (b1 >= -_BC_TOL) & (b2 >= -_BC_TOL)
    return ok & torch.isclose(b0 + b1 + b2, torch.ones_like(b0), rtol=1e-3, atol=1e-6)


def _bary_at(spec, garrs, fi, pts):
    """(bc, rows): barycentrics of ``pts`` in faces ``fi``, through the fused
    face rows when the grid ships them (rows None otherwise)."""
    ftbl = garrs.get("face_table")
    if ftbl is None:
        return _bary_coords(garrs, fi, pts, spec.spherical), None
    rows = uxcol.face_rows(ftbl, fi)
    return uxcol.bary_from_rows(rows, pts, spec.spherical), rows


def _hops(spec, garrs, pts, fi, bc, rows, found, hit_b, hops: int):
    """``hops`` walk hops of every lane given. Each unfound lane crosses the
    edge of its most negative coordinate (the first of equal ones); a lane
    facing the mesh boundary stays and is marked."""
    nf = spec.n_face
    for _ in range(hops):
        b0, b1, b2 = bc[:, 0], bc[:, 1], bc[:, 2]
        if rows is not None:
            k01 = b0 <= b1
            use2 = b2 < torch.where(k01, b0, b1)
            k = torch.where(use2, 2, torch.where(k01, 0, 1))
            nxt = uxcol.adj_from_rows(rows, k)
        else:
            k = torch.argmin(bc, dim=-1)
            nxt = garrs["adj"][torch.clamp(fi, 0, nf - 1).long(), k]
        move = ~found & (nxt >= 0)
        hit_b = hit_b | (~found & (nxt < 0))
        fi = torch.where(move, nxt, fi)
        nb, rows = _bary_at(spec, garrs, fi, pts)
        bc = torch.where(found[:, None], bc, nb)
        found = found | _in_cell(nb)
    return fi, bc, rows, found, hit_b


def ux_walk(spec: UxGridSpec, garrs: dict, pts, fi):
    """Adjacency walk from seed faces ``fi`` for points ``pts``.

    Returns ``(fi, bc)``: lanes that found no face carry the search
    sentinels, RIGHT_OUT_OF_BOUNDS after running into the mesh boundary and
    GRID_SEARCH_ERROR after the hop budget. The lanes still walking are
    compacted before the first hop and after each round of hops.
    """
    bc, rows = _bary_at(spec, garrs, fi, pts)
    found = _in_cell(bc)
    hit_b = torch.zeros_like(found)
    fi = fi.clone()
    walking = lanes(~found)
    for hops in [FULL_HOPS] + [_HOPS_PER_ROUND] * (N_WALK // _HOPS_PER_ROUND):
        if walking.numel() == 0:
            break
        w = walking
        s_fi, s_bc, s_rows, s_found, s_hb = _hops(
            spec, garrs, pts[w], fi[w], bc[w], None if rows is None else rows[w],
            found[w], hit_b[w], hops,
        )
        fi[w], bc[w], found[w], hit_b[w] = s_fi, s_bc, s_found, s_hb
        if rows is not None:
            rows[w] = s_rows
        walking = w[lanes(~s_found & ~s_hb)]
    fi = torch.where(
        found, fi,
        torch.where(hit_b, index_search.RIGHT_OUT_OF_BOUNDS, index_search.GRID_SEARCH_ERROR),
    ).to(torch.int32)
    return fi, bc


def raster_seed(spec: UxGridSpec, garrs: dict, y, x):
    """Face of the lookup raster cell of each position (clamped to the raster)."""
    (oy, ox), (sy, sx) = spec.lookup_origin, spec.lookup_step
    ny, nx = spec.lookup_shape
    ry = index_search._to_index(torch.floor((y - oy) / sy), 0, ny - 1).long()
    rx = index_search._to_index(torch.floor((x - ox) / sx), 0, nx - 1).long()
    return torch.clamp(garrs["lookup_fi"][ry, rx], 0, spec.n_face - 1)


class UxGridView:
    """Device view of a UxGrid in the engine (duck-typed with field.GridView)."""

    __slots__ = ("spec", "garrs", "lookup_meta")

    def __init__(self, spec: UxGridSpec, garrs: dict, lookup_meta: dict | None = None):
        self.spec = spec
        self.garrs = garrs
        self.lookup_meta = lookup_meta

    def search(self, z, y, x, ei=None):
        return ux_search(self.spec, self.garrs, z, y, x, ei)


def ux_search(spec: UxGridSpec, garrs: dict, z, y, x, ei=None):
    """Locate particles on the triangular mesh: {Z, FACE} positions.

    A barycentric check on the cached face ``ei`` (face 0 without one);
    the lanes that miss it are seeded from the lookup raster and walk. A
    walk into the mesh boundary marks the lane RIGHT_OUT_OF_BOUNDS, one that
    does not converge GRID_SEARCH_ERROR.
    """
    zi, zeta = index_search.search_1d(garrs["depth"], z, spec.depth_uniform)
    pts = _query_points(y, x, spec.spherical)
    if ei is not None:
        fi = torch.clamp(ei, 0, spec.n_face - 1).to(torch.int32)
    else:
        fi = torch.zeros(y.shape, dtype=torch.int32, device=y.device)
    bc, _ = _bary_at(spec, garrs, fi, pts)
    miss = lanes(~_in_cell(bc))
    if miss.numel():
        m_fi, m_bc = ux_walk(spec, garrs, pts[miss], raster_seed(spec, garrs, y[miss], x[miss]))
        fi = fi.clone()
        bc = bc.clone()
        fi[miss] = m_fi
        bc[miss] = m_bc
    return {
        "Z": {"index": zi, "bcoord": zeta},
        "FACE": {"index": fi, "bcoord": bc},
    }
