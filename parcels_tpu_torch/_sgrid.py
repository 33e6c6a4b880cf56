"""Host-side SGRID-convention metadata handling.

Implements the subset of the public SGRID conventions
(https://sgrid.github.io/sgrid/) needed to describe staggered structured
grids: node/face dimension pairs with padding, optional vertical dimension,
and (de)serialization to a ``grid`` variable's attrs. Capability parity with
reference src/parcels/_sgrid/core.py, reimplemented compactly — the heavy
ASCII-diagram/paired-isel accessor machinery of the reference is not needed
on the TPU side, where all staggering is folded into static integer offsets
at ingest time.
"""

from __future__ import annotations

import enum
import re
from dataclasses import dataclass
from typing import Literal

from parcels_tpu_torch import xrlite as xr

__all__ = [
    "SgridAccessor",
    "register_xarray_accessor",
    "FaceNodePadding",
    "Padding",
    "SGrid2DMetadata",
    "SGrid3DMetadata",
    "assert_metadata_ds_consistency",
    "attach_sgrid_metadata",
    "get_dim_position",
    "get_n_faces",
    "get_n_nodes",
    "parse_sgrid_metadata",
    "rename_metadata",
    "rename_sgrid_dataset",
    "sgrid_isel",
]

_RE_FACE_NODE_PADDING = r"(\w+):(\w+)\s*\(padding:\s*(\w+)\)"


class Padding(enum.Enum):
    NONE = "none"
    LOW = "low"
    HIGH = "high"
    BOTH = "both"


def get_n_faces(n_nodes: int, padding: Padding) -> int:
    if padding in (Padding.LOW, Padding.HIGH):
        return n_nodes
    if padding == Padding.NONE:
        return n_nodes - 1
    if padding == Padding.BOTH:
        return n_nodes + 1
    raise ValueError(f"Invalid {padding=!r}")


def get_n_nodes(n_faces: int, padding: Padding) -> int:
    if padding in (Padding.LOW, Padding.HIGH):
        return n_faces
    if padding == Padding.NONE:
        return n_faces + 1
    if padding == Padding.BOTH:
        return n_faces - 1
    raise ValueError(f"Invalid {padding=!r}")


@dataclass(frozen=True)
class FaceNodePadding:
    """face/node dimension pair plus the SGRID padding relation between them."""

    face: str
    node: str
    padding: Padding

    def __str__(self):
        return f"{self.face}:{self.node} (padding:{self.padding.value})"

    @classmethod
    def load(cls, s: str) -> "FaceNodePadding":
        m = re.match(_RE_FACE_NODE_PADDING, s)
        if not m:
            raise ValueError(f"String {s!r} does not match 'face:node (padding: p)' format")
        return cls(m.group(1), m.group(2), Padding(m.group(3).lower()))


def _load_pairs(s: str) -> tuple:
    """Parse a whitespace-joined list of FaceNodePadding or bare dims."""
    parts = []
    tokens = re.findall(_RE_FACE_NODE_PADDING + r"|(\S+)", s)
    for face, node, padding, bare in tokens:
        if bare:
            parts.append(bare)
        else:
            parts.append(FaceNodePadding(face, node, Padding(padding.lower())))
    return tuple(parts)


def _fnp_diagram(fnp: "FaceNodePadding") -> list[str]:
    """ASCII lines visualizing one face/node padding relation.

    Nodes render as ``●`` with their indices below; each ``───`` span is one
    face cell with its index centered under it (capability parity with the
    reference's grid diagrams, _sgrid/core.py:481-653).
    """
    seg = 5
    layouts = {
        Padding.NONE: "n-n-n-n-n",
        Padding.LOW: "-n-n-n-n-n",
        Padding.HIGH: "n-n-n-n-n-",
        Padding.BOTH: "-n-n-n-n-n-",
    }
    bar, label = "", ""
    n_i = f_i = 0
    for ch in layouts[fnp.padding]:
        if ch == "n":
            bar += "●"
            label += str(n_i)
            n_i += 1
        else:
            bar += "─" * seg
            label += str(f_i).center(seg)
            f_i += 1
    return [f"{fnp.face}:{fnp.node} (padding:{fnp.padding.value})", f"  {bar}", f"  {label.rstrip()}"]


@dataclass(frozen=True)
class SGrid2DMetadata:
    """2-D (optionally layered) SGRID topology description."""

    node_dimensions: tuple[str, str]
    face_dimensions: tuple[FaceNodePadding, FaceNodePadding]
    node_coordinates: tuple[str, str] | None = None
    vertical_dimensions: tuple[FaceNodePadding] | None = None
    cf_role: str = "grid_topology"
    topology_dimension: int = 2

    def to_attrs(self) -> dict:
        d = {
            "cf_role": self.cf_role,
            "topology_dimension": self.topology_dimension,
            "node_dimensions": " ".join(self.node_dimensions),
            "face_dimensions": " ".join(str(f) for f in self.face_dimensions),
        }
        if self.node_coordinates is not None:
            d["node_coordinates"] = " ".join(self.node_coordinates)
        if self.vertical_dimensions is not None:
            d["vertical_dimensions"] = " ".join(str(f) for f in self.vertical_dimensions)
        return d

    @classmethod
    def from_attrs(cls, attrs: dict) -> "SGrid2DMetadata":
        node_dims = tuple(str(attrs["node_dimensions"]).split())
        face_dims = _load_pairs(str(attrs["face_dimensions"]))
        node_coords = attrs.get("node_coordinates")
        if node_coords is not None:
            node_coords = tuple(str(node_coords).split())
        vert = attrs.get("vertical_dimensions")
        if vert is not None:
            vert = _load_pairs(str(vert))
        return cls(
            node_dimensions=node_dims,  # type: ignore[arg-type]
            face_dimensions=face_dims,  # type: ignore[arg-type]
            node_coordinates=node_coords,  # type: ignore[arg-type]
            vertical_dimensions=vert,  # type: ignore[arg-type]
        )

    # -- convenience lookups ------------------------------------------------
    def dim_to_axis(self) -> dict[str, Literal["X", "Y", "Z"]]:
        fnp_x, fnp_y = self.face_dimensions
        d = {fnp_x.node: "X", fnp_x.face: "X", fnp_y.node: "Y", fnp_y.face: "Y"}
        if self.vertical_dimensions is not None:
            fnp_z = self.vertical_dimensions[0]
            d.update({fnp_z.node: "Z", fnp_z.face: "Z"})
        return d  # type: ignore[return-value]

    def dim_position(self, dim: str) -> "Literal['face'] | Padding":
        """'face' if ``dim`` is a face dimension, else the node padding."""
        for fnp in list(self.face_dimensions) + list(self.vertical_dimensions or ()):
            if dim == fnp.face:
                return "face"
            if dim == fnp.node:
                return fnp.padding
        raise ValueError(f"Dimension {dim!r} is not a spatial SGRID dimension in this grid.")

    @property
    def _pairs(self) -> tuple[FaceNodePadding, ...]:
        return tuple(self.face_dimensions) + tuple(self.vertical_dimensions or ())

    def __str__(self) -> str:
        lines = [f"SGrid2DMetadata nodes=({', '.join(self.node_dimensions)})"]
        for fnp in self._pairs:
            lines += _fnp_diagram(fnp)
        return "\n".join(lines)

    def axis_padding(self, axis: str) -> Padding:
        fnp_x, fnp_y = self.face_dimensions
        if axis == "X":
            return fnp_x.padding
        if axis == "Y":
            return fnp_y.padding
        if axis == "Z" and self.vertical_dimensions is not None:
            return self.vertical_dimensions[0].padding
        raise ValueError(f"No padding for axis {axis!r}")


@dataclass(frozen=True)
class SGrid3DMetadata:
    """Fully 3-D SGRID topology (reference _sgrid/core.py:192-260): three
    node dimensions paired with three padded volume dimensions."""

    node_dimensions: tuple[str, str, str]
    volume_dimensions: tuple[FaceNodePadding, FaceNodePadding, FaceNodePadding]
    node_coordinates: tuple[str, str, str] | None = None
    cf_role: str = "grid_topology"
    topology_dimension: int = 3

    def __post_init__(self):
        if self.cf_role != "grid_topology":
            raise ValueError(f"cf_role must be 'grid_topology', got {self.cf_role!r}")
        if self.topology_dimension != 3:
            raise ValueError("topology_dimension must be 3 for a 3D grid")
        if len(self.node_dimensions) != 3:
            raise ValueError("node_dimensions must be a tuple of 3 dimensions for a 3D grid")
        if len(self.volume_dimensions) != 3 or not all(
            isinstance(f, FaceNodePadding) for f in self.volume_dimensions
        ):
            raise ValueError("volume_dimensions must be a tuple of 3 FaceNodePadding")
        if self.node_coordinates is not None and len(self.node_coordinates) != 3:
            raise ValueError("node_coordinates must be a tuple of 3 names for a 3D grid")

    def to_attrs(self) -> dict:
        d = {
            "cf_role": self.cf_role,
            "topology_dimension": self.topology_dimension,
            "node_dimensions": " ".join(self.node_dimensions),
            "volume_dimensions": " ".join(str(f) for f in self.volume_dimensions),
        }
        if self.node_coordinates is not None:
            d["node_coordinates"] = " ".join(self.node_coordinates)
        return d

    @classmethod
    def from_attrs(cls, attrs: dict) -> "SGrid3DMetadata":
        node_dims = tuple(str(attrs["node_dimensions"]).split())
        vol_dims = _load_pairs(str(attrs["volume_dimensions"]))
        node_coords = attrs.get("node_coordinates")
        if node_coords is not None:
            node_coords = tuple(str(node_coords).split())
        return cls(
            node_dimensions=node_dims,  # type: ignore[arg-type]
            volume_dimensions=vol_dims,  # type: ignore[arg-type]
            node_coordinates=node_coords,  # type: ignore[arg-type]
        )

    # same lookup surface as SGrid2DMetadata so callers can duck-type
    def dim_position(self, dim: str) -> "Literal['face'] | Padding":
        for fnp in self.volume_dimensions:
            if dim == fnp.face:
                return "face"
            if dim == fnp.node:
                return fnp.padding
        raise ValueError(f"Dimension {dim!r} is not a spatial SGRID dimension in this grid.")

    @property
    def _pairs(self) -> tuple[FaceNodePadding, ...]:
        return self.volume_dimensions

    def __str__(self) -> str:
        lines = [f"SGrid3DMetadata nodes=({', '.join(self.node_dimensions)})"]
        for fnp in self._pairs:
            lines += _fnp_diagram(fnp)
        return "\n".join(lines)


def attach_sgrid_metadata(ds: xr.Dataset, grid: "SGrid2DMetadata | SGrid3DMetadata") -> xr.Dataset:
    """Copy the dataset and attach SGRID metadata as a ``grid`` variable."""
    ds = ds.copy()
    ds["grid"] = ([], 0, grid.to_attrs())
    ds.attrs["Conventions"] = "SGRID"
    return ds


def parse_sgrid_metadata(ds: xr.Dataset) -> "SGrid2DMetadata | SGrid3DMetadata":
    """Find the grid_topology variable in ``ds`` and parse its SGRID attrs.

    Dispatches on ``topology_dimension`` (2 -> SGrid2DMetadata,
    3 -> SGrid3DMetadata), matching reference _sgrid/accessor.py:29-44.
    """
    for var in ds.variables.values():
        if var.attrs.get("cf_role") == "grid_topology":
            if int(var.attrs.get("topology_dimension", 2)) == 3:
                return SGrid3DMetadata.from_attrs(var.attrs)
            return SGrid2DMetadata.from_attrs(var.attrs)
    raise ValueError(
        "Dataset has no variable with cf_role='grid_topology'; cannot parse SGRID metadata."
    )


# ---------------------------------------------------------------------------
# Metadata rename (reference _sgrid/core.py:676-722)
# ---------------------------------------------------------------------------


def _metadata_names(grid) -> set[str]:
    names = set(grid.node_dimensions)
    for fnp in grid._pairs:
        names |= {fnp.face, fnp.node}
    if grid.node_coordinates is not None:
        names |= set(grid.node_coordinates)
    return names


def rename_metadata(grid: "SGrid2DMetadata | SGrid3DMetadata", names_dict: dict[str, str]):
    """Rename dimensions/coordinates inside SGRID metadata, xr.rename-style.

    Every key must name an existing dimension or coordinate in the metadata;
    target names must be unique (reference _sgrid/core.py:676-722).
    """
    if len(names_dict) != len(set(names_dict.values())):
        raise ValueError("names_dict contains duplicate target names")
    existing = _metadata_names(grid)
    for name in names_dict:
        if name not in existing:
            raise ValueError(
                f"Name {name!r} not found in names defined in SGrid metadata {sorted(existing)!r}"
            )
    m = {n: names_dict.get(n, n) for n in existing}

    def _pair(fnp: FaceNodePadding) -> FaceNodePadding:
        return FaceNodePadding(m[fnp.face], m[fnp.node], fnp.padding)

    node_dims = tuple(m[n] for n in grid.node_dimensions)
    coords = (
        tuple(m[n] for n in grid.node_coordinates) if grid.node_coordinates is not None else None
    )
    if isinstance(grid, SGrid3DMetadata):
        return SGrid3DMetadata(
            node_dimensions=node_dims,  # type: ignore[arg-type]
            volume_dimensions=tuple(_pair(f) for f in grid.volume_dimensions),  # type: ignore[arg-type]
            node_coordinates=coords,  # type: ignore[arg-type]
        )
    return SGrid2DMetadata(
        node_dimensions=node_dims,  # type: ignore[arg-type]
        face_dimensions=tuple(_pair(f) for f in grid.face_dimensions),  # type: ignore[arg-type]
        node_coordinates=coords,  # type: ignore[arg-type]
        vertical_dimensions=(
            tuple(_pair(f) for f in grid.vertical_dimensions)  # type: ignore[arg-type]
            if grid.vertical_dimensions is not None
            else None
        ),
    )


def rename_sgrid_dataset(ds: xr.Dataset, names_dict: dict[str, str]) -> xr.Dataset:
    """Rename dataset dims/vars AND the embedded SGRID metadata together."""
    meta = parse_sgrid_metadata(ds)
    spatial = {k: v for k, v in names_dict.items() if k in _metadata_names(meta)}
    new_meta = rename_metadata(meta, spatial)
    out = ds.rename(names_dict)
    out["grid"] = ([], 0, new_meta.to_attrs())
    return out


# ---------------------------------------------------------------------------
# Padding-aware paired isel (reference _sgrid/accessor.py:46-265)
# ---------------------------------------------------------------------------


def get_dim_position(grid, dim: str) -> "Literal['face'] | Padding":
    """'face' if ``dim`` is a face dimension, else the node padding
    (reference _sgrid/accessor.py:151-158)."""
    return grid.dim_position(dim)


def _axis_info(grid) -> dict[str, tuple[FaceNodePadding, bool]]:
    """dim name -> (pair, is_node) over all spatial dims."""
    info: dict[str, tuple[FaceNodePadding, bool]] = {}
    for fnp in grid._pairs:
        info[fnp.node] = (fnp, True)
        info[fnp.face] = (fnp, False)
    return info


def _derive_paired_indexer(indexer, indexer_is_node: bool, padding: Padding, dim_size=None):
    """(normalized_user_indexer, paired_indexer) for one face/node pair
    (reference _sgrid/accessor.py:160-210).

    HIGH/LOW: sizes match, both indexers identical. NONE/BOTH: only
    contiguous unit-step slices are well defined; the paired slice's stop is
    shifted by the face/node count arithmetic.
    """
    if padding in (Padding.HIGH, Padding.LOW):
        return indexer, indexer
    if not isinstance(indexer, slice):
        raise ValueError(
            f"Scalar and list indexers are not supported for NONE/BOTH padding. "
            f"Got indexer {indexer!r}. Use a slice instead."
        )
    if indexer.step not in (None, 1):
        raise ValueError(
            f"Slices with step != 1 are not supported for NONE/BOTH padding. "
            f"Got step={indexer.step!r}."
        )
    if dim_size is None:
        raise ValueError("dim_size must be provided for NONE/BOTH padding slices.")
    abs_start, abs_stop, _ = indexer.indices(dim_size)
    normalized = slice(abs_start, abs_stop)
    stop = abs_stop
    if stop > 0:
        stop = get_n_faces(stop, padding) if indexer_is_node else get_n_nodes(stop, padding)
    return normalized, slice(abs_start, stop)


def sgrid_isel(ds: xr.Dataset, indexers: dict | None = None, **indexers_kwargs) -> xr.Dataset:
    """Index along SGRID spatial dims keeping face/node dims consistent.

    Functional equivalent of the reference's ``ds.sgrid.isel`` accessor
    (reference _sgrid/accessor.py:46-92): for each user indexer, the paired
    indexer for the other side of the face/node pair is derived from the
    padding, both are applied, and the result is re-validated against the
    metadata. Only spatial dims may be indexed, and at most one dim per axis.
    """
    if indexers_kwargs:
        if indexers is not None:
            raise ValueError("Cannot provide both positional and keyword indexers to sgrid_isel.")
        indexers = indexers_kwargs
    if indexers is None:
        raise ValueError("Must provide indexers positionally or as keyword arguments.")

    meta = parse_sgrid_metadata(ds)
    info = _axis_info(meta)
    for dim in indexers:
        if dim not in info:
            raise ValueError(
                f"Cannot use sgrid_isel on non-spatial (/SGRID related) dimension {dim!r}."
            )
    seen_pairs: dict[int, str] = {}
    for dim in indexers:
        pid = id(info[dim][0])
        if pid in seen_pairs:
            raise ValueError(
                f"Dims {[seen_pairs[pid], dim]} are on the same axis according to SGRID "
                "metadata - cannot simultaneously index along multiple dimensions in the same axis."
            )
        seen_pairs[pid] = dim

    full: dict[str, object] = {}
    for user_dim, user_idx in indexers.items():
        fnp, is_node = info[user_dim]
        normalized, paired = _derive_paired_indexer(
            user_idx, is_node, fnp.padding, dim_size=ds.sizes.get(user_dim)
        )
        node_idx = normalized if is_node else paired
        face_idx = paired if is_node else normalized
        if fnp.node in ds.sizes:
            full[fnp.node] = node_idx
        if fnp.face in ds.sizes:
            full[fnp.face] = face_idx
    out = ds.isel(full)
    assert_metadata_ds_consistency(out, meta)
    return out


def assert_metadata_ds_consistency(ds: xr.Dataset, metadata) -> None:
    """Check every face/node dim pair present in ``ds`` still satisfies the
    padding arithmetic (reference _sgrid/accessor.py:95-130)."""
    sizes = ds.sizes
    for fnp in metadata._pairs:
        if fnp.face in sizes and fnp.node in sizes:
            expected = get_n_faces(sizes[fnp.node], fnp.padding)
            if sizes[fnp.face] != expected:
                raise ValueError(
                    f"Face dimension {fnp.face!r} has size {sizes[fnp.face]} but padding "
                    f"{fnp.padding.value!r} with {sizes[fnp.node]} nodes implies {expected}."
                )


# ---------------------------------------------------------------------------
# ``ds.sgrid`` accessor (reference _sgrid/accessor.py:12-92)
# ---------------------------------------------------------------------------


class SgridAccessor:
    """``ds.sgrid`` accessor: SGRID-aware metadata/rename/paired-isel.

    Mirror of the reference's xarray dataset accessor
    (_sgrid/accessor.py:13-92). Works on both xrlite datasets (always —
    wired as a property on xrlite.Dataset) and real xarray datasets
    (registered via ``xr.register_dataset_accessor`` when xarray is
    importable; this container ships without it).
    """

    def __init__(self, xarray_obj):
        self._ds = xarray_obj

    @property
    def metadata(self):
        return parse_sgrid_metadata(self._ds)

    def rename(self, name_dict: dict) -> "object":
        """Rename variables/dims AND the attached SGRID metadata
        (reference accessor.py:25-33)."""
        return rename_sgrid_dataset(self._ds, name_dict)

    def isel(self, indexers: dict | None = None, **indexers_kwargs):
        """Padding-aware paired selection over node/face dims
        (reference accessor.py:46-92)."""
        return sgrid_isel(self._ds, indexers, **indexers_kwargs)

    def assert_consistent(self) -> None:
        assert_metadata_ds_consistency(self._ds, self.metadata)


def register_xarray_accessor() -> bool:
    """Register ``Dataset.sgrid`` on REAL xarray when importable.

    Returns True when registered (or already present), False when xarray
    is absent (this container). Called at package import
    (parcels_tpu_torch/__init__.py) so user code written against the
    reference's ``ds.sgrid`` API ports unchanged wherever xarray exists.
    """
    try:
        import xarray as _xr
    except ImportError:
        return False
    if hasattr(_xr.Dataset, "sgrid"):
        return True
    _xr.register_dataset_accessor("sgrid")(SgridAccessor)
    return True
