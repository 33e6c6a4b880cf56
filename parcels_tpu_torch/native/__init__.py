"""Native (C++) host-side mesh preprocessing, compiled on demand by g++ and bound with ctypes.

``ux_native.cpp`` builds the face-adjacency table and the exact coverage
raster of a triangular mesh, once per grid at ingest. The library is built
into ``build/native/`` at the root of the checkout, keyed by a hash of the
source and the flags, so an edited source rebuilds; it is built for the
generic x86-64 target, so a copy of the checkout loads it on another host.
Without ``g++`` the entry points return None and ``_core/uxgrid.py`` runs
its numpy versions, which give the same tables (many minutes at FESOM2
scale).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["build_face_adjacency", "get_lib", "rasterize_faces"]

_SRC = Path(__file__).resolve().parent / "ux_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _compile() -> Path | None:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"libux_native_{h}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return None
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, building it at first use; None without g++."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _compile()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.build_face_adjacency.argtypes = [i32p, ctypes.c_int64, i32p]
        lib.build_face_adjacency.restype = None
        lib.rasterize_faces.argtypes = [
            f64p, f64p, i32p, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_int64, ctypes.c_int64, i32p,
        ]
        lib.rasterize_faces.restype = None
        _LIB = lib
        return _LIB


def build_face_adjacency(conn: np.ndarray) -> np.ndarray | None:
    """Edge-neighbour table: ``adj[f, k]`` is the face across the edge
    opposite node k of face f (-1 on the boundary); None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    if conn.ndim != 2 or conn.shape[1] != 3:
        raise ValueError(f"conn must be (n_face, 3); got {conn.shape}")
    adj = np.empty_like(conn)
    lib.build_face_adjacency(conn, conn.shape[0], adj)
    return adj


def rasterize_faces(node_lon, node_lat, conn, lat_min: float, lon_min: float,
                    step_y: float, step_x: float, ny: int, nx: int) -> np.ndarray | None:
    """Exact coverage raster: the first face holding each cell centre, else
    -1; None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    node_lon = np.ascontiguousarray(node_lon, dtype=np.float64)
    node_lat = np.ascontiguousarray(node_lat, dtype=np.float64)
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    if conn.ndim != 2 or conn.shape[1] != 3 or node_lon.shape != node_lat.shape:
        raise ValueError("conn must be (n_face, 3) and node_lon/node_lat of one shape")
    if conn.size and (conn.min() < 0 or conn.max() >= node_lon.shape[0]):
        raise ValueError("conn holds a node id outside the node arrays")
    tbl = np.full((ny, nx), -1, dtype=np.int32)
    lib.rasterize_faces(node_lon, node_lat, conn, conn.shape[0],
                        float(lat_min), float(lon_min), float(step_y), float(step_x),
                        int(ny), int(nx), tbl)
    return tbl
