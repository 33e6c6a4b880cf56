"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc and ctypes.

Each source under ``parcels_tpu_torch/csrc`` compiles into its own shared
library with a plain C launcher, for ``sm_90a``, into ``build/kernels/`` at
the root of the checkout. Libraries are keyed by a hash of their source, the
shared headers and the flags, so an edited kernel rebuilds and an unchanged
one loads at once. All missing libraries build in parallel, one ``nvcc``
each. A missing ``nvcc`` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["KERNEL_SOURCES", "build_all", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: kernel name -> (source file, C launcher, launcher argtypes)
KERNEL_SOURCES = {
    "fold_sample": (
        "fold_sample.cu",
        "fold_sample_launch",
        [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, ctypes.c_longlong, _P],
    ),
    "slab_sample": (
        "slab_sample.cu",
        "slab_sample_launch",
        [_P, _I, _I, _I, _I] + [_P] * 10 + [_P] * 5 + [_I] * 7 + [_P],
    ),
    "fused_rk4": (
        "fused_rk4.cu",
        "fused_rk4_launch",
        [_P, _P, _P, _P, ctypes.c_longlong, _F, _F, _F, _P],
    ),
}

_LOADED: dict = {}
#: compiler output (register / shared-memory use) of the libraries built here
BUILD_LOG: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from source at first use")
    return path


def _lib_path(name: str) -> Path:
    src, _, _ = KERNEL_SOURCES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=None) -> float:
    """Build every missing library in parallel; returns the wall seconds."""
    import time

    names = list(KERNEL_SOURCES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        out = _lib_path(n)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / KERNEL_SOURCES[n][0])]
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, out, tmp, p in procs:
        log, _ = p.communicate()
        BUILD_LOG[n] = log
        if p.returncode != 0:
            failed.append(f"{n}:\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str):
    """The C launcher of kernel ``name``, building its library if needed."""
    fn = _LOADED.get(name)
    if fn is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _, sym, argtypes = KERNEL_SOURCES[name]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED[name] = fn
    return fn
