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

__all__ = ["KERNEL_SOURCES", "build_all", "build_file", "library", "load", "load_symbol"]

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
        [_P, _I, _I, _I, _I] + [_P] * 10 + [_P] * 9 + [_I] * 10 + [_P, _P, _P],
    ),
    "fused_rk4": (
        "fused_rk4.cu",
        "fused_rk4_launch",
        [_P, _P, _P, _P, ctypes.c_longlong, _F, _F, _F, _P, _P],
    ),
    "flat_rk4": (
        "flat_rk4.cu",
        "flat_rk4_launch",
        [_P, _P, _P, _P, ctypes.c_longlong, _P],
    ),
    "cgrid_repair": (
        "cgrid_repair.cu",
        "cgrid_repair_launch",
        [_P, _P],
    ),
    "cgrid_stage": (
        "cgrid_stage.cu",
        "cgrid_stage_launch",
        [_I, _P, _P],
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
    return _keyed(name, CSRC / KERNEL_SOURCES[name][0])


def _keyed(tag: str, src: Path) -> Path:
    """The library of ``src``, keyed by the flags, the source and the shared headers."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{tag}_{h.hexdigest()[:16]}.so"


def _build(jobs) -> float:
    """Compile (tag, source, library) jobs in parallel, one nvcc each;
    returns the wall seconds. Raises if any fails."""
    import time

    t0 = time.perf_counter()
    if not jobs:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for tag, src, out in jobs:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)]
        procs.append((tag, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for tag, out, tmp, p in procs:
        log, _ = p.communicate()
        BUILD_LOG[tag] = log
        if p.returncode != 0:
            failed.append(f"{tag}:\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def build_all(names=None) -> float:
    """Build every missing library in parallel; returns the wall seconds."""
    names = list(KERNEL_SOURCES) if names is None else list(names)
    return _build([(n, CSRC / KERNEL_SOURCES[n][0], _lib_path(n)) for n in names
                   if not _lib_path(n).exists()])


def build_file(tag: str, src) -> Path:
    """Build a kernel source at any path (an earlier version of a kernel,
    for a reading beside the current one) into its own library; its
    compiler output goes to ``BUILD_LOG[tag]``."""
    src = Path(src).resolve()
    out = _keyed(tag, src)
    if not out.exists():
        _build([(tag, src, out)])
    return out


def library(name: str) -> Path:
    """The library of kernel ``name``, building it if needed."""
    path = _lib_path(name)
    if not path.exists():
        build_all([name])
    return path


def load(name: str):
    """The C launcher of kernel ``name``, building its library if needed."""
    fn = _LOADED.get(name)
    if fn is None:
        _, sym, argtypes = KERNEL_SOURCES[name]
        fn = load_symbol(library(name), sym, argtypes)
        _LOADED[name] = fn
    return fn


def load_symbol(path: Path, sym: str, argtypes):
    """A C launcher ``sym`` of the library at ``path``, returning an int."""
    fn = getattr(ctypes.CDLL(str(path)), sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
