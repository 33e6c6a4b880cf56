"""The PyTorch port stands alone: it imports neither JAX nor parcels_tpu."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

from parcels_tpu_torch.parallel._ranks import RankPool

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "parcels_tpu_torch"


def test_import_leaves_jax_out():
    code = (
        "import sys; import parcels_tpu_torch, parcels_tpu_torch.datasets; "
        "import parcels_tpu_torch.ops.binned_sample, parcels_tpu_torch.ops._build; "
        "import parcels_tpu_torch.ops.stagecache, parcels_tpu_torch.ops.fused_rk4; "
        "import parcels_tpu_torch.ops.cgrid_repair, parcels_tpu_torch.ops.cgrid_stage; "
        "import parcels_tpu_torch.convert, parcels_tpu_torch.datasets.moi; "
        "import parcels_tpu_torch.ops.uxcol, parcels_tpu_torch.ops.uxcache; "
        "import parcels_tpu_torch._core.uxgrid, parcels_tpu_torch.native; "
        "import parcels_tpu_torch.interpolators.uxinterp, parcels_tpu_torch.datasets.unstructured; "
        "import parcels_tpu_torch.io, parcels_tpu_torch._core.windowing; "
        "import parcels_tpu_torch.profiling, parcels_tpu_torch.tutorial, parcels_tpu_torch._repr; "
        "import parcels_tpu_torch.datasets.remote, parcels_tpu_torch.datasets.circulation_models; "
        "import parcels_tpu_torch._v3to4, parcels_tpu_torch._decorators, parcels_tpu_torch._strategies; "
        "import parcels_tpu_torch._typing; "
        "bad = [m for m in ('jax', 'parcels_tpu') if m in sys.modules]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env=env, timeout=120)


def loaded_reference_modules():
    return [m for m in ("jax", "parcels_tpu") if m in sys.modules]


def test_spawned_rank_leaves_jax_out(tmp_path):
    """A rank spawned for a multi-rank run of the port (``parallel._ranks``)
    imports the port and runs it without loading JAX or parcels_tpu."""
    pool = RankPool(2, str(tmp_path))
    try:
        pool.run("torch_scaleout", "run", timeout=120, name="torch", build="uniform",
                 build_kw=dict(u=0.0, v=1.0), x=[0.0, 1e4], y=[-5e5, 5e5], runtime_s=1200,
                 dom=dict(kind="band", n=2, halo=2))
        assert pool.run(__name__, "loaded_reference_modules") == [[], []]
    finally:
        pool.close()


def test_io_imports_without_tensorstore_or_h5py():
    """The store modules import, and read zarr with numpy, on a host without
    tensorstore, h5py or JAX (as the card's machine is)."""
    code = (
        "import sys; sys.modules.update(tensorstore=None, h5py=None, jax=None); "
        "import parcels_tpu_torch, parcels_tpu_torch.io; "
        "from parcels_tpu_torch.io import netcdfstore, zarrstore; "
        "assert parcels_tpu_torch.open_raw_zarr is zarrstore.open_raw_zarr; "
        "assert parcels_tpu_torch.io.open_netcdf_dataset is netcdfstore.open_netcdf_dataset; "
        "import tempfile, os, numpy as np; "
        "from parcels_tpu_torch.datasets import moving_eddy_dataset; "
        "d = os.path.join(tempfile.mkdtemp(), 'e.zarr'); "
        "zarrstore.write_zarr_dataset(moving_eddy_dataset(), d, compressor='zlib'); "
        "u = zarrstore.open_zarr_dataset(d)['U'].values[3:5]; "
        "assert np.array_equal(u, moving_eddy_dataset()['U'].values[3:5]); "
        "bad = [m for m in ('jax', 'parcels_tpu') if sys.modules.get(m) is not None]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env=env, timeout=120)


@pytest.mark.parametrize("suffix", [".py", ".cu", ".cuh", ".cpp"])
def test_no_source_names_jax_or_the_reference_package(suffix):
    files = sorted(PKG.rglob(f"*{suffix}"))
    assert files
    for f in files:
        text = f.read_text()
        assert "import jax" not in text, f
        assert "from jax" not in text, f
        # a module path into the reference package (``parcels_tpu.ops...``)
        assert not re.search(r"\bparcels_tpu\.\w", text), f
        assert not re.search(r"\bfrom parcels_tpu import", text), f


def test_public_names_match_the_reference():
    """Every public name the port exports is a public name of parcels_tpu."""
    import parcels_tpu
    import parcels_tpu_torch

    extra = set(parcels_tpu_torch.__all__) - set(parcels_tpu.__all__) - {"state_from_numpy"}
    assert not extra, extra
