"""The PyTorch port stands alone: it imports neither JAX nor parcels_tpu."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "parcels_tpu_torch"


def test_import_leaves_jax_out():
    code = (
        "import sys; import parcels_tpu_torch, parcels_tpu_torch.datasets; "
        "import parcels_tpu_torch.ops.binned_sample, parcels_tpu_torch.ops._build; "
        "import parcels_tpu_torch.ops.stagecache, parcels_tpu_torch.ops.fused_rk4; "
        "import parcels_tpu_torch.convert, parcels_tpu_torch.datasets.moi; "
        "import parcels_tpu_torch.ops.uxcol, parcels_tpu_torch.ops.uxcache; "
        "import parcels_tpu_torch._core.uxgrid, parcels_tpu_torch.native; "
        "import parcels_tpu_torch.interpolators.uxinterp, parcels_tpu_torch.datasets.unstructured; "
        "import parcels_tpu_torch.io, parcels_tpu_torch._core.windowing; "
        "bad = [m for m in ('jax', 'parcels_tpu') if m in sys.modules]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, env=env, timeout=120)


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
