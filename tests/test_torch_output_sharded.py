"""Trajectory output of the port's multi-rank runs: one file a rank.

Mirrors tests/test_output_sharded.py over 4 gloo ranks on the CPU. Each
rank writes its own lanes to ``<stem>.<rank>.parquet``; ``read_particlefile``
reads their union. The banded run's files hold every particle at every
output time once, equal the gathered SoA at the last, and equal the
one-rank run's file at every output time (rtol 1e-6, atol 0.1 m, the JAX
tests' tolerance on this box). The union takes only names of exactly that
form, by rank number (the JAX package's glob takes any ``<stem>.*.parquet``,
``_core/particlefile.py:261``).
"""

import numpy as np
import pytest

import parcels_tpu_torch as tp
import torch_scaleout as so
from parcels_tpu_torch.parallel._ranks import RankPool

DAY = so.DAY


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield pool
    pool.close()


def test_snapshot_queue_carries_only_output_columns(tmp_path):
    """``write_snapshot`` keeps only the columns the file needs before the
    queue, not the engine's cache columns."""
    fs = so.fieldset("torch", "uniform", u=0.0, v=0.0, dims=(2, 2, 8, 8))
    pset = tp.ParticleSet(fs, x=[0.0], y=[0.0], t=[0.0])
    pf = tp.ParticleFile(tmp_path / "t.parquet", outputdt=np.timedelta64(10, "m"))
    pf.set_metadata(fs, pset._pclass, (tp.AdvectionRK4,))
    seen = {}
    pf._queue.put = lambda item: seen.update(item[0]) if item is not None else None
    fat = dict(pset._data)
    fat["_sc_key"] = fat["ei"].new_zeros((1, 4))
    fat["_uxc_u"] = fat["x"].new_zeros((1, 12))
    pf.write_snapshot(fat, 0.0)
    assert "_sc_key" not in seen and "_uxc_u" not in seen and "ei" not in seen
    for k in ("t", "dt", "_active", "x", "y", "z", "particle_id"):
        assert k in seen, k


def banded_output(path, dom, n=32):
    import os

    out = so.run("torch", "uniform", np.linspace(-8e5, 8e5, n), np.full(n, -8e5),
                 build_kw=dict(u=0.0, v=10.0, dims=(2, 2, 32, 8)), dom=dom, output=path,
                 outputdt_s=4 * 3600)
    out["files"] = sorted(os.listdir(os.path.dirname(path)))
    return out


@pytest.mark.parametrize("kind", ["band", "mesh"])
def test_multi_rank_run_writes_complete_trajectories(ranks, tmp_path, kind):
    path = tmp_path / "traj.parquet"
    dom = dict(kind="band", halo=2) if kind == "band" else dict(kind="mesh")
    outs = ranks.run(__name__, "banded_output", path=str(path), dom=dom)
    assert outs[0]["files"] == [f"traj.{r}.parquet" for r in range(4)]
    df = tp.read_particlefile(path, decode_times=False)
    n = 32
    counts = df.groupby("particle_id").size()
    assert len(counts) == n and (counts == 7).all(), counts
    assert not df.duplicated(subset=["particle_id", "t"]).any()
    last = df[df["t"] == df["t"].max()].sort_values("particle_id")
    np.testing.assert_allclose(last["y"].to_numpy(), -8e5 + 10.0 * DAY, rtol=1e-5)
    # the files' last output time is the SoA every rank gathered
    got = outs[0]
    np.testing.assert_array_equal(last["particle_id"].to_numpy(), got["particle_id"])
    np.testing.assert_array_equal(last["y"].to_numpy(), got["y"])
    np.testing.assert_array_equal(last["x"].to_numpy(), got["x"])
    # and every output time is the one-rank run's
    one_path = tmp_path / "one.parquet"
    so.run("torch", "uniform", np.linspace(-8e5, 8e5, n), np.full(n, -8e5),
           build_kw=dict(u=0.0, v=10.0, dims=(2, 2, 32, 8)), output=str(one_path),
           outputdt_s=4 * 3600)
    one = tp.read_particlefile(one_path, decode_times=False)
    a = df.sort_values(["t", "particle_id"])
    b = one.sort_values(["t", "particle_id"])
    np.testing.assert_array_equal(a["particle_id"].to_numpy(), b["particle_id"].to_numpy())
    np.testing.assert_array_equal(a["t"].to_numpy(), b["t"].to_numpy())
    for v in ("x", "y"):
        np.testing.assert_allclose(a[v].to_numpy(), b[v].to_numpy(), rtol=1e-6, atol=0.1)


def test_rank_files_are_read_by_their_exact_name(tmp_path):
    """The union reads ``traj.<rank>.parquet`` only, ranks in numeric order
    (10 after 2), and never a look-alike (``traj.old.parquet``,
    ``traj.1.bak.parquet``, ``trajx.0.parquet``)."""
    import shutil

    fs = so.fieldset("torch", "uniform", u=0.0, v=0.0, dims=(2, 2, 8, 8))
    for rank, name in ((0, "traj.0"), (2, "traj.2"), (10, "traj.10"), (7, "traj.old"),
                       (8, "traj.1.bak"), (9, "trajx.0")):
        pset = tp.ParticleSet(fs, x=[0.0], y=[0.0], t=[0.0], particle_ids=[rank])
        pf = tp.ParticleFile(tmp_path / "single.parquet", outputdt=np.timedelta64(1, "h"),
                             mode="w")
        pset.execute(tp.AdvectionRK4, dt=np.timedelta64(30, "m"),
                     runtime=np.timedelta64(1, "h"), output_file=pf)
        pf.close()
        shutil.move(tmp_path / "single.parquet", tmp_path / f"{name}.parquet")
    df = tp.read_particlefile(tmp_path / "traj.parquet", decode_times=False)
    assert df["particle_id"].tolist() == [0, 0, 2, 2, 10, 10]
