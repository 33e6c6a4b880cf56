"""The JAX package's trajectory-file tier (``tests/test_particlefile.py``)
through both packages.

Each case runs the same inputs through ``parcels_tpu`` and the port (on the
CPU). Where the JAX test expects an error, the port raises the same type
and message pattern. Where it writes a file, both packages write Parquet
from the same run and the two files are held equal (``torch_twins.
assert_same_files``): columns, types, file and column metadata (kernels,
version, CF ``units`` and ``calendar``), row counts, the particles at each
output time, the values at the JAX test's own tolerance (rtol 1e-6) and the
decoded times. The JAX test's own assertions run on both files. Kernels
that call ``jnp.where`` have ``torch.where`` twins beside them.
"""

from datetime import datetime, timedelta

import jax.numpy as jnp
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

import parcels_tpu as jp
import parcels_tpu_torch as tp
from torch_twins import PACKAGES, assert_same_error, assert_same_files, assert_same_sets
from torch_twins import datasets, eddy, raised, sgrid, twins, uniform_flow

H1 = np.timedelta64(1, "h")
M30 = np.timedelta64(30, "m")


@pytest.fixture(scope="module")
def flows():
    """``uniform_flow_fieldset()`` (u = 1 m/s) a package, shared by the cases
    that run on it unchanged."""
    return {m: uniform_flow(m) for m in PACKAGES}


def _paths(tmp_path, name="t"):
    return {m: tmp_path / f"{name}_{m.__name__}.parquet" for m in PACKAGES}


def _run_both(tmp_path, make_set, kernels, dt, runtime, outputdt=H1, **pf_kw):
    """One run a package with a ParticleFile; the sets and the file paths."""
    paths, sets = _paths(tmp_path), {}
    for m in PACKAGES:
        pset = make_set(m)
        pf = m.ParticleFile(paths[m], outputdt=outputdt, mode="w", **pf_kw)
        pset.execute(kernels(m), dt=dt, runtime=runtime, output_file=pf)
        pf.close()
        sets[m] = pset
    return sets, paths


def _frames(paths, **kw):
    return {m: m.read_particlefile(paths[m], **kw) for m in PACKAGES}


# -- construction errors ------------------------------------------------------

CTOR_ERRORS = {
    # test_particlefile.py:26-48: the arguments (relative to tmp_path) and
    # the JAX test's match= pattern
    "zero_outputdt": (lambda d: (d / "a.parquet", np.timedelta64(0, "s")), "positive"),
    "not_parquet": (lambda d: (d / "a.zarr", H1), "parquet"),
    "outputdt_string": (lambda d: (d / "a.parquet", "1 hour"), "outputdt"),
    "missing_folder": (lambda d: (d / "nope" / "a.parquet", H1), "Folder"),
}


@pytest.mark.parametrize("case", sorted(CTOR_ERRORS))
def test_construction_errors_match_reference(case, tmp_path):
    args, match = CTOR_ERRORS[case]
    errs = {m: raised(lambda m=m: m.ParticleFile(*args(tmp_path))) for m in PACKAGES}
    assert_same_error(errs[jp], errs[tp])
    assert isinstance(errs[tp], ValueError)
    for e in errs.values():
        assert match in str(e), e


def test_existing_path_needs_w_mode(tmp_path):
    for m in PACKAGES:
        p = tmp_path / f"a_{m.__name__}.parquet"
        p.write_bytes(b"")
        err = raised(lambda: m.ParticleFile(p, outputdt=H1))
        assert isinstance(err, ValueError) and "exists" in str(err)
        m.ParticleFile(p, outputdt=H1, mode="w")
        assert not p.exists()  # mode="w" removed the old file


@pytest.mark.parametrize(
    "outputdt, ok",
    [
        (np.timedelta64(5, "s"), True),
        (timedelta(seconds=2), True),
        (5.0, True),
        (np.datetime64("2001-01-02T00:00:00"), False),
        (datetime(2000, 1, 2, 0, 0, 0), False),
        (-np.timedelta64(5, "s"), False),
    ],
)
def test_outputdt_types(outputdt, ok, tmp_path):
    if ok:
        dts = [m.ParticleFile(tmp_path / "t.parquet", outputdt=outputdt).outputdt
               for m in PACKAGES]
        assert dts[0] > 0 and dts[1] == dts[0]
    else:
        errs = [raised(lambda m=m: m.ParticleFile(tmp_path / "t.parquet", outputdt=outputdt))
                for m in PACKAGES]
        assert_same_error(*errs)
        assert isinstance(errs[1], ValueError)


def test_particlefile_readonly_attrs(tmp_path):
    for m in PACKAGES:
        pf = m.ParticleFile(tmp_path / f"ro_{m.__name__}.parquet", outputdt=np.timedelta64(1, "s"),
                            mode="w")
        for name in ("path", "outputdt"):
            with pytest.raises(AttributeError):
                setattr(pf, name, "something")


# -- files written by both packages ------------------------------------------


def test_output_cadence_and_columns(tmp_path):
    sets, paths = _run_both(
        tmp_path, lambda m: m.ParticleSet(eddy(m), x=[12000.0, 15000.0], y=[12500.0, 9000.0],
                                          t=[0.0, 0.0]),
        lambda m: m.AdvectionRK4, np.timedelta64(10, "m"), np.timedelta64(2, "h"), outputdt=M30)
    for df in _frames(paths, decode_times=False).values():
        assert len(df) == 10
        assert set(df.columns) >= {"t", "z", "y", "x", "particle_id"}
        times = np.sort(df[df.particle_id == 0]["t"].to_numpy())
        np.testing.assert_allclose(times, [0, 1800, 3600, 5400, 7200])
    assert_same_sets(sets[jp], sets[tp], rtol=1e-6)
    assert_same_files(paths[jp], paths[tp], rtol=1e-6)


def test_time_decoding_with_datetime_interval(tmp_path):
    sets, paths = _run_both(
        tmp_path, lambda m: m.ParticleSet(uniform_flow(m, u=1.0, v=0.0), x=[1e5], y=[1e5],
                                          t=[np.timedelta64(0, "s")]),
        lambda m: m.AdvectionEE, M30, np.timedelta64(2, "h"))
    for df in _frames(paths).values():
        assert np.issubdtype(df["t"].dtype, np.datetime64)
        assert df["t"].min() == np.datetime64("2000-01-01")
    jdec, tdec = assert_same_files(paths[jp], paths[tp], rtol=1e-6)
    assert tdec["t"].dtype == jdec["t"].dtype


def Age(particles, fieldset):  # noqa: N802
    particles.age = particles.age + particles.dt


def test_custom_variable_written_and_to_write_false_not(flows, tmp_path):
    def make(m):
        pclass = m.Particle.add_variable(m.Variable("age", dtype=np.float32, initial=0.0))
        pclass = pclass.add_variable(m.Variable("hidden", dtype=np.float32, initial=7.0,
                                                to_write=False))
        return m.ParticleSet(flows[m], pclass=pclass, x=[1e5], y=[1e5], t=[0.0])

    sets, paths = _run_both(tmp_path, make, lambda m: [m.AdvectionEE, Age], M30,
                            np.timedelta64(2, "h"))
    for df in _frames(paths, decode_times=False).values():
        assert "age" in df.columns and "hidden" not in df.columns
        assert df["age"].max() == 7200.0
    assert_same_sets(sets[jp], sets[tp], rtol=1e-6, names=("age", "hidden"))
    assert_same_files(paths[jp], paths[tp], rtol=1e-6)


def test_metadata_includes_kernels_and_version(tmp_path):
    sets, paths = _run_both(
        tmp_path, lambda m: m.ParticleSet(eddy(m), x=[12000.0], y=[12500.0], t=[0.0]),
        lambda m: m.AdvectionRK4, M30, H1)
    for path in paths.values():
        meta = {k.decode(): v.decode() for k, v in pq.read_schema(path).metadata.items()}
        assert meta["feature_type"] == "trajectory"
        assert "AdvectionRK4" in meta["parcels_kernels"]
        assert "parcels_version" in meta
    assert_same_files(paths[jp], paths[tp], rtol=1e-6)


def DoNothing(particles, fieldset):  # noqa: N802
    pass


@pytest.mark.parametrize("compression", ["zstd", "snappy", None])
def test_compression_options(compression, flows, tmp_path):
    sets, paths = _run_both(
        tmp_path, lambda m: m.ParticleSet(flows[m], x=[1e5], y=[1e5], t=[0.0]),
        lambda m: m.AdvectionEE, M30, np.timedelta64(2, "h"), compression=compression)
    codecs = {}
    for m, df in _frames(paths, decode_times=False).items():
        assert len(df) == 3
        meta = pq.ParquetFile(paths[m]).metadata
        codecs[m] = {meta.row_group(g).column(c).compression
                     for g in range(meta.num_row_groups) for c in range(meta.num_columns)}
    assert codecs[tp] == codecs[jp] == {(compression or "uncompressed").upper()}
    assert_same_files(paths[jp], paths[tp], rtol=1e-6)


def test_write_dtypes(flows, tmp_path):
    import pyarrow as pa

    dtypes = [np.float32, np.float64, np.int32, np.int64, np.uint32]

    def make(m):
        pclass = m.Particle
        for d in dtypes:
            pclass = pclass.add_variable(m.Variable(f"v_{np.dtype(d).name}", dtype=d, initial=10))
        return m.ParticleSet(flows[m], pclass=pclass, x=[1e5], y=[1e5], t=[0.0])

    sets, paths = _run_both(tmp_path, make, lambda m: DoNothing, H1, H1)
    for m in PACKAGES:
        schema = pq.read_schema(paths[m])
        df = m.read_particlefile(paths[m], decode_times=False)
        for d in dtypes:
            name = f"v_{np.dtype(d).name}"
            assert schema.field(name).type == pa.from_numpy_dtype(d), name
            assert (df[name] == 10).all()
    assert_same_files(paths[jp], paths[tp], rtol=0.0)


# -- deletion and errors: kernels written for both packages ----------------------


def DeleteP0_jax(particles, fieldset):  # noqa: N802
    particles.state = jnp.where((particles.particle_id == 0) & (particles.t >= 3600.0),
                                jp.StatusCode.Delete, particles.state)


def DeleteP0_torch(particles, fieldset):  # noqa: N802
    particles.state = torch.where((particles.particle_id == 0) & (particles.t >= 3600.0),
                                  tp.StatusCode.Delete, particles.state)


def DeleteAll_jax(particles, fieldset):  # noqa: N802
    particles.state = jnp.where(particles.t >= 3600.0, jp.StatusCode.Delete, particles.state)


def DeleteAll_torch(particles, fieldset):  # noqa: N802
    particles.state = torch.where(particles.t >= 3600.0, tp.StatusCode.Delete, particles.state)


def ErrorKernel_jax(particles, fieldset):  # noqa: N802
    particles.state = jnp.where(particles.t >= 3600.0, jp.StatusCode.Error, particles.state)


def ErrorKernel_torch(particles, fieldset):  # noqa: N802
    particles.state = torch.where(particles.t >= 3600.0, tp.StatusCode.Error, particles.state)


def IncrVar_jax(particles, fieldset):  # noqa: N802
    particles.sample_var = particles.sample_var + 1.0
    particles.state = jnp.where(particles.sample_var > fieldset.maxvar,
                                jnp.int32(jp.StatusCode.Delete), particles.state)


def IncrVar_torch(particles, fieldset):  # noqa: N802
    particles.sample_var = particles.sample_var + 1.0
    particles.state = torch.where(particles.sample_var > fieldset.maxvar,
                                  tp.StatusCode.Delete, particles.state)


TWINS = twins(
    DeleteP0=(DeleteP0_jax, DeleteP0_torch),
    DeleteAll=(DeleteAll_jax, DeleteAll_torch),
    ErrorKernel=(ErrorKernel_jax, ErrorKernel_torch),
    IncrVar=(IncrVar_jax, IncrVar_torch),
)


@pytest.mark.parametrize("kernel", ["DeleteP0", "DeleteAll"])
def test_deleted_particles_stop_appearing(kernel, flows, tmp_path):
    """``test_deleted_particles_stop_appearing`` (DeleteP0) and
    ``test_remove_all_particles_file_readable`` (DeleteAll)."""
    sets, paths = _run_both(
        tmp_path, lambda m: m.ParticleSet(flows[m], x=[1e5, 1.1e5], y=[1e5, 1e5], t=[0.0, 0.0]),
        lambda m: [m.AdvectionEE, TWINS[kernel][m]], M30, np.timedelta64(4, "h"))
    for df in _frames(paths, decode_times=False).values():
        if kernel == "DeleteP0":
            counts = df.groupby("particle_id").size()
            assert counts[1] == 5
            assert counts[0] < counts[1]
        else:
            assert len(df) >= 2
    assert_same_sets(sets[jp], sets[tp], rtol=1e-6)
    assert_same_files(paths[jp], paths[tp], rtol=1e-6)


def test_readable_after_kernel_error(flows, tmp_path):
    paths, errs = _paths(tmp_path), {}
    for m in PACKAGES:
        pset = m.ParticleSet(flows[m], x=[1e5], y=[1e5], t=[0.0])
        pf = m.ParticleFile(paths[m], outputdt=H1, mode="w")
        errs[m] = raised(lambda: pset.execute([m.AdvectionEE, TWINS["ErrorKernel"][m]], dt=M30,
                                              runtime=np.timedelta64(5, "h"), output_file=pf))
        pf.close()
        assert len(m.read_particlefile(paths[m], decode_times=False)) >= 1
    assert_same_error(errs[jp], errs[tp])
    assert str(errs[tp]) == str(errs[jp])
    assert_same_files(paths[jp], paths[tp], rtol=1e-6)


def test_repeated_release_age_based_deletion(tmp_path):
    npart, maxvar = 8, 4
    paths, sets = _paths(tmp_path, "rr"), {}
    for m in PACKAGES:
        fs = uniform_flow(m, 0.0, 0.0)
        fs.add_context("maxvar", float(maxvar))
        pclass = m.Particle.add_variable(m.Variable("sample_var", initial=0.0))
        pset = m.ParticleSet(fs, pclass=pclass, x=np.zeros(npart), y=np.zeros(npart),
                             t=np.arange(1, npart + 1, dtype=np.float64))
        pf = m.ParticleFile(paths[m], outputdt=np.timedelta64(1, "s"), mode="w")
        for _ in range(npart + maxvar + 2):
            pset.execute(TWINS["IncrVar"][m], dt=np.timedelta64(1, "s"),
                         runtime=np.timedelta64(1, "s"), output_file=pf)
        pf.close()
        df = m.read_particlefile(paths[m])
        counts = df[df["sample_var"] > 0].groupby("particle_id")["sample_var"].max()
        assert (counts <= maxvar + 1).all()
        assert len(counts) == npart
        sets[m] = pset
    assert_same_sets(sets[jp], sets[tp], rtol=0.0, names=("sample_var",))
    assert_same_files(paths[jp], paths[tp], rtol=0.0)


# -- time: staggered release, backward, misaligned outputdt ---------------------------


def IncreaseAge(particles, fieldset):  # noqa: N802
    particles.age += particles.dt


def test_time_is_age_staggered_release(tmp_path):
    npart = 4
    paths, sets = _paths(tmp_path), {}
    for m in PACKAGES:
        pclass = m.Particle.add_variable(m.Variable("age", dtype=np.float64, initial=0.0))
        t0 = [np.timedelta64(i * 1800, "s") for i in range(npart)]
        pset = m.ParticleSet(uniform_flow(m, u=0.0, v=0.0), pclass=pclass, x=[1e5] * npart,
                             y=[1e5] * npart, t=t0)
        pf = m.ParticleFile(paths[m], outputdt=H1, mode="w")
        with pytest.warns(m.ParticleSetWarning, match="start time difference"):
            pset.execute(IncreaseAge, dt=M30, runtime=np.timedelta64(5, "h"), output_file=pf)
        pf.close()
        df = m.read_particlefile(paths[m], decode_times=False)
        for pid, grp in df.groupby("particle_id"):
            np.testing.assert_allclose(grp["age"].to_numpy(), grp["t"].to_numpy() - pid * 1800.0,
                                       atol=1e-6)
        sets[m] = pset
    assert_same_sets(sets[jp], sets[tp], rtol=0.0, names=("age",))
    assert_same_files(paths[jp], paths[tp], rtol=0.0)


def test_write_timebackward(tmp_path):
    def make(m):
        ds = datasets(m).simple_UV_dataset(dims=(2, 2, 20, 20), mesh="flat")
        t0 = [np.timedelta64(4 * 3600 + i * 3600, "s") for i in range(3)]
        return m.ParticleSet(sgrid(m, ds), x=[1e5] * 3, y=[1e5, 1.1e5, 1.2e5], t=t0)

    sets, paths = _run_both(tmp_path, make, lambda m: DoNothing, -H1, np.timedelta64(3, "h"))
    for df in _frames(paths, decode_times=False).values():
        assert df["particle_id"].dtype == np.int64
        assert (df.groupby("particle_id")["t"].diff().dropna() < 0).all()
    assert_same_sets(sets[jp], sets[tp], rtol=0.0)
    assert_same_files(paths[jp], paths[tp], rtol=0.0)


def TrackX(particles, fieldset):  # noqa: N802
    particles.dx += particles.dt  # 1 m/s displacement bookkeeping


def test_correct_misaligned_outputdt_dt(flows, tmp_path):
    sets, paths = _run_both(
        tmp_path, lambda m: m.ParticleSet(flows[m], x=[0.0], y=[1e5], t=[0.0]),
        lambda m: TrackX, np.timedelta64(2, "s"), np.timedelta64(11, "s"),
        outputdt=np.timedelta64(3, "s"))
    for df in _frames(paths, decode_times=False).values():
        np.testing.assert_allclose(np.sort(df["x"].to_numpy()), [0, 3, 6, 9], atol=1e-5)
        np.testing.assert_allclose(np.sort(df["t"].to_numpy()), [0, 3, 6, 9], atol=1e-9)
    assert_same_sets(sets[jp], sets[tp], rtol=1e-6)
    assert_same_files(paths[jp], paths[tp], rtol=1e-6)


def test_output_cadence_forward_exact(flows, tmp_path):
    sets, paths = _run_both(
        tmp_path, lambda m: m.ParticleSet(flows[m], x=[1e5], y=[1e5], t=[0.0]),
        lambda m: m.AdvectionRK4, np.timedelta64(5, "m"), np.timedelta64(5, "h"))
    for df in _frames(paths, decode_times=False).values():
        t = np.sort(df["t"].to_numpy())
        np.testing.assert_allclose(np.diff(t), 3600.0)
        assert t[0] == 0.0 and t[-1] == 5 * 3600.0
    assert_same_sets(sets[jp], sets[tp], rtol=1e-6)
    assert_same_files(paths[jp], paths[tp], rtol=1e-6)


def SampleKernel(particles, fieldset):  # noqa: N802
    u, v = fieldset.UV[particles]
    particles.sample = u


def test_sampling_initial_value(tmp_path):
    def make(m):
        fs = uniform_flow(m, u=2.5, v=0.0)
        pclass = m.Particle.add_variable(m.Variable("sample", dtype=np.float32, initial=np.nan))
        pset = m.ParticleSet(fs, pclass=pclass, x=[1e5], y=[1e5], t=[0.0])
        u0, _ = fs.fields["UV"].eval(np.timedelta64(0, "s"), np.array([0.0]), np.array([1e5]),
                                     np.array([1e5]))
        pset.sample = np.asarray(u0, dtype=np.float32)
        return pset

    sets, paths = _run_both(tmp_path, make, lambda m: SampleKernel, M30, np.timedelta64(2, "h"))
    for df in _frames(paths, decode_times=False).values():
        assert np.isfinite(df["sample"]).all()
        np.testing.assert_allclose(df["sample"], 2.5, rtol=1e-6)
    assert_same_sets(sets[jp], sets[tp], rtol=1e-6, names=("sample",))
    assert_same_files(paths[jp], paths[tp], rtol=1e-6)


def test_write_fieldset_without_time(tmp_path):
    def make(m):
        ds = datasets(m).peninsula_dataset()
        assert "time" not in ds.sizes
        return m.ParticleSet(sgrid(m, ds), x=[3e4], y=[25e3], t=[0.0])

    sets, paths = _run_both(tmp_path, make, lambda m: DoNothing, np.timedelta64(1, "s"),
                            np.timedelta64(1, "s"), outputdt=np.timedelta64(1, "s"))
    for path in paths.values():
        table = pq.read_table(path)
        meta = table.schema.field("t").metadata or {}
        assert meta.get(b"units", b"seconds") == b"seconds"
        assert b"calendar" not in meta
        assert table["t"].to_numpy()[-1] == 1.0
    assert_same_files(paths[jp], paths[tp], rtol=0.0)
