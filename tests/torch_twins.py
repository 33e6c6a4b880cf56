"""Shared pieces of the port's behaviour-tier parity tests.

Each ``tests/test_torch_<tier>.py`` runs the cases of the JAX package's
``tests/test_<tier>.py`` through both packages on the same inputs: the JAX
package on the CPU and the port on the CPU (``device="cpu"``), then holds
the port to the JAX package. This module builds the two packages' twins of
a fieldset and compares what the two runs give back: particle sets and
Parquet trajectory files.
"""

import numpy as np

import parcels_tpu as jp
import parcels_tpu.datasets as jd
import parcels_tpu_torch as tp
import parcels_tpu_torch.datasets as td

PACKAGES = (jp, tp)


def datasets(mod):
    return jd if mod is jp else td


def sgrid(mod, ds, mesh="flat"):
    """``FieldSet.from_sgrid_conventions``; the port's on the CPU."""
    kw = {} if mod is jp else {"device": "cpu"}
    return mod.FieldSet.from_sgrid_conventions(ds, mesh=mesh, **kw)


def ugrid(mod, ds, mesh="flat"):
    kw = {} if mod is jp else {"device": "cpu"}
    return mod.FieldSet.from_ugrid_conventions(ds, mesh=mesh, **kw)


def eddy(mod):
    """The moving eddy (``tests/test_engine.py:_eddy_fs``)."""
    return sgrid(mod, datasets(mod).moving_eddy_dataset())


def uniform_flow(mod, u=1.0, v=0.0, mesh="flat", dims=(2, 2, 20, 20)):
    """``tests/conftest.py:uniform_flow_fieldset`` in either package."""
    ds = datasets(mod).simple_UV_dataset(dims=dims, mesh=mesh)
    ds["U"].values[:] = u
    ds["V"].values[:] = v
    return sgrid(mod, ds, mesh)


def twins(**pairs):
    """``{name: {jp: kernel, tp: kernel}}`` from ``name=(jax_kernel,
    torch_kernel)``; each kernel takes ``name`` as its ``__name__``, which
    the trajectory file's ``parcels_kernels`` metadata records."""
    for name, pair in pairs.items():
        for f in pair:
            f.__name__ = f.__qualname__ = name
    return {name: dict(zip(PACKAGES, pair)) for name, pair in pairs.items()}


def raised(fn):
    """The exception ``fn()`` raises (the test fails if it raises none)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return e
    raise AssertionError(f"{fn} raised nothing")


def assert_same_error(jerr, terr):
    """The port raised the JAX package's exception: the same built-in type,
    or the port's copy of the JAX package's class."""
    jt, tt = type(jerr), type(terr)
    assert tt.__name__ == jt.__name__, (jerr, terr)
    assert tt.__module__.replace("parcels_tpu_torch", "parcels_tpu") == jt.__module__, (jt, tt)


def assert_same_sets(jset, tset, rtol, atol=0.0, names=()):
    """Equal live-lane counts, particle ids and states; the clock, the
    positions and ``names`` within ``rtol``/``atol``."""
    assert len(tset) == len(jset)
    np.testing.assert_array_equal(tset.particle_id, jset.particle_id)
    np.testing.assert_array_equal(tset.state, jset.state)
    for name in ("t", "z", "y", "x", *names):
        np.testing.assert_allclose(getattr(tset, name), getattr(jset, name), rtol=rtol,
                                   atol=atol, err_msg=name)


def _meta(metadata):
    return {k.decode(): v.decode() for k, v in (metadata or {}).items()}


def assert_same_files(jpath, tpath, rtol, atol=0.0):
    """Two Parquet trajectory files written from the same run: equal columns,
    types, file and column metadata (kernels, version, CF ``units`` and
    ``calendar``), row counts and per-``t`` particle sets; the values within
    ``rtol``/``atol``; and equal times once decoded."""
    import pyarrow.parquet as pq

    jt, tt = pq.read_table(jpath), pq.read_table(tpath)
    assert tt.schema.names == jt.schema.names
    assert [f.type for f in tt.schema] == [f.type for f in jt.schema]
    assert _meta(tt.schema.metadata) == _meta(jt.schema.metadata)
    for f in jt.schema:
        assert _meta(tt.schema.field(f.name).metadata) == _meta(f.metadata), f.name
    assert tt.num_rows == jt.num_rows
    jdf, tdf = (t.to_pandas().sort_values(["t", "particle_id"], kind="stable")
                .reset_index(drop=True) for t in (jt, tt))
    for t in np.unique(jdf["t"]):
        assert set(tdf.particle_id[tdf.t == t]) == set(jdf.particle_id[jdf.t == t]), t
    for name in jt.schema.names:
        np.testing.assert_allclose(tdf[name].to_numpy(), jdf[name].to_numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)
    jdec, tdec = (_by_time(m.read_particlefile(p), table)
                  for m, p, table in ((jp, jpath, jt), (tp, tpath, tt)))
    assert [_time_key(v) for v in tdec["t"]] == [_time_key(v) for v in jdec["t"]]
    return jdec, tdec


def _by_time(df, table):
    """A decoded file's rows in the order of their raw seconds and ids
    (``table`` is the raw file, row for row)."""
    order = np.lexsort((table.column("particle_id").to_numpy(), table.column("t").to_numpy()))
    return df.iloc[order].reset_index(drop=True)


def _time_key(v):
    """A decoded time, comparable across the packages (each has its own
    ``CFDatetime`` class)."""
    if hasattr(v, "calendar"):
        return type(v).__name__, v.calendar, v.isoformat()
    return v
