"""The port's support modules against parcels_tpu: public names, ``_repr``,
``profiling`` (torch.profiler), ``tutorial``, ``_v3to4``, ``_decorators``,
``_strategies`` (hypothesis, few examples), the ``ds.sgrid`` accessor and
the property tests of ``tests/test_properties.py``, same inputs through both
packages. Exact comparisons throughout (the same host code), except the
1-D search, held to the JAX package's bracket at its f32 positions.
"""

import importlib
import inspect
import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

import parcels_tpu as jp
import parcels_tpu_torch as tp
from parcels_tpu import _repr as jrepr
from parcels_tpu import _sgrid as jsgrid
from parcels_tpu import tutorial as jtutorial
from parcels_tpu._core.index_search import search_1d as j_search_1d
from parcels_tpu_torch import _repr as trepr
from parcels_tpu_torch import _sgrid as tsgrid
from parcels_tpu_torch import tutorial as ttutorial
from parcels_tpu_torch._core.index_search import search_1d as t_search_1d
from parcels_tpu_torch._strategies import paddings, sgrid3d_metadata, sgrid_dataset, sgrid_metadata


@pytest.mark.parametrize("module", ["", "convert", "datasets", "kernels", "interpolators", "io",
                                    "parallel"])
def test_public_names_equal_the_reference(module):
    """The port's ``__all__`` equals parcels_tpu's, top level and in each
    public module (``state_from_numpy``, the port's bridge from the JAX
    package's state, is its one extra name); ``parallel`` no longer raises:
    a one-rank particle mesh builds where a process has no process group."""
    suffix = f".{module}" if module else ""
    j = importlib.import_module("parcels_tpu" + suffix)
    t = importlib.import_module("parcels_tpu_torch" + suffix)
    assert set(t.__all__) - {"state_from_numpy"} == set(j.__all__)
    for name in t.__all__:
        assert hasattr(t, name), name
    if not module:
        from parcels_tpu_torch.parallel import ParticleMesh

        assert ParticleMesh(n_devices=1, devices="cpu").n == 1


def test_sectioned_repr_functions_equal_reference():
    sections = [("alpha", ["a1", "a2\n  more"]), ("empty", []), ("beta", ["b<&>"])]
    for title in ("Thing", "T<x>"):
        assert trepr.format_sections(title, sections) == jrepr.format_sections(title, sections)
        assert trepr.html_sections(title, sections) == jrepr.html_sections(title, sections)


def test_profiling_trace_names_the_annotated_region(tmp_path):
    """``trace`` writes a Chrome/Perfetto trace holding the ``annotate``
    region and the run's operations; ``last_run_stats`` is filled."""
    fs = tp.FieldSet.from_sgrid_conventions(tp.datasets.moving_eddy_dataset(), mesh="flat",
                                            device="cpu")
    pset = tp.ParticleSet(fs, x=[12000.0], y=[12500.0], t=[0.0])
    logdir = tmp_path / "trace"
    with tp.profiling.trace(str(logdir)) as prof:
        with tp.profiling.annotate("advect"):
            pset.execute(tp.AdvectionRK4, dt=np.timedelta64(5, "m"),
                         runtime=np.timedelta64(30, "m"))
    with open(logdir / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "advect" in names
    assert any(str(n).startswith("aten::") for n in names)
    assert any(e.key == "advect" for e in prof.key_averages())
    stats = pset.last_run_stats
    assert stats["chunks"] >= 1 and stats["particles"] == 1 and stats["particle_steps_per_s"] > 0


def test_profiling_trace_keeps_the_reference_signature_and_refuses_a_link(tmp_path):
    """``trace`` takes the JAX package's parameters; a Perfetto link, which
    the port does not serve, raises instead of being ignored."""
    assert inspect.signature(tp.profiling.trace) == inspect.signature(jp.profiling.trace)
    with pytest.raises(NotImplementedError, match="create_perfetto_link"):
        with tp.profiling.trace(str(tmp_path / "trace"), create_perfetto_link=True):
            pass
    assert not (tmp_path / "trace").exists()


@pytest.mark.parametrize("name", sorted(jtutorial.list_datasets()))
def test_tutorial_datasets_equal_reference(name):
    from tests.test_torch_convert import assert_same_dataset

    assert ttutorial.list_datasets() == jtutorial.list_datasets()
    kw = {"variant": "outer"} if name == "padded_variant" else {}
    if name == "moi_like":
        kw = dict(xdim=24, ydim=16, zdim=3)
    assert_same_dataset(ttutorial.open_dataset(name, **kw), jtutorial.open_dataset(name, **kw))
    with pytest.raises(ValueError, match="Unknown tutorial dataset"):
        ttutorial.open_dataset("bogus")


def test_v3to4_and_deprecation_like_reference():
    import warnings

    from parcels_tpu._decorators import deprecated as j_deprecated
    from parcels_tpu._v3to4 import patch_dataset_v4_compat as j_patch
    from parcels_tpu_torch import xrlite as txr
    from parcels_tpu_torch._decorators import deprecated
    from parcels_tpu_torch._v3to4 import patch_dataset_v4_compat

    ds = txr.Dataset({"U": (("x",), np.zeros(3), {"Unit": "m/s"})},
                     coords={"x": (("x",), np.arange(3.0), {"Unit": "m"})})
    out = patch_dataset_v4_compat(ds)
    assert out["U"].attrs == {"units": "m/s"} and out["x"].attrs == {"units": "m"}
    assert j_patch is not patch_dataset_v4_compat
    msgs = []
    for dec in (deprecated, j_deprecated):
        @dec("Use new_fn instead.")
        def old_fn(a):
            """Old."""
            return a * 2

        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            assert old_fn(3) == 6
        assert "deprecated" in old_fn.__doc__
        msgs.append([str(w.message) for w in rec if issubclass(w.category, DeprecationWarning)])
    assert msgs[0] == msgs[1] and msgs[0]


@given(sgrid_metadata())
@settings(max_examples=15, deadline=None)
def test_strategy_metadata_roundtrips_in_both_packages(meta):
    attrs = meta.to_attrs()
    assert tsgrid.SGrid2DMetadata.from_attrs(attrs) == meta
    assert jsgrid.SGrid2DMetadata.from_attrs(attrs).to_attrs() == attrs


@given(sgrid3d_metadata())
@settings(max_examples=10, deadline=None)
def test_strategy_3d_metadata_roundtrips_in_both_packages(meta):
    attrs = meta.to_attrs()
    assert tsgrid.SGrid3DMetadata.from_attrs(attrs) == meta
    assert jsgrid.SGrid3DMetadata.from_attrs(attrs).to_attrs() == attrs


@given(sgrid_dataset())
@settings(max_examples=8, deadline=None)
def test_strategy_dataset_parses_in_both_packages(ds):
    meta = tsgrid.parse_sgrid_metadata(ds)
    tsgrid.assert_metadata_ds_consistency(ds, meta)
    assert jsgrid.SGrid2DMetadata.from_attrs(meta.to_attrs()).to_attrs() == meta.to_attrs()


@given(st.integers(min_value=2, max_value=10_000), paddings)
@settings(max_examples=25, deadline=None)
def test_face_node_counts_equal_reference(n_nodes, padding):
    jpad = jsgrid.Padding(padding.value)
    nf = tsgrid.get_n_faces(n_nodes, padding)
    assert nf == jsgrid.get_n_faces(n_nodes, jpad)
    assert tsgrid.get_n_nodes(nf, padding) == n_nodes


@given(st.integers(min_value=0, max_value=10**6), st.integers(min_value=1, max_value=10**6),
       st.integers(min_value=0, max_value=10**6), st.integers(min_value=1, max_value=10**6))
@settings(max_examples=25, deadline=None)
def test_time_intervals_equal_reference(a0, al, b0, bl):
    base = np.datetime64("2000-01-01", "ns")
    out = []
    for mod in (jp, tp):
        t1 = mod.TimeInterval(base + np.timedelta64(a0, "s"), base + np.timedelta64(a0 + al, "s"))
        t2 = mod.TimeInterval(base + np.timedelta64(b0, "s"), base + np.timedelta64(b0 + bl, "s"))
        i12 = t1.intersection(t2)
        assert i12 == t2.intersection(t1)
        out.append((t1.time_length_as_flt, (t1.left + np.timedelta64(al // 2, "s")) in t1,
                    None if i12 is None else (i12.left, i12.right)))
    assert out[0] == out[1]


@given(st.lists(st.floats(min_value=-1e6, max_value=1e6, allow_nan=False), min_size=2,
                max_size=50, unique=True),
       st.floats(min_value=-1e6, max_value=1e6, allow_nan=False))
@settings(max_examples=40, deadline=None)
def test_search_1d_brackets_like_reference(arr, q):
    arr = np.sort(np.asarray(arr, dtype=np.float64))
    if np.any(np.diff(arr.astype(np.float32)) <= 1e-6):
        return
    ji, jb = j_search_1d(jnp.asarray(arr), jnp.asarray([q]))
    ti, tb = t_search_1d(torch.as_tensor(arr.astype(np.float32)),
                         torch.as_tensor(np.float32([q])))
    assert int(ti[0]) == int(ji[0])
    if int(ti[0]) >= 0:
        assert -1e-6 <= float(tb[0]) <= 1 + 1e-6


def test_sgrid_accessor_and_registration():
    """``ds.sgrid`` on the port's datasets; ``register_xarray_accessor``
    ran at import and is a no-op without xarray."""
    ds = tp.datasets.simple_UV_dataset(dims=(2, 2, 8, 8), mesh="flat")
    acc = ds.sgrid
    acc.assert_consistent()
    assert acc.isel(XC=slice(0, 4)).sizes["XC"] == 4
    ren = acc.rename({"U": "Uvel"})
    assert "Uvel" in ren.data_vars and "U" not in ren.data_vars
    assert tsgrid.register_xarray_accessor() in (False, True)
    assert "register_xarray_accessor" not in vars(tp)
    pad = tp.datasets.padded_variant_dataset("right")
    assert str(tsgrid.parse_sgrid_metadata(pad)) == str(jsgrid.parse_sgrid_metadata(
        jp.datasets.padded_variant_dataset("right")))


def test_memory_report_reads_the_cards_size_only_on_a_card():
    """On the CPU the report has no device limit (never a TPU's 16 GiB);
    on a card it reads the card's total memory."""
    fs = tp.FieldSet.from_sgrid_conventions(tp.datasets.moving_eddy_dataset(), mesh="flat",
                                            device="cpu")
    rep = fs.memory_report(particles=10)
    assert rep["device_bytes"] is None and rep["fits"] is None
    assert rep["total"] < 16 * 2**30
    if torch.cuda.is_available():  # pragma: no cover - the card's machine
        gpu = tp.FieldSet.from_sgrid_conventions(tp.datasets.moving_eddy_dataset(), mesh="flat")
        total = torch.cuda.get_device_properties(0).total_memory
        assert gpu.memory_report()["device_bytes"] == total
