"""Quickstarts 01, 02 and 05 (BASELINE configs 1, 2 and 5) through the port.

Each python block of ``docs/quickstarts/01_stationary_eddy.md`` and
``02_moving_eddies.md`` runs with the port in place of the JAX package, on
the CPU, as ``tests/test_torch_curvilinear.py`` runs 04 and
``tests/test_torch_diffusion.py`` runs 03: the package name substituted,
``device="cpu"`` passed to the fieldset and the output path moved under the
test's directory. The docs stay as they are; their own asserts are the
checks (01: the ring's radius within 1e-2 after half a day, every id
written; 02: RK4 on the closed form at rtol 1e-5, RK45 at 1e-4). Then the
port's final positions are held to the JAX package's, run from the same
blocks, at rtol 1e-5.
"""

import pathlib
import re

import numpy as np
import pytest

from parcels_tpu_torch.parallel._ranks import RankPool

DOCS = pathlib.Path(__file__).resolve().parents[1] / "docs" / "quickstarts"


def _run(doc, port, tmp_path):
    tmp_path.mkdir(exist_ok=True)
    blocks = re.findall(r"```python\n(.*?)```", doc.read_text(), flags=re.S)
    assert blocks
    ns: dict = {}
    for i, block in enumerate(blocks):
        code = block.replace("/tmp/", f"{tmp_path}/")
        if port:
            code = re.sub(r"\bparcels_tpu\b", "parcels_tpu_torch", code)
            code = code.replace('FieldSet.from_sgrid_conventions(ds, mesh="flat")',
                                'FieldSet.from_sgrid_conventions(ds, mesh="flat", device="cpu")')
            # the CPU has no device memory limit: budget against the card's 80 GB
            code = code.replace("memory_report(particles=100_000, bands=8)",
                                "memory_report(particles=100_000, bands=8, device_bytes=80 << 30)")
        exec(compile(code, f"{doc.name}[block {i}]", "exec"), ns)  # noqa: S102
    return ns


@pytest.mark.parametrize("name, sets", [("01_stationary_eddy", ("pset",)),
                                        ("02_moving_eddies", ("pset", "pset45"))])
def test_quickstart_through_the_port(tmp_path, name, sets):
    doc = DOCS / f"{name}.md"
    port = _run(doc, True, tmp_path / "port")
    assert type(port["fieldset"]).__module__.startswith("parcels_tpu_torch")
    assert str(port["fieldset"].device) == "cpu"
    ref = _run(doc, False, tmp_path / "jax")
    for key in sets:
        order_p = np.argsort(port[key].particle_id)
        order_j = np.argsort(np.asarray(ref[key].particle_id))
        for var in ("x", "y"):
            np.testing.assert_allclose(getattr(port[key], var)[order_p],
                                       np.asarray(getattr(ref[key], var))[order_j], rtol=1e-5)


def quickstart_on_a_rank(doc, tmp):
    ns = _run(pathlib.Path(doc), True, pathlib.Path(tmp))
    order = np.argsort(ns["pset2"].particle_id)
    return {"y": ns["pset2"].y[order], "x": ns["pset2"].x[order], "n": len(ns["pset2"]),
            "ranks": ns["pset2"].last_run_stats["ranks"],
            "migrated": ns["pset"].last_run_stats["migrated_lanes"],
            "loads": ns["fieldset"].window_stats["loads"]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield pool
    pool.close()


def test_quickstart_05_over_four_ranks(ranks, tmp_path):
    doc = DOCS / "05_global_scaling.md"
    outs = ranks.run(__name__, "quickstart_on_a_rank", timeout=240, doc=str(doc),
                     tmp=str(tmp_path / "port"))
    for o in outs:
        assert o["n"] == 1000 and o["ranks"] == 4 and o["migrated"] > 0 and o["loads"] >= 2
        np.testing.assert_array_equal(o["y"], outs[0]["y"])
    ref = _run(doc, False, tmp_path / "jax")
    order = np.argsort(np.asarray(ref["pset2"].particle_id))
    for var in ("x", "y"):
        np.testing.assert_allclose(outs[0][var], np.asarray(getattr(ref["pset2"], var))[order],
                                   rtol=1e-5)
