"""Quickstarts 01 and 02 (BASELINE configs 1 and 2) through the port.

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

DOCS = pathlib.Path(__file__).resolve().parents[1] / "docs" / "quickstarts"


def _run(doc, port, tmp_path):
    tmp_path.mkdir()
    blocks = re.findall(r"```python\n(.*?)```", doc.read_text(), flags=re.S)
    assert blocks
    ns: dict = {}
    for i, block in enumerate(blocks):
        code = block.replace("/tmp/", f"{tmp_path}/")
        if port:
            code = re.sub(r"\bparcels_tpu\b", "parcels_tpu_torch", code)
            code = code.replace('FieldSet.from_sgrid_conventions(ds, mesh="flat")',
                                'FieldSet.from_sgrid_conventions(ds, mesh="flat", device="cpu")')
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
