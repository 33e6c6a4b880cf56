"""The port's host-only copies stay copies of the JAX package's modules.

Each module below is the JAX package's module byte for byte once
``parcels_tpu_torch`` reads ``parcels_tpu``, so the JAX package's own cases
of it (the date math of ``tests/test_calendars.py:43-111``, the SGRID
accessor of ``tests/test_sgrid_accessor.py``, ...) hold for the port
without a rerun. ``_typing.py`` differs as written only in the lines that
name its package: its two imports and its docstring's pointer to
``CFDatetime``. A deliberate edit to a copy takes it out of this list.
"""

import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

COPIES = [
    "_core/__init__.py", "_core/calendars.py", "_core/mesh.py", "_core/options.py",
    "_core/particle.py", "_core/statuscodes.py", "_core/timeutils.py", "_core/warnings_.py",
    "_decorators.py", "_logging.py", "_sgrid.py", "_strategies.py", "_v3to4.py",
    "datasets/circulation_models.py", "xrlite.py", "_typing.py",
]


def _lines(package, module):
    return (ROOT / package / module).read_text().splitlines()


@pytest.mark.parametrize("module", COPIES)
def test_copy_equals_its_source(module):
    port = [line.replace("parcels_tpu_torch", "parcels_tpu")
            for line in _lines("parcels_tpu_torch", module)]
    assert port == _lines("parcels_tpu", module)


def test_typing_differs_only_where_it_names_its_package():
    jax_lines, port_lines = _lines("parcels_tpu", "_typing.py"), _lines("parcels_tpu_torch", "_typing.py")
    differ = [(j, t) for j, t in zip(jax_lines, port_lines, strict=True) if j != t]
    assert [t for _, t in differ] == [
        "``parcels_tpu_torch._core.calendars.CFDatetime``.",
        "from parcels_tpu_torch._core.calendars import CFDatetime",
        "from parcels_tpu_torch._sgrid import Padding",
    ]


def test_typing_exports_the_same_aliases():
    import typing

    import parcels_tpu._typing as jt
    import parcels_tpu_torch._typing as tt
    from parcels_tpu._core.calendars import CFDatetime as JCF
    from parcels_tpu._sgrid import Padding as JPad
    from parcels_tpu_torch._core.calendars import CFDatetime as TCF
    from parcels_tpu_torch._sgrid import Padding as TPad

    assert tt.__all__ == jt.__all__
    swap = {TCF: JCF, TPad: JPad}

    def args(alias):
        return [swap.get(a, a) for a in typing.get_args(alias)]

    for name in jt.__all__:
        assert args(getattr(tt, name)) == args(getattr(jt, name)), name
    assert TCF in typing.get_args(tt.TimeLike) and TPad in typing.get_args(tt.GridPosition)
