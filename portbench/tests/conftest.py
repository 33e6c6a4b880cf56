"""CPU tests of the benchmark at tiny sizes: ``python -m pytest portbench/tests``.

They run the harness's own functions on the CPU (``measure`` with
``device="cpu"``, which skips the look for a card) with the configurations
and mixes cut to a few hundred particles and a small grid.
"""

import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: tiny cuts of each configuration and mix (the mixes' parameters otherwise
#: as committed); the coast's seed keeps the drift box at sea at this size
TINY = {
    "nemo-orca12.global-rk4": {"columns": 120, "rows": 90, "levels": 5, "particles": 256,
                               "check": {"lanes": 64}},
    "cmems-glo-phy-024.global-rk4": {"columns": 720, "rows": 341, "land_seed": 2,
                                     "particles": 256, "check": {"lanes": 64}},
    "cmems-glo-phy-024.global-em": {"columns": 720, "rows": 341, "land_seed": 2,
                                    "particles": 256, "check": {"lanes": 64}},
    "cmems-glo-phy-024.drift-forecast": {"columns": 720, "rows": 341, "land_seed": 2,
                                         "particles": 64, "check": {"lanes": 32}},
}


#: cells whose mixes and reference schemes the benchmark keeps for a later
#: PR (PERF.md, Open questions); they run here at tiny sizes under the
#: limits of the cell on the same configuration
QUEUED = {
    "cmems-glo-phy-024.drift-forecast": "drift-forecast",
    "cmems-glo-phy-024.global-em": "global-em-15min",
}
SISTER = "cmems-glo-phy-024.global-rk4"


@pytest.fixture(scope="session")
def bench():
    from harness import registry

    b = registry.benchmark()
    b["workloads"] = b["workloads"] + [
        {"name": name, "config": "cmems-glo-phy-024", "traffic": mix, "chips": 1, "why": "queued"}
        for name, mix in QUEUED.items()]
    return b


def limits(name):
    """The limits a tiny run of cell ``name`` is judged by."""
    from harness import check

    return check.limits(SISTER if name in QUEUED else name)
