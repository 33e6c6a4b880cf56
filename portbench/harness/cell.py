"""A cell's parts, found by the names in BENCHMARK.json, and the lanes its
check compares: the one place both a run and the control take them from."""

from __future__ import annotations

import numpy as np

from harness import registry


class Cell:
    """The workload entry, its configuration's sizes, its traffic mix and
    its configuration's reference module; ``overrides`` replace keys of
    the configuration or, where the configuration has no such key, of the
    mix (the CPU tests cut both to a tiny size this way)."""

    def __init__(self, bench: dict, workload_name: str, overrides=None):
        self.wl = registry.workload(bench, workload_name)
        self.cfg = registry.config(bench, self.wl["config"])
        self.traffic = registry.traffic(self.wl["traffic"])
        for key, value in (overrides or {}).items():
            (self.cfg if key in self.cfg else self.traffic)[key] = value
        self.ref = registry.module("reference", self.wl["config"])

    def positions(self, seed: int) -> dict:
        from harness import release

        return release.positions(self.traffic, lambda x, y: self.ref.ocean(self.cfg, x, y),
                                 seed)

    def check_lanes(self, n: int, seed: int, lanes=None) -> np.ndarray:
        """The sorted indices, drawn from the seed, of the release's lanes
        the check compares (the mix's ``check.lanes`` of them)."""
        rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, 3]))
        k = min(n, int(lanes or self.traffic["check"]["lanes"]))
        return np.sort(rng.choice(n, k, replace=False))
