"""One run of a cell: set-up, warm-up, the measured window, the record of
the answers the correctness check compares.

The window starts with a fresh release and runs the mix's schedule in
``execute`` calls until the first call that ends past ``seconds``; it ends
at a ``torch.cuda.synchronize()`` after that call. Its work is counted from
the lanes' own clocks: for every lane of every release in the window, the
model time it advanced over dt, deleted lanes up to their deletion.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import numpy as np
import torch

from harness import chain, host, registry, release
from harness.cell import Cell

#: the program's first error state (StatusCode.Error)
ERROR = 50


class Run:
    def __init__(self, bench: dict, workload_name: str, seed: int, device, overrides=None):
        self.cell = Cell(bench, workload_name, overrides)
        self.wl, self.cfg, self.traffic = self.cell.wl, self.cell.cfg, self.cell.traffic
        self.seed, self.device = int(seed), torch.device(device)
        self.host = {}
        self.answers = []
        self.work_steps = 0
        self.failed = 0
        #: host seconds of each execute call of the window, in order
        self.piece_s = []
        self.traced = None

    # -- set-up ------------------------------------------------------------
    def setup(self):
        import parcels_tpu_torch as tp

        self.tp = tp
        builder = registry.module("configs", self.wl["config"])
        self.fs, self.field_end_s = builder.build(self.cfg, self.seed, self.device)
        chain.prepare(self.fs, self.traffic)
        self.kernels = chain.kernels(self.traffic)
        self.dt = float(self.traffic["dt_s"])
        self.pos = self.cell.positions(self.seed)
        n = self.pos["x"].size
        self.sample = self.cell.check_lanes(n, self.seed)
        self.sample_mask = torch.zeros(n, dtype=torch.bool, device=self.device)
        self.sample_mask[torch.as_tensor(self.sample, device=self.device)] = True
        # warm-up: a release and two steps of it, which builds or loads every
        # kernel and runs the cold first step the window's releases run
        start, _, _ = next(release.schedule(self.traffic, self.field_end_s))
        pset = self._release(start)
        self._execute(pset, 2 * self.dt)
        del pset
        self._sync()

    def _release(self, start_s):
        n = self.pos["x"].size
        return self.tp.ParticleSet(self.fs, x=self.pos["x"], y=self.pos["y"], z=self.pos["z"],
                                   t=np.full(n, start_s), seed=self.seed % 2**63)

    def _execute(self, pset, seconds):
        pset.execute(self.kernels, dt=np.timedelta64(int(round(self.dt * 1000)), "ms"),
                     runtime=np.timedelta64(int(round(seconds * 1000)), "ms"))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float, trace_piece=None, after_piece=None):
        """Run the schedule for ``seconds``; returns the window's host-clock
        length. ``trace_piece`` wraps the first steady piece (not the first
        of its release, or the second release's only piece) in a context;
        ``after_piece(pset, k)`` runs after each piece (used by fault tests)."""
        with host.Window(probe=self.device.type == "cuda") as hw:
            elapsed = self._window(seconds, trace_piece, after_piece)
        self.host = hw.report
        return elapsed

    def _window(self, seconds, trace_piece, after_piece):
        ann = torch.profiler.record_function
        sched = release.schedule(self.traffic, self.field_end_s)
        t_start = time.perf_counter()
        done, k_release = False, 0
        while not done:
            start, end, piece = next(sched)
            with ann("portbench.release"):
                pset = self._release(start)
            t, k = start, 0
            while t < end and not done:
                steady = (k > 0) or (k_release > 0 and end - start == piece)
                ctx = (trace_piece(piece) if (trace_piece and steady and self.traced is None)
                       else nullcontext())
                t_piece = time.perf_counter()
                with ctx as session, ann("portbench.execute"):
                    self._execute(pset, piece)
                self.piece_s.append(round(time.perf_counter() - t_piece, 4))
                if session is not None:
                    session.after(self, pset)
                    self.traced = session
                if after_piece is not None:
                    after_piece(pset, k)
                t += piece
                k += 1
                # a traced run goes on until it has traced a steady piece
                done = (time.perf_counter() - t_start >= seconds
                        and (trace_piece is None or self.traced is not None))
            if done:
                self._sync()
                elapsed = time.perf_counter() - t_start
            with ann("portbench.record"):
                self._record(pset, start, t)
            del pset
            k_release += 1
        return elapsed

    def _record(self, pset, start_s, reached_s):
        """Count the release's particle-steps from its lanes' clocks and keep
        its sampled lanes for the check."""
        d = pset._data
        ids = d["particle_id"].long()
        real = ids >= 0
        clock = d["t"].double() + d["_tc"].double()
        steps = torch.round((clock - start_s) / self.dt)
        self.work_steps += int(torch.where(real, steps, torch.zeros_like(steps)).sum())
        self.failed += int((real & (d["state"] >= ERROR)).sum())
        sel = real & self.sample_mask[ids.clamp(min=0)]
        cols = {k: d[k][sel].cpu() for k in ("particle_id", "x", "y", "state", "_active")}
        cols["steps"] = steps[sel].cpu()
        self.answers.append({"start_s": start_s, "reached_s": reached_s,
                             **{k: v.numpy() for k, v in cols.items()}})
