"""A pool of spawned gloo ranks on one host.

``RankPool(world, workdir)`` spawns ``world`` processes that meet at a
``FileStore`` in ``workdir`` and join one gloo process group. Then
``run(module, function, timeout=..., **kwargs)`` calls
``module.function(**kwargs)`` on every rank and returns the results in rank
order (numpy and plain Python objects). Every wait has a deadline: a rank
that fails or passes it fails the call, the ranks are killed, and the next
call spawns them anew. ``close()`` stops every rank and removes the store.

A spawned rank imports only the module that defines the function (and
this package), so the caller keeps that module free of what the ranks must
not load. The multi-rank tests hold one pool a test file; ``chip_smoke.py``
one a phase, with its ranks sharing ``cuda:0``.
"""

from __future__ import annotations

import importlib
import itertools
import multiprocessing as mp
import os
import time
import traceback
from multiprocessing.connection import wait

__all__ = ["RankPool"]


def _rank_main(rank, world, store_path, threads, timeout_s, cuda_device, conn):
    import torch
    import torch.distributed as dist

    from parcels_tpu_torch.parallel.sharding import init_distributed

    torch.set_num_threads(threads)
    if cuda_device is not None:
        torch.cuda.set_device(cuda_device)
    try:
        init_distributed(backend="gloo", rank=rank, world_size=world,
                         store=dist.FileStore(store_path, world), timeout_s=timeout_s)
        while True:
            msg = conn.recv()
            if msg is None:
                return
            module, name, kwargs = msg
            try:
                fn = getattr(importlib.import_module(module), name)
                conn.send(("ok", fn(**kwargs)))
            except BaseException:  # noqa: BLE001 - reported to the caller, whose call fails
                conn.send(("err", traceback.format_exc()))
    except BaseException:  # noqa: BLE001 - the group did not form: the caller's call fails
        conn.send(("err", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankPool:
    """``world`` spawned ranks of one gloo process group.

    ``threads`` is each rank's torch thread count (default: the host's cores
    shared by two pools), ``collective_timeout_s`` how long a rank waits in
    one collective, ``cuda_device`` the card every rank selects (None: no
    card), ``grace_s`` how long the other ranks get to report once one has
    failed (they may wait in a collective of the failed one).
    """

    def __init__(self, world: int, workdir: str, *, threads: int | None = None,
                 collective_timeout_s: float = 90.0, cuda_device: int | None = None,
                 grace_s: float = 10.0):
        self.world = world
        self.workdir = workdir
        self.threads = threads or max(1, (os.cpu_count() or 2) // (2 * world))
        self.collective_timeout_s = collective_timeout_s
        self.cuda_device = cuda_device
        self.grace_s = grace_s
        self._spawns = itertools.count()
        self._procs: list = []
        self._conns: list = []
        self._store = None

    def _start(self):
        ctx = mp.get_context("spawn")
        os.makedirs(self.workdir, exist_ok=True)
        self._store = os.path.join(self.workdir, f"store{next(self._spawns)}")
        if os.path.exists(self._store):
            os.remove(self._store)
        for rank in range(self.world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_rank_main, daemon=True, args=(
                rank, self.world, self._store, self.threads, self.collective_timeout_s,
                self.cuda_device, child))
            proc.start()
            child.close()
            self._procs.append(proc)
            self._conns.append(parent)

    def run(self, module: str, function: str, /, timeout: float = 120.0, **kwargs) -> list:
        if not self._procs:
            self._start()
        for conn in self._conns:
            conn.send((module, function, kwargs))
        results: dict = {}
        errors: list = []
        deadline = time.monotonic() + timeout
        pending = dict(enumerate(self._conns))
        while pending:
            left = deadline - time.monotonic()
            if errors:
                left = min(left, self.grace_s)
            ready = wait(list(pending.values()), timeout=max(left, 0.0))
            if not ready:
                break
            for rank, conn in list(pending.items()):
                if conn not in ready:
                    continue
                del pending[rank]
                try:
                    status, value = conn.recv()
                except (EOFError, OSError):
                    status, value = "err", f"rank {rank} exited"
                if status == "ok":
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        if errors or pending:
            self.close(wait_s=1.0)
            late = f"ranks {sorted(pending)} passed the {timeout} s deadline\n" if pending else ""
            raise RuntimeError(f"{module}.{function} failed: {late}" + "\n".join(errors))
        return [results[r] for r in range(self.world)]

    def close(self, wait_s: float = 30.0):
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(timeout=wait_s)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=30)
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []
        if self._store is not None and os.path.exists(self._store):
            os.remove(self._store)
        self._store = None
