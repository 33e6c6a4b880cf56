"""Scale-out over ``torch.distributed``: the process group and particle
data parallelism.

Port of the JAX package's ``parallel/sharding.py``. There a 1-D device mesh
shards the SoA and replicates the fields inside one program; here each rank
is a process (SPMD, as the JAX package's multi-host path runs): every rank
builds the same global SoA from the same seeds, keeps only its own slice of
the lanes, holds its own full copy of the fields on its own device, and runs
the ordinary single-card engine on its lanes. Lanes never interact, so the
ranks meet only between chunks (error flags, the chunk-length model) and to
gather the SoA back (``gather_soa``).

``init_distributed`` starts the process group (``nccl`` when every rank of
the host has its own card, else ``gloo``: see ``parallel/_comm.py`` for the
transport each gives).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from parcels_tpu_torch._core.particles_view import split_key
from parcels_tpu_torch.parallel import _comm

__all__ = ["ParticleMesh", "init_distributed", "shard_particleset"]

#: SoA keys whose padding lanes get -1: they must never look like live ids
#: or valid persistent-cache cells (cell 0 is real)
_SENTINEL_KEYS = ("particle_id", "_sc_key", "_uxc_key")


def init_distributed(backend: str | None = None, init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None, store=None,
                     timeout_s: float | None = None) -> int:
    """Start this process's rank of the process group; returns the rank.

    Rank and world size come from the arguments, else from ``RANK`` and
    ``WORLD_SIZE`` (``torchrun`` sets them, with ``MASTER_ADDR`` and
    ``MASTER_PORT`` for the default ``env://`` rendezvous). A world of one
    process is a no-op that returns 0, as the JAX package's is on one host.
    ``backend`` defaults to ``nccl`` when CUDA is available and the host has
    a card for every local rank, else ``gloo``; the transport it fixes is
    printed on rank 0.
    """
    if dist.is_initialized():
        return dist.get_rank()
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    if world_size <= 1:
        return 0
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        backend = ("nccl" if torch.cuda.is_available() and torch.cuda.device_count() >= local
                   else "gloo")
    kwargs = dict(backend=backend, rank=rank, world_size=world_size)
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = init_method or "env://"
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(**kwargs)
    if rank == 0:
        staged = ("CUDA tensors staged through pinned host buffers" if backend == "gloo"
                  else "device tensors")
        print(f"parcels_tpu_torch.parallel: {world_size} ranks, backend {backend} ({staged})",
              flush=True)
    return rank


def rank_device(devices=None) -> torch.device:
    """This rank's device: ``devices`` (one device, or one per rank) when
    given, else ``cuda:{local_rank % device_count}``; without CUDA and
    without ``devices`` it raises instead of running on the CPU."""
    rank, _ = _comm.world()
    if devices is not None:
        dev = torch.device(devices[rank] if isinstance(devices, (list, tuple)) else devices)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass devices='cpu' to run the ranks on the CPU.")
    return torch.device("cuda", _comm.local_rank() % torch.cuda.device_count())


def rank_key(key, rank: int, world: int):
    """This rank's RNG key: the set's key split once per rank (the JAX
    package's one global draw has no per-process counterpart, and one key
    on every rank would give every rank the same stream)."""
    return key if world == 1 else split_key(key, world)[rank]


def _pad_rows(v: torch.Tensor, total: int, key: str) -> torch.Tensor:
    pad = total - v.shape[0]
    if pad <= 0:
        return v
    fill = torch.full((pad,) + tuple(v.shape[1:]), -1 if key in _SENTINEL_KEYS else 0,
                      dtype=v.dtype, device=v.device)
    return torch.cat([v, fill])


class ParticleMesh:
    """Particle data parallelism over the ranks of the process group.

    ``n_devices``, when given, must equal the world size; ``devices`` is
    this rank's device (one, or a list indexed by rank), by default
    ``cuda:{local_rank % device_count}``.
    """

    def __init__(self, n_devices: int | None = None, axis: str = "particles", devices=None):
        self.rank, world = _comm.world()
        if n_devices is not None and int(n_devices) != world:
            raise ValueError(f"ParticleMesh(n_devices={n_devices}) needs a world of that many "
                             f"ranks; this process group has {world}.")
        self.axis = axis
        self.device = rank_device(devices)

    @property
    def n(self) -> int:
        return _comm.world()[1]

    def shard_soa(self, pdata: dict) -> dict:
        """This rank's slice of the global SoA, on this rank's device.

        The SoA is padded to a multiple of the world size with inactive
        lanes (-1 ids and cache keys), and each rank's slice to the engine's
        padded lane count (``padded_capacity``), so that its blocks divide
        it. Rank r keeps rows ``[r * per, (r + 1) * per)``.
        """
        from parcels_tpu_torch._core.particleset import padded_capacity

        n = next(v.shape[0] for k, v in pdata.items() if k != "_rng")
        world = self.n
        per = -(-n // world)
        lanes = padded_capacity(per)
        lo, hi = self.rank * per, min((self.rank + 1) * per, n)
        out = {}
        for k, v in pdata.items():
            if k == "_rng":
                out[k] = rank_key(v, self.rank, world)
                continue
            out[k] = _pad_rows(v[lo:max(hi, lo)].to(self.device), lanes, k)
        return out

    def gather_soa(self, pdata: dict, device) -> dict:
        """Every rank's active lanes in rank order, on ``device``, on every
        rank; the RNG key is rank 0's."""
        return gather_lanes(pdata, device)

    def shard_fields(self, farrays):
        """This rank's full copy of the field and grid tensors on its
        device: ``farrays`` itself when the fieldset lives there (as it does
        when each rank builds its fieldset on its own device)."""
        if all(t.device == self.device for t in _tensors(farrays)):
            return farrays
        return _to_device(farrays, self.device)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree


def gather_lanes(pdata: dict, device) -> dict:
    """The active lanes of every rank in rank order (``allgather_rows``), on
    ``device``; the per-rank RNG keys reduce to rank 0's, so that every
    rank holds the same SoA. Inactive lanes (padding, deleted particles)
    and the per-rank counters ``_migof``/``_haloof`` stay behind."""
    act = pdata["_active"]
    lanes = {k: v[act] for k, v in pdata.items() if k not in ("_rng", "_migof", "_haloof")}
    dev = act.device
    out = {k: v.to(device) for k, v in _comm.allgather_rows(lanes, dev).items()}
    if "_rng" in pdata:
        keys = _comm.allgather_rows({"k": torch.as_tensor(pdata["_rng"]).reshape(1, 2)}, "cpu")
        out["_rng"] = keys["k"][0].clone()
    return out


def shard_particleset(pset, pmesh):
    """Bind a ParticleSet to a ParticleMesh, YBandDomain or XYTileDomain:
    its later ``execute`` calls run over the ranks."""
    from parcels_tpu_torch.parallel.domain import YBandDomain
    from parcels_tpu_torch.parallel.tiles import XYTileDomain

    if isinstance(pmesh, (YBandDomain, XYTileDomain)):
        pset._domain = pmesh
    elif isinstance(pmesh, ParticleMesh):
        pset._pmesh = pmesh
    else:
        raise TypeError(f"shard_particleset: expected a ParticleMesh, YBandDomain or "
                        f"XYTileDomain. Got {type(pmesh)}")
    return pset
