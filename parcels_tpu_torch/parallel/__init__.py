"""Scale-out over ``torch.distributed``: one process per rank.

Three modes, each composable with every kernel and interpolator:

- :class:`ParticleMesh`: particle data parallelism with the fields
  replicated on every rank. Right when the forcing fits on every card.
- :class:`YBandDomain`: Y-band domain decomposition, each rank holding
  only its band's slab with halo rows, and per-step particle migration.
  Right when the fields are too large to replicate.
- :class:`XYTileDomain`: 2-D tile decomposition with corner halos and
  direct all-to-all migration.

Start the process group with :func:`init_distributed` (or
``torch.distributed.init_process_group``), build the same fieldset and
particle set on every rank, bind the set with :func:`shard_particleset`,
and call ``execute`` on every rank. Ranks with a card each use ``nccl``;
ranks that share a card use ``gloo`` with the rows staged through pinned
host buffers (``parallel/_comm.py``).
"""

from parcels_tpu_torch.parallel._comm import comm_stats
from parcels_tpu_torch.parallel.domain import YBandDomain, build_domain_executor
from parcels_tpu_torch.parallel.sharding import ParticleMesh, init_distributed, shard_particleset
from parcels_tpu_torch.parallel.tiles import XYTileDomain, build_tile_executor

__all__ = [
    "ParticleMesh",
    "XYTileDomain",
    "YBandDomain",
    "build_domain_executor",
    "build_tile_executor",
    "init_distributed",
    "shard_particleset",
]
