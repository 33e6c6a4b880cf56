"""Multi-card scaling: the scale-out slice of the port (not landed yet).

The JAX package's particle mesh, Y-band and X-Y tile domains move to
``torch.distributed`` in a later slice. Until then each name raises
``NotImplementedError`` instead of silently running on one card.
"""

from __future__ import annotations

__all__ = ["ParticleMesh", "XYTileDomain", "YBandDomain", "init_distributed", "shard_particleset"]

_LATER = "belongs to the scale-out slice of the port (torch.distributed); not ported yet"


def _later_slice(name):
    def unported(*args, **kwargs):
        raise NotImplementedError(f"{name} {_LATER}")

    unported.__name__ = name
    unported.__doc__ = f"{name}: {_LATER}."
    return unported


ParticleMesh = _later_slice("ParticleMesh")
YBandDomain = _later_slice("YBandDomain")
XYTileDomain = _later_slice("XYTileDomain")
init_distributed = _later_slice("init_distributed")
shard_particleset = _later_slice("shard_particleset")
