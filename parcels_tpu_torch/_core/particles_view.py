"""The ``particles`` object passed to kernels by the engine (torch).

Port of the JAX package's masked write-through view. Attribute reads
return the full per-lane tensor; attribute writes are merged back into the
shared SoA dict under the engine-supplied lane mask, which reproduces the
reference's "kernel runs on the masked subset, writes go to the parent
SoA" semantics without dynamic shapes. Writes build new tensors and never
update the SoA in place, so a shallow copy of the dict is a snapshot.

Random draws: the SoA's ``_rng`` is a (2,) uint32 key, as in the JAX
package, kept on the host (a CPU tensor) so that a draw needs no device
read. Every draw splits it (``split_key``, a counter-free hash through
``numpy.random.SeedSequence``) into the carried key and a subkey that seeds
a ``torch.Generator`` on the lanes' device (Philox on the card, mt19937 on
the CPU). The streams are deterministic per seed and device, but are not
the JAX package's threefry streams.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Particles", "split_key"]


def split_key(key, num: int = 2) -> list:
    """``num`` new (2,) uint32 keys derived from ``key`` (a (2,) tensor or
    array), on the host: distinct keys give unrelated children."""
    words = np.asarray(key, dtype=np.uint32).reshape(2)
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(2 * num, np.uint32)
    return [torch.from_numpy(state[2 * i:2 * i + 2].copy()) for i in range(num)]


def _generator(key, device) -> torch.Generator:
    k0, k1 = (int(w) for w in np.asarray(key, dtype=np.uint32))
    g = torch.Generator(device=device)
    g.manual_seed((k0 << 32) | k1)
    return g


class Particles:
    """Masked write-through view over the particle SoA used inside kernels."""

    __slots__ = ("_data", "_mask", "_sorted_hint", "_z_occ_hint")

    def __init__(self, data: dict, mask, sorted_hint: bool = False, z_occ_hint=None):
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_mask", mask)
        # the engine keeps the SoA spatially sorted (binned slab sampler)
        object.__setattr__(self, "_sorted_hint", sorted_hint)
        # quantized occupied-z fraction of the batch (binned-sampler planning)
        object.__setattr__(self, "_z_occ_hint", z_occ_hint)

    def __getattr__(self, name):
        try:
            return self._data[name]
        except KeyError as e:
            raise AttributeError(f"Particles have no variable {name!r}") from e

    def __setattr__(self, name, value):
        d = self._data
        if name not in d:
            raise AttributeError(
                f"Particles have no variable {name!r}; add it to the ParticleClass first."
            )
        old = d[name]
        value = torch.as_tensor(value, device=old.device)
        if value.dtype != old.dtype:
            value = value.to(old.dtype)
        value = value.expand(old.shape)
        mask = self._mask
        if old.dim() == 2:  # e.g. ei (n, ngrids)
            mask = mask[:, None]
        d[name] = torch.where(mask, value, old)

    def _get_ei(self, igrid: int):
        """Cached element index of one grid (curvilinear warm start)."""
        return self._data["ei"][:, igrid]

    def _set_ei(self, igrid: int, values):
        """Masked update of the cached element index for one grid."""
        ei = self._data["ei"]
        new_col = torch.where(self._mask, values.to(ei.dtype), ei[:, igrid])
        ei = ei.clone()
        ei[:, igrid] = new_col
        self._data["ei"] = ei

    def _draw(self):
        """Split the SoA key; a generator on the lanes' device seeded from
        the subkey."""
        d = self._data
        d["_rng"], sub = split_key(d["_rng"])
        return _generator(sub, d["state"].device)

    def random_normal(self, dtype=torch.float32):
        """Per-particle standard normals from the engine RNG (reference
        kernels/_advectiondiffusion.py:37 draws np.random.normal)."""
        n, dev = self._data["state"].shape[0], self._data["state"].device
        return torch.randn(n, generator=self._draw(), device=dev, dtype=dtype)

    def random_uniform(self, dtype=torch.float32):
        """Per-particle uniform [0, 1) draws from the engine RNG."""
        n, dev = self._data["state"].shape[0], self._data["state"].device
        return torch.rand(n, generator=self._draw(), device=dev, dtype=dtype)

    def __len__(self):
        return self._data["state"].shape[0]

    def __repr__(self):
        return f"Particles(n={len(self)}, vars={list(self._data)})"
