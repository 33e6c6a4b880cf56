"""The ``particles`` object passed to kernels by the engine (torch).

Port of the JAX package's masked write-through view. Attribute reads
return the full per-lane tensor; attribute writes are merged back into the
shared SoA dict under the engine-supplied lane mask, which reproduces the
reference's "kernel runs on the masked subset, writes go to the parent
SoA" semantics without dynamic shapes. Writes build new tensors and never
update the SoA in place, so a shallow copy of the dict is a snapshot.
"""

from __future__ import annotations

import torch

__all__ = ["Particles"]


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

    def _set_ei(self, igrid: int, values):
        """Masked update of the cached element index for one grid."""
        ei = self._data["ei"]
        new_col = torch.where(self._mask, values.to(ei.dtype), ei[:, igrid])
        ei = ei.clone()
        ei[:, igrid] = new_col
        self._data["ei"] = ei

    def __len__(self):
        return self._data["state"].shape[0]

    def __repr__(self):
        return f"Particles(n={len(self)}, vars={list(self._data)})"
