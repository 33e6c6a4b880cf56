"""The ``particles`` object passed to kernels by the engine (torch).

Port of the JAX package's masked write-through view. Attribute reads
return the full per-lane tensor; attribute writes are merged back into the
shared SoA dict under the engine-supplied lane mask, which reproduces the
reference's "kernel runs on the masked subset, writes go to the parent
SoA" semantics without dynamic shapes. Writes build new tensors and never
update the SoA in place, so a shallow copy of the dict is a snapshot. A read
is a ``_KernelTensor``: its augmented assignments (``particles.age +=
particles.dt``) compute a new tensor, as they do on the JAX package's
immutable arrays, and the masked write then merges it; on a plain tensor
they would write into the SoA in place, unmasked lanes and output
snapshots included.

Random draws: the SoA's ``_rng`` is a (2,) uint32 key, as in the JAX
package, kept on the host (a CPU tensor) so that a draw needs no device
read. A draw is counter-based: each lane's value is a hash of the key, the
draw's place in the step (the kernel's index in the chain, its Repeat
round, the draw's index in the call), the lane's set position (the
engine's ``_ord`` column; the lane's index where there is none) and its
clock ``t``. So the particle at set position i gets the same draw at the
same time whatever the SoA's order, the blocks, the chunk lengths or the
split of the run into ``execute`` calls and restarts, and the key never
changes. The streams are not the JAX package's threefry streams (which
split the key per draw and per block at every chunk); the moments are what
agree.
"""

from __future__ import annotations

import math
import operator

import numpy as np
import torch

from parcels_tpu_torch import profiling

__all__ = ["Particles", "split_key"]


class _KernelTensor(torch.Tensor):
    """A particle variable as a kernel reads it: a plain tensor (no
    ``__torch_function__`` overhead; results of its operations are plain
    tensors) whose augmented assignments are out of place."""

    __torch_function__ = torch._C._disabled_torch_function_impl


def _out_of_place(op):
    def method(self, other):
        return op(self.as_subclass(torch.Tensor), other)

    return method


for _name, _op in (("__iadd__", operator.add), ("__isub__", operator.sub),
                   ("__imul__", operator.mul), ("__itruediv__", operator.truediv),
                   ("__ifloordiv__", operator.floordiv), ("__imod__", operator.mod),
                   ("__ipow__", operator.pow), ("__iand__", operator.and_),
                   ("__ior__", operator.or_), ("__ixor__", operator.xor)):
    setattr(_KernelTensor, _name, _out_of_place(_op))
del _name, _op


def split_key(key, num: int = 2) -> list:
    """``num`` new (2,) uint32 keys derived from ``key`` (a (2,) tensor or
    array), on the host: distinct keys give unrelated children."""
    words = np.asarray(key, dtype=np.uint32).reshape(2)
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(2 * num, np.uint32)
    return [torch.from_numpy(state[2 * i:2 * i + 2].copy()) for i in range(num)]


_M32 = 0xFFFFFFFF


def _hash32(h):
    """A 32-bit mixing bijection of int64 tensors that hold 32-bit values
    (a two-round multiply-xorshift hash; both multipliers are below 2^31, so
    no product leaves the int64 range)."""
    h = h ^ (h >> 16)
    h = (h * 0x21F0AAAD) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x735A2D97) & _M32
    return h ^ (h >> 15)


class Particles:
    """Masked write-through view over the particle SoA used inside kernels."""

    __slots__ = ("_data", "_mask", "_sorted_hint", "_z_occ_hint", "_stream", "_draws")

    def __init__(self, data: dict, mask, sorted_hint: bool = False, z_occ_hint=None,
                 stream=(0, 0)):
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_mask", mask)
        # the engine keeps the SoA spatially sorted (binned slab sampler)
        object.__setattr__(self, "_sorted_hint", sorted_hint)
        # quantized occupied-z fraction of the batch (binned-sampler planning)
        object.__setattr__(self, "_z_occ_hint", z_occ_hint)
        # this call's place in the step: (kernel index in the chain, Repeat round)
        object.__setattr__(self, "_stream", tuple(stream))
        object.__setattr__(self, "_draws", 0)

    def __getattr__(self, name):
        try:
            return self._data[name].as_subclass(_KernelTensor)
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

    def _words(self, count: int):
        """``count`` random 32-bit words per lane (int64 tensors), from the
        key, this draw's place in the step, each lane's set position and clock."""
        d = self._data
        place = [*self._stream, self._draws]
        object.__setattr__(self, "_draws", self._draws + 1)
        key = [int(w) for w in np.asarray(d["_rng"], dtype=np.uint32).reshape(2)]
        salt = np.random.SeedSequence(key + place).generate_state(count + 1, np.uint32)
        n, dev = d["state"].shape[0], d["state"].device
        pos = d["_ord"] if "_ord" in d else torch.arange(n, device=dev)
        t = d["t"] if "t" in d else torch.zeros(n, device=dev)
        clock = t.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _M32
        h = _hash32(_hash32(pos.to(torch.int64) ^ int(salt[0])) ^ clock)
        return [_hash32(h ^ int(w)) for w in salt[1:]]

    def random_normal(self, dtype=torch.float32):
        """Per-particle standard normals from the engine RNG (reference
        kernels/_advectiondiffusion.py:37 draws np.random.normal): Box-Muller
        on two 24-bit uniforms."""
        with profiling.span("parcels.rng.draw"):
            a, b = self._words(2)
            u1 = ((a >> 8) + 1).to(torch.float32) * 2.0**-24  # (0, 1]
            u2 = (b >> 8).to(torch.float32) * 2.0**-24
            z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
            return z.to(dtype)

    def random_uniform(self, dtype=torch.float32):
        """Per-particle uniform [0, 1) draws (24 bits) from the engine RNG."""
        with profiling.span("parcels.rng.draw"):
            (a,) = self._words(1)
            return ((a >> 8).to(torch.float32) * 2.0**-24).to(dtype)

    def __len__(self):
        return self._data["state"].shape[0]

    def __repr__(self):
        return f"Particles(n={len(self)}, vars={list(self._data)})"
