"""The program's counter-based normal draws, worked out again from the seed.

The program states its stream (``parcels_tpu_torch._core.particles_view``):
a draw of a lane is a hash of the set's key (two 32-bit words drawn by
``numpy.random.default_rng(seed)``), the draw's place in the step (kernel
index, repeat round, draw number), the lane's position in the set and the
float32 bits of its clock at the step's start, then Box-Muller on two
24-bit uniforms. These are the inputs of an Euler-Maruyama step as much as
the release positions are: the reference computes them itself, here in
float64 from the same 32-bit words.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _hash32(h):
    h = h ^ (h >> 16)
    h = (h * 0x21F0AAAD) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x735A2D97) & _M32
    return h ^ (h >> 15)


def set_key(seed: int):
    return [int(w) for w in np.random.default_rng(seed).integers(0, 2**32, size=2)]


def normal(key, draw: int, position, clock_s, kernel: int = 0, rnd: int = 0):
    """float64 standard normals of lanes at set ``position`` (int64) whose
    clocks read ``clock_s`` (seconds, exact in float32), for the ``draw``-th
    draw of kernel ``kernel`` in a step."""
    salt = np.random.SeedSequence(list(key) + [kernel, rnd, draw]).generate_state(3, np.uint32)
    clock = torch.as_tensor(clock_s, dtype=torch.float64).to(torch.float32)
    bits = clock.contiguous().view(torch.int32).to(torch.int64) & _M32
    h = _hash32(_hash32(torch.as_tensor(position, dtype=torch.int64) ^ int(salt[0])) ^ bits)
    a, b = (_hash32(h ^ int(w)) for w in salt[1:])
    u1 = ((a >> 8) + 1).to(torch.float64) * 2.0**-24
    u2 = (b >> 8).to(torch.float64) * 2.0**-24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
