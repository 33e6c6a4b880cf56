"""The kernel chain a traffic mix names, and what it adds to the fieldset:
each key of the mix's ``fieldset`` names a module
``harness/prepare/<key>.py`` whose ``apply(fs, params)`` adds it."""

from __future__ import annotations

from harness import registry


def delete_oob(particles, fieldset):
    """Quickstart 03's recovery kernel: out-of-bounds particles are deleted."""
    import torch

    from parcels_tpu_torch import StatusCode

    particles.state = torch.where(particles.state == StatusCode.ErrorOutOfBounds,
                                  StatusCode.Delete, particles.state)


def kernels(traffic: dict) -> list:
    import parcels_tpu_torch as tp

    local = {"delete_oob": delete_oob}
    return [local[name] if name in local else getattr(tp, name) for name in traffic["kernels"]]


def prepare(fs, traffic: dict) -> None:
    for key, params in traffic.get("fieldset", {}).items():
        registry.module("harness/prepare", key).apply(fs, params)
