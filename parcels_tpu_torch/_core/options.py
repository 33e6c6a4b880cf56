"""Programmatic engine tuning options (round-3 VERDICT: config sprawl).

The reference keeps configuration programmatic — constructor kwargs plus
``FieldSet.add_context`` (reference fieldset.py:230-245); it has no env
flags. The TPU build grew a set of ``PARCELS_TPU_*`` env knobs steering
engine behavior; the load-bearing ones graduate here into a documented
dataclass passed to ``ParticleSet.execute(options=EngineOptions(...))``.

Precedence: an env var that is EXPLICITLY SET always wins over the
programmatic value — the env layer stays available as a debugging
override (e.g. forcing a sampler mode on a failing config without
touching user code), but the dataclass is the primary interface.

The remaining env-only knobs are low-level tuning constants
(block/chunk sizes, fix-up tier divisors, Pallas interpret mode) that are
read at import time and should not be per-execute state.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass

__all__ = ["EngineOptions"]

_SAMPLER_TO_ENV = {"auto": "auto", "binned": "force", "gather": "off"}
_TRISTATE = ("auto", "force", "off")


@dataclass(frozen=True)
class EngineOptions:
    """Engine execution-mode options for :meth:`ParticleSet.execute`.

    Parameters
    ----------
    sampler:
        Field-sampling engine for HBM-scale fields. ``"auto"`` (default)
        picks per shape/population; ``"binned"`` forces chunk-sorted
        binned slab sampling (``ops/binned_sample.py``); ``"gather"``
        forces plain XLA gathers. Maps to ``PARCELS_TPU_SORT_MODE`` +
        ``PARCELS_TPU_BINNED``.
    colgather:
        Corner-column row-gather sampling for large (T*Z <= 512) fields
        (``ops/colgather.py``). ``"auto"``/``"force"``/``"off"``.
        Maps to ``PARCELS_TPU_COLGATHER``.
    stagecache:
        C-grid RK-stage cell cache (``ops/stagecache.py``).
        ``"auto"``/``"force"``/``"off"``. Maps to
        ``PARCELS_TPU_STAGECACHE``.
    uxcol:
        Unstructured corner-row tier (``ops/uxcol.py``: fused face rows +
        node/face column tables). ``"auto"``/``"force"``/``"off"``. Maps
        to ``PARCELS_TPU_UXCOL``.
    uxcache:
        Unstructured per-face RK-stage cache (``ops/uxcache.py``: cached
        face + corner values in the SoA, compacted walk rounds on miss).
        ``"auto"``/``"force"``/``"off"``. Maps to ``PARCELS_TPU_UXCACHE``.
    stagecache_persist:
        Persist the cell cache across steps in the particle SoA
        (64 B/lane; disable as a memory escape hatch on a single chip at
        the largest 3-D shapes). Maps to
        ``PARCELS_TPU_STAGECACHE_PERSIST``.
    max_chunk_steps:
        Upper bound on engine while-loop steps per device launch; bounds
        single-program device runtime (long-running programs destabilize
        remote TPU runtimes). 0 disables the cap. Maps to
        ``PARCELS_TPU_MAX_CHUNK_STEPS``.
    chunk_target_seconds:
        Measured-cost chunker target: each launch's wall time feeds an
        EWMA seconds-per-step estimate and subsequent chunks are sized to
        ~this many seconds of device time (never above
        ``max_chunk_steps``). Cheap steps get the full cap; expensive
        configs (10M-lane forced-gather) automatically run short launches
        instead of multi-minute programs. 0 disables adaptation (fixed
        ``max_chunk_steps`` chunks). Maps to
        ``PARCELS_TPU_CHUNK_TARGET_SECONDS``.
    """

    sampler: str = "auto"
    colgather: str = "auto"
    stagecache: str = "auto"
    uxcol: str = "auto"
    uxcache: str = "auto"
    stagecache_persist: bool = True
    max_chunk_steps: int = 64
    chunk_target_seconds: float = 20.0

    def __post_init__(self):
        if self.sampler not in _SAMPLER_TO_ENV:
            raise ValueError(
                f"sampler must be one of {sorted(_SAMPLER_TO_ENV)}. Got {self.sampler!r}"
            )
        for name in ("colgather", "stagecache", "uxcol", "uxcache"):
            v = getattr(self, name)
            if v not in _TRISTATE:
                raise ValueError(f"{name} must be one of {_TRISTATE}. Got {v!r}")
        if not isinstance(self.max_chunk_steps, int) or self.max_chunk_steps < 0:
            raise ValueError(
                f"max_chunk_steps must be a non-negative int. Got {self.max_chunk_steps!r}"
            )
        if not isinstance(self.chunk_target_seconds, (int, float)) or (
            self.chunk_target_seconds < 0
        ):
            raise ValueError(
                "chunk_target_seconds must be a non-negative number. "
                f"Got {self.chunk_target_seconds!r}"
            )

    # -- env mapping ----------------------------------------------------------
    def _env_values(self) -> dict[str, str]:
        return {
            "PARCELS_TPU_SORT_MODE": _SAMPLER_TO_ENV[self.sampler],
            "PARCELS_TPU_BINNED": _SAMPLER_TO_ENV[self.sampler],
            "PARCELS_TPU_COLGATHER": self.colgather,
            "PARCELS_TPU_STAGECACHE": self.stagecache,
            "PARCELS_TPU_UXCOL": self.uxcol,
            "PARCELS_TPU_UXCACHE": self.uxcache,
            "PARCELS_TPU_STAGECACHE_PERSIST": "1" if self.stagecache_persist else "0",
            "PARCELS_TPU_MAX_CHUNK_STEPS": str(self.max_chunk_steps),
            "PARCELS_TPU_CHUNK_TARGET_SECONDS": str(self.chunk_target_seconds),
        }

    def resolved_key(self) -> tuple:
        """Effective (var, value) pairs after the override precedence —
        executor-cache key material (compiled programs specialize on these)."""
        return tuple(
            (k, os.environ.get(k, v)) for k, v in sorted(self._env_values().items())
        )

    @contextmanager
    def applied(self):
        """Apply the options for the duration of one execute() call.

        Values land in ``os.environ`` because that is where every
        trace-time gate reads its mode; explicitly-set env vars are left
        untouched (they override). Not thread-safe across concurrent
        execute() calls with different options — same-process concurrency
        shares one env, which matches the single-engine-per-process model.
        """
        applied = []
        try:
            for k, v in self._env_values().items():
                if k in os.environ:
                    continue
                os.environ[k] = v
                applied.append(k)
            yield
        finally:
            for k in applied:
                os.environ.pop(k, None)
