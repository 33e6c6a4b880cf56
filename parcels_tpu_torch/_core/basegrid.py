"""Shared grid base class (torch).

Port of the JAX package's ``_core/basegrid.py``: the common interface of
:class:`XGrid` and :class:`UxGrid` (axis list, flat/spherical mesh, ravel
and unravel of per-axis cell indices into the cached element index ``ei``)
and a host-side ``search`` convenience that returns numpy arrays.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch

__all__ = ["BaseGrid"]


class BaseGrid(ABC):
    """Base class for :class:`XGrid` and :class:`UxGrid`."""

    axes: list[str]

    @property
    @abstractmethod
    def mesh(self):
        """The flat/spherical mesh geometry of the grid."""

    @abstractmethod
    def get_axis_dim(self, axis: str) -> int:
        """Cell count along ``axis``."""

    @abstractmethod
    def ravel_index(self, zi, yi, xi):
        """Combine per-axis cell indices into the scalar element index ``ei``."""

    @abstractmethod
    def unravel_index(self, ei):
        """Split ``ei`` back into per-axis cell indices ``(zi, yi, xi)``."""

    @abstractmethod
    def device_arrays(self, device, dtype=np.float32) -> dict:
        """Coordinate and lookup tensors of the grid on ``device``."""

    @abstractmethod
    def lookup_meta(self) -> dict | None:
        """Static metadata of the cold-start lookup raster (origin/step), if any."""

    @abstractmethod
    def make_view(self, garrs: dict):
        """Device grid view over ``garrs`` for the engine."""

    @abstractmethod
    def _search_device(self, garrs: dict, z, y, x, ei):
        """Device search returning ``{axis: {"index", "bcoord"}}`` of tensors."""

    def search(self, z, y, x, ei=None, device=None) -> dict:
        """Locate point(s) on the grid: ``{axis: {"index", "bcoord"}}`` as numpy.

        Axes are ``Z/Y/X`` on structured grids and ``Z/FACE`` on
        unstructured ones. Negative indices are the search sentinels (-1
        right out of bounds, -2 left out of bounds or through the surface,
        -3 search error). Scalars become length-1 arrays. ``ei`` warm-starts
        the horizontal search from an element index this method returned.
        ``device`` defaults to ``cuda`` and raises without CUDA, as a
        fieldset does; pass ``device="cpu"`` to search on the CPU.
        """
        from parcels_tpu_torch._core.fieldset import resolve_device

        device = resolve_device(device)

        def tensor(v, dtype):
            return torch.as_tensor(np.atleast_1d(np.asarray(v, dtype=dtype)), device=device)

        z, y, x = (tensor(v, np.float32) for v in (z, y, x))
        if ei is not None:
            ei = tensor(ei, np.int32)
        res = self._search_device(self.device_arrays(device), z, y, x, ei)
        return {
            ax: {"index": v["index"].cpu().numpy(), "bcoord": v["bcoord"].cpu().numpy()}
            for ax, v in res.items()
        }
