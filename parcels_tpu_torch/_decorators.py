"""Deprecation decorators (capability parity with reference _decorators.py:12-56)."""

from __future__ import annotations

import functools
import warnings
from collections.abc import Callable

__all__ = ["deprecated", "deprecated_made_private"]

PACKAGE = "parcels-tpu"


def deprecated(msg: str = "") -> Callable:
    """Mark a function deprecated: calling it emits a DeprecationWarning."""
    if msg:
        msg = " " + msg

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            warnings.warn(
                f"`{func.__qualname__}` is deprecated and will be removed in a "
                f"future release of {PACKAGE}.{msg}",
                category=DeprecationWarning,
                stacklevel=3,
            )
            return func(*args, **kwargs)

        wrapper.__doc__ = f"{wrapper.__doc__ or ''}\n\n.. deprecated::{msg}".strip()
        return wrapper

    return decorator


def deprecated_made_private(func: Callable) -> Callable:
    return deprecated(
        "It has moved to the internal API as it is not expected to be directly "
        "used by the end-user."
    )(func)
