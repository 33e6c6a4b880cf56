"""What every run checks about its process and its machine."""

from __future__ import annotations

import subprocess
import sys

#: top-level module names no run may load: JAX and the JAX package the
#: program was ported from. Compared whole, since the program's own name
#: begins with the JAX package's.
BANNED = ("jax", "jaxlib", "flax", "parcels_tpu")


def banned_modules(modules=None) -> list:
    """The banned top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(BANNED))


def require_cards(torch, count: int) -> None:
    """Raise unless ``count`` CUDA cards are here: a run never falls back
    to the CPU."""
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is False")
    have = torch.cuda.device_count()
    if have < count:
        raise SystemExit(f"the cell needs {count} cards, {have} found")


def card_line(torch) -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        out = f"{torch.cuda.get_device_name(0)}, power limit not read ({type(e).__name__})"
    return out
