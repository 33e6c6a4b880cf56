"""Package logger (capability parity with reference src/parcels/_logger.py:9-13)."""

import logging
import sys

logger = logging.getLogger("parcels_tpu_torch")
if not logger.handlers:
    _handler = logging.StreamHandler(sys.stdout)
    _handler.setFormatter(logging.Formatter("%(levelname)s: %(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)

__all__ = ["logger"]
