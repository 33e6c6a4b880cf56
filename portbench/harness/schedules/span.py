"""One release at the field's first time, run in pieces of ``execute_h``
until the next piece would pass the field's last time, then released again
from the same positions."""

import numpy as np


def schedule(traffic: dict, field_end_s: float):
    piece = float(traffic["execute_h"]) * 3600.0
    end = np.floor(field_end_s / piece) * piece
    if end <= 0:
        raise ValueError("the field's span is shorter than one execute piece")
    while True:
        yield 0.0, end, piece
