"""Releases back to back, release k at ``starts_h[k mod len]``, each run
for ``length_h`` in one ``execute`` call."""


def schedule(traffic: dict, field_end_s: float):
    sch = traffic["schedule"]
    length = float(sch["length_h"]) * 3600.0
    k = 0
    while True:
        start = float(sch["starts_h"][k % len(sch["starts_h"])]) * 3600.0
        if start + length > field_end_s:
            raise ValueError("a forecast runs past the field's last time")
        yield start, start + length, length
        k += 1
