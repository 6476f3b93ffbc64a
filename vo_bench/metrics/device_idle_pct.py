"""1 - the union of device activity / the wall time, over the traced
slices."""


def read(rec):
    wall = sum(s["wall_s"] for s in rec["slices"])
    busy = sum(s["busy_s"] for s in rec["slices"])
    return 100.0 * (1.0 - busy / wall) if wall > 0 else None
