"""K1's share of its roofline: the sum over its launches in the traced
slices of the least time (kernels/fast_score.py) / the sum of their
device durations in the profiler's trace."""


def read(rec):
    pairs = rec["kernel_pairs"].get("fast_score", [])
    d = sum(p[1] for p in pairs)
    return 100.0 * sum(p[0] for p in pairs) / d if d > 0 else None
