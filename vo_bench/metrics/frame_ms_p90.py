"""90th percentile of the host time of every call in the window,
keyframe frames included."""
import numpy as np


def read(rec):
    if not rec["call_s"]:
        return None
    return 1e3 * float(np.percentile(rec["call_s"], 90))
