#!/usr/bin/env python3
"""`control.py` with one more planted fault, for a pipelined
configuration: the device map carry never receives its delta blobs, so a
chained step sees the map as the chain's first full upload left it (no
new keyframe pose, landmark, status or observation until the chain
restarts). The sync path uploads the whole map each frame and so does not
see this fault.

    python3 vo_bench/control_pipe.py --workload <cell> --seeds 11 12 --seconds 40
"""
import sys

import control


def carry_without_deltas():
    """fused.apply_mt_deltas returns the carry unchanged."""
    from plsvo_torch.pipeline import fused

    orig = fused.apply_mt_deltas
    fused.apply_mt_deltas = lambda mt, blob, **kw: mt

    def undo():
        fused.apply_mt_deltas = orig
    return undo


# the fault runs measure as long as the cell's own runs: a stale carry
# shows only once the map has moved on from the chain's first upload (on
# the CPU a 4 s window of the cruise orbit hid it, a 40 s one did not)
FAULT_SECONDS = 40.0

if __name__ == "__main__":
    control.FAULTS["carry_without_deltas"] = carry_without_deltas
    control.FAULT_SECONDS = FAULT_SECONDS
    sys.exit(control.main())
