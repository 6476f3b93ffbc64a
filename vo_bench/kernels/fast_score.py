"""Roofline count of K1 (`plsvo_torch.ops.fast_score`, `csrc/fast_score.cu`):
FAST-10 mask and Shi-Tomasi score of every pixel of every image of a call.

The least work per pixel: read the f32 image once, write the bool mask
and the f32 score once (9 B); 34 FAST operations (two threshold adds and
32 ring compares), 7 for the gradients and their products, 3 x 4 for
running-sum boxes (one add and one subtract per axis) and ~10 for the
eigenvalue (63 operations).
"""
from vobench import peaks

KERNEL = "fast_score_kernel"
BYTES_PER_PX = 4 + 1 + 4
OPS_PER_PX = 34 + 7 + 12 + 10


def bound_s(call) -> float:
    """call: the (H, W) shapes of the images of one launch."""
    px = sum(h * w for h, w in call)
    return peaks.bound_s(px * BYTES_PER_PX, px * OPS_PER_PX)[0]
