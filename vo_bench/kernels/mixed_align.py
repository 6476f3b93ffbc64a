"""Roofline count of K2 (`plsvo_torch.ops.mixed_align`, `csrc/mixed_align.cu`):
the mixed 2-D/1-D Gauss-Newton alignment loop over N rows.

Bytes: a valid row reads its 16x16 window, four 64-tap vectors, H^-1
(9 + 4), corner, d, uv0 and (w, h) once (f32) and its two flags, and
writes uv, mean_diff and the verdict once; an invalid row reads only its
flag and uv0 and writes its outputs. Operations: each row-iteration that
the data needs (rows still active before each iteration of the early-exit
loop, counted by the reference's plain copy of the loop) costs 64 taps x
(9 bilinear + 2 residual + 7 for the four weighted sums) + ~30 for
locate, solve and update.
"""
from vobench import peaks, reference

KERNEL = "mixed_align_kernel"
OUT_BYTES = 2 * 4 + 4 + 1
VALID_BYTES = 256 * 4 + 4 * 64 * 4 + (9 + 4 + 2 + 2 + 2 + 2) * 4 + 2 + OUT_BYTES
INVALID_BYTES = 1 + 2 * 4 + OUT_BYTES
OPS_PER_ROW_ITER = 64 * 18 + 30


def bound_s(call) -> float:
    """call: (inputs, keyword arguments) of one launch."""
    inputs, kw = call
    n, n_valid = inputs[0].shape[0], int(inputs[12].sum())
    row_iters = sum(reference.k2_reference(inputs, kw)[3])
    n_bytes = n_valid * VALID_BYTES + (n - n_valid) * INVALID_BYTES
    return peaks.bound_s(n_bytes, row_iters * OPS_PER_ROW_ITER)[0]
