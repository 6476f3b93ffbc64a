"""Batched multi-sequence sparse image alignment.

Port of `plsvo_tpu/parallel/batched.py`. The JAX package vmaps the whole
coarse-to-fine alignment over B sequences; here `sparse_img_align` takes
the leading batch axis itself (one set of launches serves every sequence,
and a sequence whose GN loop has stopped keeps its carry frozen, as under
vmap). `sharded_sparse_align` (the batch sharded over a device mesh) is
multi-device work and is not ported yet.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from plsvo_torch.ops import sparse_align


def batched_sparse_align(pyr_ref: Sequence[torch.Tensor],
                         pyr_cur: Sequence[torch.Tensor],
                         pts: sparse_align.AlignPoints,
                         segs: sparse_align.AlignSegments, R0: torch.Tensor,
                         t0: torch.Tensor, fx, fy, cx, cy, *,
                         levels: Tuple[int, ...] = (4, 3, 2), n_iter: int = 30,
                         patch_size: int = 4):
    """Align B sequences at once: levels (B, h_l, w_l), tables with a
    leading B on every leaf, R0 (B, 3, 3), t0 (B, 3). Returns (R, t,
    n_tracked_pts, n_tracked_segs, seg_alive), each with a leading B."""
    res = sparse_align.sparse_img_align(
        list(pyr_ref), list(pyr_cur), pts, segs, R0, t0, fx, fy, cx, cy,
        levels=levels, n_iter=n_iter, patch_size=patch_size)
    return res.R, res.t, res.n_tracked_pts, res.n_tracked_segs, res.seg_alive
