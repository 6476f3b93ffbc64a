"""Batched multi-sequence sparse image alignment.

Port of `plsvo_tpu/parallel/batched.py`. The JAX package vmaps the whole
coarse-to-fine alignment over B sequences; here `sparse_img_align` takes
the leading batch axis itself (one set of launches serves every sequence,
and a sequence whose GN loop has stopped keeps its carry frozen, as under
vmap). `sharded_sparse_align` splits the batch over an axis of a device
mesh (`parallel/mesh.py`): each shard aligns its sequences on its own
device, with no communication.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from plsvo_torch.ops import sparse_align
from plsvo_torch.parallel.mesh import on_device, split_rows, unshard


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


def sharded_sparse_align(mesh, axis: str, pyr_ref, pyr_cur,
                         pts: sparse_align.AlignPoints,
                         segs: sparse_align.AlignSegments, R0: torch.Tensor,
                         t0: torch.Tensor, fx, fy, cx, cy, *,
                         levels: Tuple[int, ...] = (4, 3, 2),
                         n_iter: int = 30, patch_size: int = 4):
    """batched_sparse_align with the B sequences split over `axis` of
    `mesh`: each shard aligns B / n of them on its own device (every GN
    loop's stop test within its shard) and nothing crosses shards. The five
    outputs are concatenated in shard order on the first shard's device."""
    shards = split_rows((list(pyr_ref), list(pyr_cur), pts, segs, R0, t0),
                        mesh, axis)
    outs = []
    for dev, (pr, pc, p, sg, R, t) in zip(mesh.local_devices, shards):
        with on_device(dev):
            outs.append(batched_sparse_align(
                pr, pc, p, sg, R, t, fx, fy, cx, cy, levels=levels,
                n_iter=n_iter, patch_size=patch_size))
    return unshard(type(shards)(outs))
