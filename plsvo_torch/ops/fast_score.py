"""FAST-10 corner mask + Shi-Tomasi score: the hand-written CUDA kernel
(`csrc/fast_score.cu`) and its plain PyTorch twin.

Port of `plsvo_tpu/ops/pallas_fast.py`. `fast_score` (one image or a
same-shape batch) and `fast_score_levels` (a list of images, such as the
levels of a pyramid: one launch for all) dispatch on the tensor's device:
a CPU tensor takes the plain twin, any other tensor launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from plsvo_torch import _build

launches = 0  # kernel launches (incremented only where the kernel launches)
MAX_IMAGES = 32  # images per launch (the kernel's argument table)


def fast_score_plain(img: torch.Tensor, threshold: float = 10.0):
    """(mask, score) from `fast_corner_mask` + `shi_tomasi_score`; img is
    (H, W) or (B, H, W)."""
    from plsvo_torch.image import shi_tomasi_score
    from plsvo_torch.ops.detection import fast_corner_mask

    if img.dim() == 3:
        outs = [fast_score_plain(im, threshold) for im in img]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))
    return fast_corner_mask(img, threshold), shi_tomasi_score(img)


def _launch(imgs, threshold: float):
    """One kernel launch per 32 images: (flat mask, flat score, offsets)
    with image i's outputs at [offsets[i], offsets[i + 1])."""
    global launches
    lib = _build.load_library()
    dev = imgs[0].device
    for im in imgs:
        if im.device != dev or dev.type != "cuda":
            raise ValueError(f"fast_score needs CUDA tensors on one card, got "
                             f"{im.device}")
        if im.dtype != torch.float32:
            raise TypeError(f"fast_score needs float32, got {im.dtype}")
        if im.dim() != 2:
            raise ValueError(f"expected (H, W) images, got {tuple(im.shape)}")
    imgs = [im.contiguous() for im in imgs]
    offs = [0]
    for im in imgs:
        offs.append(offs[-1] + im.numel())
    mask = torch.empty(offs[-1], dtype=torch.bool, device=dev)
    score = torch.empty(offs[-1], dtype=torch.float32, device=dev)
    # the C entry launches on the thread's current device: make it the
    # images' (a mesh may hold shards on several cards)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for a in range(0, len(imgs), MAX_IMAGES):
            part = range(a, min(a + MAX_IMAGES, len(imgs)))
            _build.check(lib.plsvo_fast_score_levels(
                _build.table(ctypes.c_void_p,
                             [imgs[i].data_ptr() for i in part]),
                _build.table(ctypes.c_void_p,
                             [mask.data_ptr() + offs[i] for i in part]),
                _build.table(ctypes.c_void_p,
                             [score.data_ptr() + 4 * offs[i] for i in part]),
                _build.table(ctypes.c_int,
                             [d for i in part for d in imgs[i].shape]),
                len(part), float(threshold), stream),
                "plsvo_fast_score_levels")
            launches += 1
    return mask, score, offs


def fast_score_levels_cuda(imgs, threshold: float = 10.0):
    """Launch the CUDA kernel once on a list of (H, W) f32 CUDA images (the
    levels of a pyramid); returns [(mask, score)] per image."""
    mask, score, offs = _launch(list(imgs), threshold)
    return [(mask[a:b].view(im.shape), score[a:b].view(im.shape))
            for im, a, b in zip(imgs, offs[:-1], offs[1:])]


def fast_score_cuda(img: torch.Tensor, threshold: float = 10.0):
    """Launch the CUDA kernel on an (H, W) or (B, H, W) f32 CUDA tensor (a
    same-shape batch is a list of B images: one launch)."""
    if img.dim() not in (2, 3):
        raise ValueError(f"expected (H, W) or (B, H, W), got {tuple(img.shape)}")
    batch = img if img.dim() == 3 else img[None]
    mask, score, _ = _launch(list(batch.unbind(0)), threshold)
    return mask.view(img.shape), score.view(img.shape)


def fast_score(img: torch.Tensor, threshold: float = 10.0):
    if img.device.type == "cpu":
        return fast_score_plain(img, threshold)
    return fast_score_cuda(img, threshold)


def fast_score_levels(imgs, threshold: float = 10.0):
    """[(mask, score)] of each (H, W) image of `imgs` (the levels of a
    pyramid): the plain twin per image for CPU tensors, else one kernel
    launch for all of them."""
    if imgs[0].device.type == "cpu":
        return [fast_score_plain(im, threshold) for im in imgs]
    return fast_score_levels_cuda(imgs, threshold)
