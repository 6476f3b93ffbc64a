"""plsvo_torch — semi-direct monocular visual odometry (points + edgelets)
in PyTorch, with hand-written CUDA kernels for Hopper.

A port of `plsvo_tpu` (the JAX reference, which it never imports):

  lie / camera / batlin / image / config   — foundations
  ops/                                     — per-frame numeric ops; the two
                                             CUDA kernels sit behind
                                             ops/fast_score.py and
                                             ops/mixed_align.py
  pipeline/                                — state tables + the frame step
                                             + the FrameHandlerMono stage
                                             machine (sync path)
  utils/                                   — synthetic scenes, trajectories
                                             (TUM IO), datasets, image
                                             codec, checkpoints, viz,
                                             profiling
  native/                                  — the image loader (C++, g++)
  csrc/                                    — CUDA sources, built by _build.py
  run_pipeline.py                          — the command-line entry point

Entry points: `pipeline.frame_handler.FrameHandlerMono(cam, cfg, device)`
and `python -m plsvo_torch.run_pipeline`; device=None means "cuda".
"""

import torch

# f32 everywhere: the JAX package computes in f32 at the highest matmul
# precision, so TF32 stays off for matmuls and convolutions on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from plsvo_torch import camera, config, image, lie  # noqa: E402,F401
from plsvo_torch.config import Config, default_config, fast_config  # noqa: E402,F401

__version__ = "0.1.0"
