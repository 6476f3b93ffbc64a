"""Line-band descriptors (LBD) and binary Hamming matching, batched.

Port of `plsvo_tpu/ops/line_descriptor.py`. No pipeline path uses them;
they serve wide-baseline line matching. Each segment is sampled at S
points along its direction and, per sample, across B bands of W pixels
along its normal; per band, the mean and standard deviation of the four
signed gradient responses (g_n > 0, g_n < 0, g_d > 0, g_d < 0) make the
float descriptor, whose mean and std halves are L2-normalized apart,
clipped at 0.4 and renormalized (Zhang & Koch 2013). A 256-bit code
compares fixed random pairs of descriptor entries: the pairs are the JAX
package's, `jax.random.randint` under `PRNGKey(1234)`, drawn in numpy
(`utils.threefry`). Matching is the full pairwise Hamming distance (an f32
product of bit-planes: sums of 0/1 up to 256 are exact in f32), mutual
nearest neighbour and a ratio test.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from plsvo_torch.image import bilinear_sample
from plsvo_torch.utils import threefry

f32_inv_sqrt2 = 0.7071067811865476  # the whole descriptor stays unit-norm


class LineDescriptors(NamedTuple):
    float_desc: torch.Tensor  # (N, 8 * n_bands) L2-normalized
    binary: torch.Tensor  # (N, n_bits) uint8 in {0, 1}
    valid: torch.Tensor  # (N,)


def binarization_pairs(dim: int, n_bits: int = 256):
    """The (ia, ib) descriptor entries each bit compares: the JAX package's
    `randint(split(PRNGKey(1234))[k], (n_bits,), 0, dim)`."""
    ka, kb = threefry.split(threefry.prng_key(1234))
    return (threefry.randint(ka, n_bits, dim), threefry.randint(kb, n_bits, dim))


def compute_lbd(img: torch.Tensor, sp: torch.Tensor, ep: torch.Tensor,
                valid: torch.Tensor, *, n_samples: int = 16, n_bands: int = 9,
                band_width: int = 3, n_bits: int = 256) -> LineDescriptors:
    """Band descriptors of N segments (sp, ep: (N, 2) px) of an (H, W)
    image, on the image's device."""
    N = sp.shape[0]
    dev = img.device
    d = ep - sp
    length = torch.linalg.norm(d, dim=-1, keepdim=True)
    d = d / length.clamp_min(1e-6)  # line direction (N, 2)
    n = torch.stack([-d[:, 1], d[:, 0]], -1)  # normal

    alphas = torch.linspace(0.0, 1.0, n_samples, device=dev)
    half_span = (n_bands * band_width) / 2.0
    offs = torch.arange(n_bands * band_width, device=dev) - half_span + 0.5
    base = sp[:, None, :] + alphas[None, :, None] * (ep - sp)[:, None, :]
    pos = base[:, :, None, :] + offs[None, None, :, None] * n[:, None, None, :]

    gx_img = 0.5 * (torch.roll(img, -1, 1) - torch.roll(img, 1, 1))
    gy_img = 0.5 * (torch.roll(img, -1, 0) - torch.roll(img, 1, 0))
    gx, okx = bilinear_sample(gx_img, pos)
    gy, oky = bilinear_sample(gy_img, pos)
    ok = (okx & oky).flatten(1).all(1) & valid

    g_d = gx * d[:, None, None, 0] + gy * d[:, None, None, 1]  # (N, S, B*W)
    g_n = gx * n[:, None, None, 0] + gy * n[:, None, None, 1]
    parts = (g_n.clamp_min(0.0), (-g_n).clamp_min(0.0),
             g_d.clamp_min(0.0), (-g_d).clamp_min(0.0))
    means, stds = [], []
    for g in parts:
        gr = g.reshape(N, n_samples, n_bands, band_width)
        means.append(gr.mean((1, 3)))
        stds.append(gr.std((1, 3), correction=0))

    def norm_clip(x, clip=0.4):
        x = x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-8)
        x = x.clamp_max(clip)
        return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-8)

    desc = torch.cat([norm_clip(torch.cat(means, -1)),
                      norm_clip(torch.cat(stds, -1))], -1) * f32_inv_sqrt2
    ia, ib = (torch.as_tensor(i, device=dev)
              for i in binarization_pairs(desc.shape[-1], n_bits))
    bits = (desc[:, ia] > desc[:, ib]).to(torch.uint8)
    return LineDescriptors(float_desc=desc, binary=bits, valid=ok)


class LineMatches(NamedTuple):
    idx: torch.Tensor  # (N,) best match in the other set (or -1)
    dist: torch.Tensor  # (N,) Hamming distance
    ok: torch.Tensor  # (N,) mutual nearest neighbour and ratio test passed


def match_binary(a: LineDescriptors, b: LineDescriptors, *, max_dist: int = 80,
                 ratio: float = 0.85) -> LineMatches:
    """Mutual-nearest Hamming matching with a Lowe-style ratio test."""
    abits = a.binary.to(torch.float32)
    bbits = b.binary.to(torch.float32)
    # hamming = sum a + sum b - 2 a.b for 0/1 bits
    ham = (abits.sum(-1, keepdim=True) + bbits.sum(-1)[None]
           - 2.0 * (abits @ bbits.T)).to(torch.int32)
    big = a.binary.shape[-1] + 1
    ham = torch.where(a.valid[:, None] & b.valid[None, :], ham,
                      torch.full_like(ham, big))
    NA = abits.shape[0]
    rows = torch.arange(NA, device=ham.device)
    best = torch.argmin(ham, -1)
    d1 = ham[rows, best]
    ham2 = ham.clone()
    ham2[rows, best] = big
    d2 = ham2.min(-1).values
    mutual = torch.argmin(ham, 0)[best] == rows
    ok = (a.valid & (d1 <= max_dist) & mutual
          & (d1.to(torch.float32) < ratio * d2.clamp_min(1).to(torch.float32)))
    return LineMatches(idx=torch.where(ok, best, torch.full_like(best, -1)),
                       dist=d1, ok=ok)
