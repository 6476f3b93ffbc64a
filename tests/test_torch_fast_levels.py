"""The multi-level FAST + Shi-Tomasi entry (`fast_score_levels`) on the CPU:
its plain path against the JAX package level by level, and
`detect_fast_grid` through it against JAX's `detect_fast_grid`. The CUDA
kernel behind the same entry is held against the plain path in
tests/test_torch_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plsvo_torch import image as ti
from plsvo_torch.ops import detection as td
from plsvo_torch.ops import fast_score as tfs
from plsvo_tpu import image as ji
from plsvo_tpu.ops import detection as jd


def _pyramid(seed=5, shape=(120, 200)):
    """A small seeded three-level pyramid with blobs that give corners on
    every level."""
    gen = np.random.default_rng(seed)
    img = gen.uniform(0, 120, shape).astype(np.float32)
    for _ in range(24):
        y, x = gen.integers(4, shape[0] - 20), gen.integers(4, shape[1] - 20)
        h, w = gen.integers(6, 18, 2)
        img[y:y + h, x:x + w] += gen.uniform(60, 130)
    img = np.clip(img, 0, 255).astype(np.float32)
    return img, ti.build_pyramid(torch.as_tensor(img), 3)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_levels_plain_match_jax(level):
    img, pyr = _pyramid()
    before = tfs.launches
    out = tfs.fast_score_levels(pyr, 10.0)
    assert tfs.launches == before  # CPU tensors take the plain twin
    assert len(out) == 3
    jl = ji.build_pyramid(jnp.asarray(img), 3)[level]
    mask, score = out[level]
    assert tuple(mask.shape) == tuple(jl.shape) == tuple(pyr[level].shape)
    np.testing.assert_array_equal(
        mask.numpy(), np.asarray(jd.fast_corner_mask(jl, 10.0)))
    assert int(mask.sum()) > 20
    # both box filters are f32 cumsums, summed in different association by
    # torch and XLA; on this high-contrast pyramid they differ by up to
    # 2.3e-4 relative (level 0)
    np.testing.assert_allclose(score.numpy(), np.asarray(ji.shi_tomasi_score(jl)),
                               rtol=1e-3, atol=1e-3)


def test_levels_equal_per_image_plain():
    _, pyr = _pyramid(seed=9)
    for im, (m, s) in zip(pyr, tfs.fast_score_levels(pyr, 12.0)):
        mp, sp = tfs.fast_score_plain(im, 12.0)
        assert torch.equal(m, mp) and torch.equal(s, sp)


def test_detect_fast_grid_scores_all_levels_at_once(monkeypatch):
    """detect_fast_grid makes one fast_score_levels call for the whole
    pyramid, and its cells equal JAX's."""
    img, pyr = _pyramid(seed=11, shape=(160, 240))
    calls = []
    orig = tfs.fast_score_levels

    def spy(imgs, threshold=10.0):
        calls.append(len(imgs))
        return orig(imgs, threshold)

    monkeypatch.setattr(tfs, "fast_score_levels", spy)
    gt = td.detect_fast_grid(pyr, cell_size=25, score_threshold=20.0)
    assert calls == [3]
    gj = jd.detect_fast_grid(ji.build_pyramid(jnp.asarray(img), 3),
                             cell_size=25, score_threshold=20.0)
    v = np.asarray(gj.valid)
    np.testing.assert_array_equal(gt.valid.numpy(), v)
    assert v.sum() > 20
    np.testing.assert_array_equal(gt.uv.numpy()[v], np.asarray(gj.uv)[v])
    np.testing.assert_array_equal(gt.level.numpy()[v], np.asarray(gj.level)[v])
    np.testing.assert_allclose(gt.score.numpy(), np.asarray(gj.score),
                               rtol=1e-4, atol=1e-3)
