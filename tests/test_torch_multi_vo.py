"""The port's BatchedVO in vmap mode (sync) on the CPU, against the JAX
package's and against the port's own single-sequence handlers, on
tests/test_multi_vo.py's B = 2 sequences (mirrors
tests/test_multi_vo.py::test_batched_vo_matches_individual). Both
packages' handlers take the JAX package's bootstrap RANSAC draws.

Bounds: per frame the same stage in both packages and camera centres
within 2 mm (the single-sequence pipeline tests' bound); the batched run
within 1e-4 of the port's solo handlers (the JAX test's bound); one K2
launch per call site for both sequences, counted at the mixed-align
wrapper (the kernel's own counter counts only launches on the card).
The sync vmap run of both packages takes ~80 s on one core."""
import numpy as np
import pytest
import torch

from plsvo_torch import convert
from plsvo_torch.camera import PinholeCamera as TCam
from plsvo_torch.ops import mixed_align as tma
from plsvo_torch.parallel.multi_vo import BatchedVO as TBVO
from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_tpu.config import fast_config
from plsvo_tpu.parallel.multi_vo import BatchedVO as JBVO

from test_multi_vo import make_sequences
from test_torch_pipeline import centers, jax_ransac_draws

torch.set_num_threads(1)

B = 2


def tcam():
    return TCam.create(320, 240, 250.0, 250.0, 160.0, 120.0)


def tcfg(cfg):
    import dataclasses

    return convert.config_from_dict(dataclasses.asdict(cfg))


def port_batched(cfg, mode="vmap"):
    bvo = TBVO(tcam(), tcfg(cfg), B, mode=mode, device="cpu")
    for vo in bvo.vos:
        vo.ransac_draws = jax_ransac_draws
    return bvo


def run_batched(bvo, seqs):
    out = [[] for _ in range(B)]
    for i in range(len(seqs[0])):
        rs = bvo.add_images([s[i] for s in seqs], i / 30.0)
        for b in range(B):
            if rs[b] is not None:
                out[b].append(rs[b])
    for rs in bvo.flush():
        for b in range(B):
            if rs[b] is not None:
                out[b].append(rs[b])
    return out


@pytest.fixture(scope="module")
def runs():
    seqs = make_sequences(np.random.default_rng(0), B=B)
    cfg = fast_config()
    jres = run_batched(JBVO(_jcam(), cfg, B, mode="vmap"), seqs)
    tb = port_batched(cfg)
    k2_calls = []
    orig = tma.mixed_align

    def counting(*a, **k):
        k2_calls.append(a[0].shape[0])
        return orig(*a, **k)

    tma.mixed_align = counting
    try:
        tres = run_batched(tb, seqs)
    finally:
        tma.mixed_align = orig
    solo = []
    for b in range(B):
        vo = tfh.FrameHandlerMono(tcam(), tcfg(cfg), device="cpu",
                                  ransac_draws=jax_ransac_draws)
        solo.append([vo.add_image(im, i / 30.0) for i, im in enumerate(seqs[b])])
    return dict(jres=jres, tres=tres, solo=solo, tb=tb, k2=k2_calls,
                n=len(seqs[0]))


def _jcam():
    from test_multi_vo import CAM
    return CAM


def test_batched_vo_tracks_like_jax(runs):
    assert all(vo.stage == tfh.STAGE_DEFAULT for vo in runs["tb"].vos)
    for b in range(B):
        jr, tr = runs["jres"][b], runs["tres"][b]
        assert len(tr) == len(jr) == runs["n"]
        assert [r.stage for r in tr] == [r.stage for r in jr]
        dflt = [k for k, r in enumerate(tr) if r.stage == tfh.STAGE_DEFAULT]
        assert len(dflt) >= 6
        d = np.linalg.norm(centers(tr) - centers(jr), axis=-1)
        assert d.max() < 2e-3, (b, d.max())


def test_batched_vo_matches_port_solo(runs):
    for b in range(B):
        for rs, rb in zip(runs["solo"][b], runs["tres"][b]):
            assert rs.stage == rb.stage
            np.testing.assert_allclose(rb.t_f_w, rs.t_f_w, atol=1e-4)
            np.testing.assert_allclose(rb.R_f_w, rs.R_f_w, atol=1e-4)


def test_one_k2_call_per_site_for_the_batch(runs):
    """Once the batch engages, every tracked frame makes three mixed-align
    calls for both sequences together: reprojection (B x 192 rows at the
    fast_config capacities), its retry and the seed update (the worked
    point seeds and both endpoints of every line seed)."""
    caps, pl = runs["tb"].cfg.caps, runs["tb"].cfg.pipeline
    n_rep = B * (caps.max_fts + 2 * caps.max_segs)
    n_retry = B * (max(caps.max_fts // 8, 8) + 2 * max(caps.max_segs // 8, 8))
    assert runs["k2"].count(n_rep) >= 6
    assert runs["k2"].count(n_retry) == runs["k2"].count(n_rep)
    n_pt = min(pl.seed_work_budget or caps.max_seeds, caps.max_seeds)
    n_seed = B * (n_pt + 2 * caps.max_seed_segs)
    assert runs["k2"].count(n_seed) == runs["k2"].count(n_rep)
