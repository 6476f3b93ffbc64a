"""The port's BatchedVO in pipelined vmap mode and in streams mode on the
CPU (mirrors tests/test_multi_vo.py::test_batched_vo_pipelined_matches_sync
and ::test_batched_vo_streams_mode, with their bounds). The comparison
with the JAX package's pipelined BatchedVO is
tests/test_torch_multi_vo_pipelined_jax.py."""
import dataclasses

import numpy as np
import pytest
import torch

from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_torch.pipeline import fused as tfused
from plsvo_torch.pipeline.state import validate_map
from plsvo_tpu.config import fast_config

from test_multi_vo import make_sequences
from test_torch_multi_vo import B, port_batched, run_batched, tcam, tcfg
from test_torch_pipeline import jax_ransac_draws

torch.set_num_threads(1)

DEPTH = 3


def pipelined(cfg):
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, pipelined=True, pipeline_depth=DEPTH))


@pytest.fixture(scope="module")
def seqs():
    return make_sequences(np.random.default_rng(0), B=B)


@pytest.fixture(scope="module")
def vmap_runs(seqs):
    sync = run_batched(port_batched(fast_config()), seqs)
    pb = port_batched(pipelined(fast_config()))
    pipe = run_batched(pb, seqs)
    carries = pb.sync_carry()
    return dict(sync=sync, pipe=pipe, pb=pb, carries=carries)


def default_ids(results):
    return [r.frame_id for r in results if r.stage == tfh.STAGE_DEFAULT]


def test_pipelined_vmap_matches_sync_vmap(vmap_runs, seqs):
    n = len(seqs[0])
    assert all(vo.stage == tfh.STAGE_DEFAULT for vo in vmap_runs["pb"].vos)
    for b in range(B):
        pipe, sync = vmap_runs["pipe"][b], vmap_runs["sync"][b]
        # every frame delivered exactly once, in order
        assert [r.frame_id for r in pipe] == list(range(n))
        assert default_ids(pipe) == default_ids(sync)
        np.testing.assert_allclose(pipe[-1].t_f_w, sync[-1].t_f_w, atol=5e-3)


def test_pipelined_vmap_carry_equals_mirror(vmap_runs):
    for b, vo in enumerate(vmap_runs["pb"].vos):
        assert tfused.carry_mismatches(
            vmap_runs["carries"][b], tfused.map_tables_upload(vo.map)) == []
        assert validate_map(vo.map) == []


def test_streams_mode_matches_solo(seqs):
    cfg = tcfg(fast_config())
    solo = []
    for b in range(B):
        vo = tfh.FrameHandlerMono(tcam(), cfg, device="cpu",
                                  ransac_draws=jax_ransac_draws)
        solo.append([vo.add_image(im, i / 30.0) for i, im in enumerate(seqs[b])])
    bvo = port_batched(pipelined(fast_config()), mode="streams")
    assert bvo.mode == "streams"
    got = run_batched(bvo, seqs)
    for b in range(B):
        assert [r.frame_id for r in got[b]] == list(range(len(seqs[b])))
        assert default_ids(got[b]) == default_ids(solo[b])
        np.testing.assert_allclose(got[b][-1].t_f_w, solo[b][-1].t_f_w,
                                   atol=5e-3)


def test_pipelined_vmap_failure_in_the_last_drain_keeps_carry_exact(seqs):
    """A sequence whose frame fails in flush()'s drain drops its later
    frames, whose batched steps already wrote the stacked carry; the next
    batched step would start from full uploads, and so does sync_carry()."""
    bvo = port_batched(pipelined(fast_config()))
    for i in range(len(seqs[0])):
        bvo.add_images([s[i] for s in seqs], i / 30.0)
    assert bvo._bq and all(vo.stage == tfh.STAGE_DEFAULT for vo in bvo.vos)
    bvo.vos[1]._tracking_quality = (
        lambda n_pt, n_seg: tfh.QUALITY_INSUFFICIENT)
    bvo.flush()
    assert bvo.vos[0].stage == tfh.STAGE_DEFAULT
    assert bvo.vos[1].stage == tfh.STAGE_RELOCALIZING
    for vo, carry in zip(bvo.vos, bvo.sync_carry()):
        assert tfused.carry_mismatches(
            carry, tfused.map_tables_upload(vo.map)) == []
