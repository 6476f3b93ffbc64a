"""The batched step and BatchedVO over a 2-shard CPU mesh (the port's
`track_frame_step_list(mesh=)` and `BatchedVO(mesh=)`) on the CPU.

- The sharded step against the JAX package's shard-mapped
  `track_frame_step_list` on its virtual CPU devices, from the JAX
  handler's state at frame 22 of the golden sequence (the state and
  bounds of tests/test_torch_step.py): two sequences, frames 22 and 23.
- BatchedVO(mesh=) on tests/test_multi_vo.py's B = 2 sequences (16
  frames, fast_config()), sync, with test_multi_vo.py's mesh asserts and
  each sequence's camera centres within 2 mm of the unsharded BatchedVO's
  per frame; pipelined at depth 4, every frame delivered once and each
  synced carry equal to its mirror; B = 3 on 2 shards runs unsharded
  (counted), equal to no mesh."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plsvo_torch.image import build_pyramid as tbuild_pyramid
from plsvo_torch.parallel.mesh import Mesh, Shards, unshard
from plsvo_torch.parallel.multi_vo import BatchedVO as TBVO
from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_torch.pipeline import fused as tfused
from plsvo_tpu.config import fast_config
from plsvo_tpu.image import build_pyramid
from plsvo_tpu.pipeline import fused as jfused
from plsvo_tpu.pipeline.frame_handler import STAGE_DEFAULT
from plsvo_tpu.pipeline.frame_handler import FrameHandlerMono as JFH

from test_multi_vo import make_sequences
from test_torch_multi_vo import run_batched, tcam, tcfg
from test_torch_pipeline import centers, jax_ransac_draws
from test_torch_step import (CAM, STEP_FRAME, golden_frames,
                             port_handler_from, slice_config)

torch.set_num_threads(1)


def cpu_mesh(n=2):
    return Mesh(["cpu"] * n, ("seq",))


@pytest.fixture(scope="module")
def steps():
    """Both packages' 2-sequence step over a 2-shard mesh from the same
    handler state; sequence b tracks frame STEP_FRAME + b."""
    cfg = slice_config()
    imgs = golden_frames(STEP_FRAME + 2)
    jvo = JFH(CAM, cfg)
    for i in range(STEP_FRAME):
        jvo.add_image(imgs[i], i / 30.0)
    assert jvo.stage == STAGE_DEFAULT
    tvo = port_handler_from(jvo, cfg)
    jvo.map.mt_mark_clean()
    new = [imgs[STEP_FRAME], imgs[STEP_FRAME + 1]]
    j_in = jvo._step_inputs(build_pyramid(jnp.asarray(new[0]), jvo.n_levels))
    per_seq = tuple(
        (j_in[0], build_pyramid(jnp.asarray(im), jvo.n_levels), j_in[2],
         j_in[3], j_in[4], j_in[7]) for im in new)
    stack = lambda t: jax.tree.map(lambda a: jnp.stack([a, a]), t)  # noqa: E731
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("seq",))
    jstep = jfused.track_frame_step_list(
        per_seq, stack(jvo.pt_seeds), stack(jvo.ln_seeds), *j_in[8:],
        mesh=jmesh, mesh_axis="seq", **jvo._step_kwargs())

    t_in = tvo._step_inputs(None)
    pyrs = [tbuild_pyramid(torch.as_tensor(im), tvo.n_levels) for im in new]
    atlas = t_in[2]
    tstep = tfused.track_frame_step_list(
        [t_in[0]] * 2, [torch.stack([p[lv] for p in pyrs])
                        for lv in range(tvo.n_levels)],
        atlas._replace(flat=torch.stack([atlas.flat] * 2)), [t_in[3]] * 2,
        [t_in[4]] * 2, torch.tensor([[t_in[7], tvo.frame_id]] * 2),
        tfused.stack_trees([t_in[5]] * 2), tfused.stack_trees([t_in[6]] * 2),
        *t_in[8:], mesh=cpu_mesh(), mesh_axis="seq", **tvo._step_kwargs())
    return jstep, tstep


def test_sharded_step_matches_jax(steps):
    """tests/test_torch_step.py's bounds for each sequence: pose within
    1e-4, matched landmarks and live seeds 98% the same, seed states
    within 1e-3."""
    jstep, tstep = steps
    assert isinstance(tstep, Shards) and len(tstep) == 2
    t = unshard(tstep)
    for b in range(2):
        np.testing.assert_allclose(t.fused.R_f_w[b].numpy(),
                                   np.asarray(jstep.fused.R_f_w[b]), atol=1e-4)
        np.testing.assert_allclose(t.fused.t_f_w[b].numpy(),
                                   np.asarray(jstep.fused.t_f_w[b]), atol=1e-4)
        jpt, tpt = jstep.fused.pt, t.fused.pt
        j_ids = set(np.asarray(jpt.lm_idx[b])[np.asarray(jpt.matched[b])]
                    .tolist())
        t_ids = set(tpt.lm_idx[b].numpy()[tpt.matched[b].numpy()].tolist())
        assert len(j_ids) >= 20
        assert len(j_ids & t_ids) >= 0.98 * max(len(j_ids), len(t_ids))
        js, ts = jstep.pt_seeds, t.pt_seeds
        j_alive, t_alive = np.asarray(js.alive[b]), ts.alive[b].numpy()
        both = j_alive & t_alive
        assert both.sum() >= 20 and (j_alive == t_alive).mean() >= 0.98
        for name in ("mu", "sigma2", "a", "b"):
            np.testing.assert_allclose(
                getattr(ts, name)[b].numpy()[both],
                np.asarray(getattr(js, name)[b])[both], rtol=1e-3,
                err_msg=name)


def batched(cfg, B, mesh):
    bvo = TBVO(tcam(), tcfg(cfg), B, mesh=mesh, mode="vmap",
               device=None if mesh is not None else "cpu")
    for vo in bvo.vos:
        vo.ransac_draws = jax_ransac_draws
    return bvo


def pipelined(cfg, depth):
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, pipelined=True, pipeline_depth=depth))


@pytest.fixture(scope="module")
def seqs():
    return make_sequences(np.random.default_rng(0), B=2, n_frames=16)


@pytest.mark.parametrize("depth", [0, 4], ids=["sync", "pipelined_d4"])
def test_batched_vo_over_a_mesh(seqs, depth):
    cfg = fast_config() if depth == 0 else pipelined(fast_config(), depth)
    bm = batched(cfg, 2, cpu_mesh())
    got = run_batched(bm, seqs)
    ref = run_batched(batched(cfg, 2, None), seqs)
    assert bm.device == torch.device("cpu") and bm.unsharded_steps == 0
    # tests/test_multi_vo.py::test_batched_vo_sharded_over_mesh
    assert all(vo.stage == STAGE_DEFAULT for vo in bm.vos)
    last = [got[b][-1] for b in range(2)]
    assert all(r is not None for r in last)
    assert min(r.n_pt_matches for r in last) > 20
    for b in range(2):
        assert [r.frame_id for r in got[b]] == list(range(len(seqs[b])))
        assert [r.stage for r in got[b]] == [r.stage for r in ref[b]]
        d = np.linalg.norm(centers(got[b]) - centers(ref[b]), axis=-1)
        assert d.max() < 2e-3, (b, d.max())
    if depth:
        assert isinstance(bm._mt_stack, Shards)
        for vo, carry in zip(bm.vos, bm.sync_carry()):
            assert tfused.carry_mismatches(
                carry, tfused.map_tables_upload(vo.map)) == []


def test_indivisible_batch_runs_unsharded():
    """B = 3 over 2 shards: every batched step runs unsharded on the first
    device (as the JAX package's _mesh_for falls back), counted, and the
    results equal the run without a mesh."""
    seqs3 = make_sequences(np.random.default_rng(0), B=3, n_frames=12)

    def run(bvo):
        rs = [bvo.add_images([s[i] for s in seqs3], i / 30.0)
              for i in range(12)]
        return [[r[b] for r in rs] for b in range(3)]

    bm = batched(fast_config(), 3, cpu_mesh())
    got = run(bm)
    ref = run(batched(fast_config(), 3, None))
    n_batched = sum(all(got[b][i].stage == tfh.STAGE_DEFAULT
                        for b in range(3)) for i in range(12))
    assert bm.unsharded_steps >= n_batched - 1 > 0
    for b in range(3):
        for r, s in zip(got[b], ref[b]):
            assert r.stage == s.stage
            np.testing.assert_array_equal(r.t_f_w, s.t_f_w)


def test_mesh_options_checked():
    with pytest.raises(ValueError, match="streams"):
        TBVO(tcam(), tcfg(fast_config()), 2, mesh=cpu_mesh(), mode="streams")
    with pytest.raises(ValueError, match="no axis"):
        TBVO(tcam(), tcfg(fast_config()), 2, mesh=cpu_mesh(), axis="batch")
    with pytest.raises(ValueError, match="first device"):
        TBVO(tcam(), tcfg(fast_config()), 2, mesh=cpu_mesh(), device="meta")
