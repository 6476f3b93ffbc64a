"""The pipelined mode's chained device step, the port against the JAX
package, on golden 320x240 frames.

The JAX FrameHandlerMono runs the golden sequence with `fast_config()`
(points, edgelets, lines, local BA) up to frame 26, and its state crosses
to a port handler. Both packages then run track_frame_step(emit_next=True)
on frame 26 from that state. Between the two steps both mirrors take the
same host changes, whose delta blobs must be equal. The second step,
track_frame_step_tables on the raw frame 27, runs in both packages on the
JAX package's first-step outputs (next-frame inputs, map carry, seed
tables) and the blob. build_next_inputs and apply_mt_deltas are held to
JAX on identical inputs: masks and the carry exactly, floats within 1e-5.
The steps themselves use tests/test_torch_step.py's tolerances: pose atol
1e-4, seed tables rtol 1e-3.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plsvo_torch import convert
from plsvo_torch.image import build_pyramid as tbuild_pyramid
from plsvo_torch.pipeline import fused as tfused
from plsvo_torch.pipeline import reprojector as trep
from plsvo_torch.pipeline.state import ST_GOOD
from plsvo_tpu.config import fast_config
from plsvo_tpu.image import build_pyramid
from plsvo_tpu.pipeline import fused as jfused
from plsvo_tpu.pipeline.frame_handler import FrameHandlerMono as JFH

from test_torch_pipeline import CAM
from test_torch_pipeline_lines import port_handler_from
from test_torch_step import golden_frames

STEP_FRAME = 26  # the JAX run matches line landmarks from frame 25 on
WIDTHS = (tfused.MT_DELTA_DP, tfused.MT_DELTA_DL, tfused.MT_DELTA_OP,
          tfused.MT_DELTA_OL, tfused.MT_DELTA_NE)

# One intra-op thread per test process, as in test_torch_pipeline.py.
torch.set_num_threads(1)

_TYPES = {cls.__name__: cls for cls in (
    tfused.LastFrameTables, tfused.MapTables, tfused.NextFrameInputs,
    tfused.FusedResult, trep.ReprojResult, trep.ReprojSegResult)}


def to_torch(tree):
    """A tree of JAX arrays (NamedTuples of this package's names, tuples)
    as the port's types with CPU tensors of the same dtypes."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        vals = [to_torch(x) for x in tree]
        cls = _TYPES.get(type(tree).__name__)
        return cls(*vals) if cls else tuple(vals)
    return torch.as_tensor(np.asarray(tree))


def seeds_to_torch(pt, ln):
    return (convert.point_seeds_from_numpy(
                {k: np.asarray(v) for k, v in pt._asdict().items()}, device="cpu"),
            convert.line_seeds_from_numpy(
                {k: np.asarray(v) for k, v in ln._asdict().items()}, device="cpu"))


def host_changes(m, rng):
    """Host map changes between two steps: promotions, a new point and a
    new line on the newest keyframe."""
    live = np.where(m.pt_status == 2)[0][:5]
    m.pt_status[live] = ST_GOOD
    m.mark_mt_dirty("pt", live)
    kf = int(np.argmax(np.where(m.kf_occupied, m.kf_frame_id, -1)))
    p = m.new_point(rng.normal(size=3) + (0, 0, 1), kf, rng.uniform(20, 200, 2),
                    rng.normal(size=3), 0)
    ln = m.new_line(rng.normal(size=3) + (0, 0, 1), rng.normal(size=3) + (0, 0, 1),
                    kf, rng.uniform(20, 200, 2), rng.uniform(20, 200, 2),
                    rng.normal(size=3), rng.normal(size=3), 0)
    return p, ln


@pytest.fixture(scope="module")
def chain():
    cfg = fast_config()
    imgs = golden_frames(STEP_FRAME + 2)
    jvo = JFH(CAM, cfg)
    for i in range(STEP_FRAME):
        jvo.add_image(imgs[i], i / 30.0)
    tvo = port_handler_from(jvo, cfg)
    jvo.map.mt_mark_clean()
    jmt0 = jfused.map_tables_from_state(jvo.map)
    m = jvo.map
    optim = [np.clip(a, -1, 2**24 - 1).astype(np.float32)
             for a in (m.pt_last_optim, m.ln_last_optim)]
    img1, img2 = imgs[STEP_FRAME], imgs[STEP_FRAME + 1]
    jstep1 = jfused.track_frame_step(
        *jvo._step_inputs(build_pyramid(jnp.asarray(img1), jvo.n_levels)),
        emit_next=True, frame_id=jnp.asarray(STEP_FRAME, jnp.int32),
        **jvo._step_kwargs())
    tstep1 = tfused.track_frame_step(
        *tvo._step_inputs(tbuild_pyramid(torch.as_tensor(img1), tvo.n_levels)),
        emit_next=True, frame_id=STEP_FRAME, **tvo._step_kwargs())
    new_rows = [host_changes(vo.map, np.random.default_rng(3))
                for vo in (jvo, tvo)]
    assert new_rows[0] == new_rows[1]
    jblob = jvo.map.pack_mt_deltas(*WIDTHS)
    tblob = tvo.map.pack_mt_deltas(*WIDTHS)
    n = jvo.cfg.pipeline.n_pyr_levels
    jkw, tkw = jvo._step_kwargs(), tvo._step_kwargs()
    del jkw["specs"], tkw["specs"]
    jstep2 = jfused.track_frame_step_tables(
        jnp.asarray(img2), jvo.map.kf_atlas_flat(n), jstep1.next, jstep1.mt,
        jstep1.pt_seeds, jstep1.ln_seeds,
        jnp.asarray(jvo.batch_counter, jnp.int32), CAM.fx, CAM.fy, CAM.cx,
        CAM.cy, n_levels=jvo.n_levels,
        frame_id=jnp.asarray(STEP_FRAME + 1, jnp.int32),
        mt_delta=jnp.asarray(jblob), **jkw)
    tstep2 = tfused.track_frame_step_tables(
        torch.as_tensor(img2), tvo.map.kf_atlas_flat(n), to_torch(jstep1.next),
        to_torch(jstep1.mt), *seeds_to_torch(jstep1.pt_seeds, jstep1.ln_seeds),
        tvo.batch_counter, 250.0, 250.0, 160.0, 120.0, n_levels=tvo.n_levels,
        frame_id=STEP_FRAME + 1, mt_delta=torch.as_tensor(tblob), **tkw)
    return dict(jstep1=jstep1, tstep1=tstep1, jstep2=jstep2, tstep2=tstep2,
                jblob=jblob, tblob=tblob, jmt0=jmt0, optim=optim)


def _assert_steps_match(jstep, tstep):
    """tests/test_torch_step.py's checks on one pair of step results."""
    jf, tf = jstep.fused, tstep.fused
    np.testing.assert_allclose(tf.R_f_w.numpy(), np.asarray(jf.R_f_w), atol=1e-4)
    np.testing.assert_allclose(tf.t_f_w.numpy(), np.asarray(jf.t_f_w), atol=1e-4)
    j_ids = set(np.asarray(jf.pt.lm_idx)[np.asarray(jf.pt.matched)].tolist())
    t_ids = set(tf.pt.lm_idx.numpy()[tf.pt.matched.numpy()].tolist())
    assert len(j_ids) >= 20
    assert len(j_ids & t_ids) >= 0.98 * max(len(j_ids), len(t_ids))
    for js, ts, names in ((jstep.pt_seeds, tstep.pt_seeds, ("mu", "sigma2", "a", "b")),
                          (jstep.ln_seeds, tstep.ln_seeds, ("mu_s", "mu_e", "a", "b"))):
        both = np.asarray(js.alive) & ts.alive.numpy()
        assert (np.asarray(js.alive) == ts.alive.numpy()).mean() >= 0.98
        for name in names:
            np.testing.assert_allclose(getattr(ts, name).numpy()[both],
                                       np.asarray(getattr(js, name))[both],
                                       rtol=1e-3, err_msg=name)
    assert np.asarray(jstep.pt_seeds.alive).sum() >= 20


def _assert_next_close(jn, tn, fields_atol=1e-5):
    for name in tfused.LastFrameTables._fields:
        a, b = getattr(tn.last, name).numpy(), np.asarray(getattr(jn.last, name))
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=fields_atol, err_msg=name)
    for name in ("R_last", "t_last", "pt_last_optim", "ln_last_optim"):
        np.testing.assert_allclose(getattr(tn, name).numpy(),
                                   np.asarray(getattr(jn, name)), rtol=0,
                                   atol=fields_atol, err_msg=name)


def test_chained_first_step_matches_jax(chain):
    _assert_steps_match(chain["jstep1"], chain["tstep1"])
    assert chain["tstep1"].next is not None
    assert len(chain["tstep1"].next.pyr) == len(chain["jstep1"].next.pyr)


def test_build_next_inputs_matches_jax(chain):
    """The port's build_next_inputs on the JAX package's first-step result
    and map tables, against the JAX package's on the same inputs: valid
    masks exactly, floats within 1e-5. Every structure-opt row is marked
    valid here, so the frame-id stamps are exercised."""
    jres = chain["jstep1"].fused
    jres = jres._replace(st_pt_valid=jnp.ones_like(jres.st_pt_valid),
                         st_ln_valid=jnp.ones_like(jres.st_ln_valid))
    plo, llo = chain["optim"]
    pyr = chain["jstep1"].next.pyr
    jn = jfused.build_next_inputs(jres, chain["jmt0"], jnp.asarray(plo),
                                  jnp.asarray(llo),
                                  jnp.asarray(STEP_FRAME, jnp.int32), cur_pyr=pyr)
    tn = tfused.build_next_inputs(
        to_torch(jres), to_torch(chain["jmt0"]), torch.as_tensor(plo),
        torch.as_tensor(llo), STEP_FRAME,
        cur_pyr=[torch.as_tensor(np.asarray(p)) for p in pyr])
    _assert_next_close(jn, tn)
    assert tn.last.pt_valid.sum() >= 20 and tn.last.seg_valid.sum() >= 1
    st = np.asarray(jres.st_pt_lm)
    assert (tn.pt_last_optim.numpy()[st] == STEP_FRAME).all()
    for a, b in zip(tn.pyr, pyr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_delta_blob_and_carry_match_jax_exactly(chain):
    """The same host changes give the same blob, and the blob applied to
    the JAX package's first-step carry gives the same tables exactly."""
    np.testing.assert_array_equal(chain["tblob"], chain["jblob"])
    assert (chain["tblob"] != 0).sum() > 0
    jc = jfused.apply_mt_deltas(chain["jstep1"].mt, jnp.asarray(chain["jblob"]))
    tc = tfused.apply_mt_deltas(to_torch(chain["jstep1"].mt),
                                torch.as_tensor(chain["tblob"]))
    for name in tfused.MapTables._fields:
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), err_msg=name)


def test_chained_second_step_matches_jax(chain):
    jstep2, tstep2 = chain["jstep2"], chain["tstep2"]
    _assert_steps_match(jstep2, tstep2)
    # the carry out of the step: everything exactly, except the rows that
    # either package's structure optimisation wrote. Its accept test (chi2
    # below the start) flips on rounding for landmarks that barely move or
    # have a single observation, so those rows are compared only where both
    # packages wrote them, rtol 1e-3.
    jf, tf = jstep2.fused, tstep2.fused

    def written(f, lm, valid):
        return np.asarray(getattr(f, lm))[np.asarray(getattr(f, valid))]
    rows = {}
    for name, lm, valid in (("pt_pos", "st_pt_lm", "st_pt_valid"),
                            ("ln_spos", "st_ln_lm", "st_ln_valid"),
                            ("ln_epos", "st_ln_lm", "st_ln_valid")):
        a, b = written(jf, lm, valid), written(tf, lm, valid)
        rows[name] = (np.union1d(a, b), np.intersect1d(a, b))
    for name in tfused.MapTables._fields:
        a = getattr(tstep2.mt, name).numpy()
        b = np.asarray(getattr(jstep2.mt, name))
        either, both = rows.get(name, ([], []))
        keep = np.ones(len(a), bool)
        keep[either] = False
        np.testing.assert_array_equal(a[keep], b[keep], err_msg=name)
        np.testing.assert_allclose(a[both], b[both], rtol=1e-3, err_msg=name)
    tn = tstep2.next
    assert tn is not None and tn.pt_last_optim.max() == STEP_FRAME + 1
