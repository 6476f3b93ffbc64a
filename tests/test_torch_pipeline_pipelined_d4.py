"""The port's pipelined mode at depth 4 against the JAX package's (the
checks of test_torch_pipeline_pipelined.py), the stale-seed guard beside
the JAX package's, and pipelined relocalization after a blackout."""
import numpy as np
import pytest
import torch

from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_torch.pipeline import fused as tfused
from plsvo_tpu.pipeline import fused as jfused
from plsvo_tpu.pipeline.frame_handler import FrameHandlerMono as JFH

from test_torch_pipeline import CAM
from test_torch_pipeline_pipelined import (check_accuracy, check_against_jax,
                                           check_delivery, check_map,
                                           golden_frames, pipelined_config,
                                           port_handler, run_both)


@pytest.fixture(scope="module")
def run():
    return run_both(4)


def test_pipelined_d4_delivers_every_frame_once_in_order(run):
    check_delivery(run, 4)


def test_pipelined_d4_tracks_with_jax(run):
    check_against_jax(run)


def test_pipelined_d4_accuracy(run):
    check_accuracy(run)


def test_pipelined_d4_map_and_carry(run):
    check_map(run)


@pytest.mark.parametrize("kind", ["points", "lines"])
def test_stale_seed_guard_keeps_rows_installed_after_dispatch(kind):
    """Seeds installed at add_image frame 5, after the step of frame 5 was
    dispatched; that step's alive mask reports them dead. The port's mirror
    keeps them alive; the JAX package's strict `>` takes the mask and marks
    them dead. Rows installed at frame 3 take the mask in both."""
    cfg = pipelined_config(1)
    caps = cfg.caps
    cap = caps.max_seeds if kind == "points" else caps.max_seed_segs
    fresh, older = np.arange(0, 6), np.arange(6, 10)
    mask = np.zeros(cap, bool)  # the step of frame 5 saw none of them
    words = np.asarray(jfused.pack_bits16(mask))
    K = tfused.CONV_BUDGET
    none = np.full(K, cap, np.int32)
    if kind == "points":
        conv = (none, np.zeros(K, np.float32), np.int32(0), words, np.int32(0))
    else:
        conv = (none, np.zeros(K, np.float32), np.zeros(K, np.float32),
                np.int32(0), words, np.int32(0))
    alive_name = "_seed_alive" if kind == "points" else "_lnseed_alive"
    stamp_name = ("_seed_install_frame" if kind == "points"
                  else "_lnseed_install_frame")
    out = []
    for vo in (port_handler(cfg), JFH(CAM, cfg)):
        alive, stamp = getattr(vo, alive_name), getattr(vo, stamp_name)
        alive[fresh] = alive[older] = True
        stamp[fresh], stamp[older] = 5, 3
        if isinstance(vo, JFH):
            vo._any_line_seeds = True
            vo._apply_harvest((conv,), kind == "points", kind == "lines",
                              result_frame_id=5)
        else:
            vo._apply_harvest(*((conv, None) if kind == "points"
                                else (None, conv)), result_frame_id=5)
        out.append(getattr(vo, alive_name).copy())
    port, jax_ = out
    assert port[fresh].all() and not port[older].any()
    assert not jax_[fresh].any() and not jax_[older].any()


def test_conv_budget_overflow_is_counted():
    """A step reports at most CONV_BUDGET converged seeds, as the JAX
    package's (plsvo_tpu/pipeline/fused.py:917) does; the port counts the
    ones past the budget, which die without a landmark."""
    vo = port_handler(pipelined_config(1))
    cap = vo.cfg.caps.max_seeds
    K = tfused.CONV_BUDGET
    words = tfused.pack_bits16(torch.zeros(cap, dtype=torch.bool)).numpy()
    conv = (np.full(K, cap, np.int32), np.zeros(K, np.float32),
            np.int32(K + 6), words, np.int32(0))
    vo._apply_harvest(conv, None, result_frame_id=0)
    assert vo.permon.logs["seed_conv_dropped"] == 6


def test_pipelined_relocalizes_after_blackout():
    """tests/test_pipeline.py's blackout at two thirds of the golden
    sequence, pipelined at depth 4: the black frame fails in a drain, the
    frames dispatched after it are dropped, the handler relocalizes and
    tracks again, and the local BA result and seed detection whose fetch
    rode a dropped window are queued again and still completed."""
    imgs = golden_frames(28)
    vo = port_handler(pipelined_config(4))
    requeued, done_ba, done_init = [], [], []
    drains, write_back, seed_init = (vo._complete_drains, vo._write_back_ba,
                                     vo._complete_seed_init)

    def complete_drains(force):
        before = vo.stage
        drains(force)
        if (before, vo.stage) == (tfh.STAGE_DEFAULT, tfh.STAGE_RELOCALIZING):
            requeued.append((vo.frame_id, [id(m) for _, m in vo._pending_ba],
                             [e[:3] for e in vo._pending_seed_init],
                             len(done_ba), len(done_init)))

    def write_back_ba(kf_R, kf_t, lm_pos, meta):
        done_ba.append(id(meta))
        return write_back(kf_R, kf_t, lm_pos, meta)

    def complete_seed_init(kf_slot, dm, dmin, *fetched):
        done_init.append((kf_slot, dm, dmin))
        return seed_init(kf_slot, dm, dmin, *fetched)

    vo._complete_drains = complete_drains
    vo._write_back_ba = write_back_ba
    vo._complete_seed_init = complete_seed_init
    split = 2 * len(imgs) // 3
    delivered = []
    frames = ([(imgs[i], i) for i in range(split)]
              + [(np.zeros_like(imgs[0]), split)]
              + [(imgs[j], j + 10) for j in range(split - 2, len(imgs))])
    for img, t in frames:
        r = vo.add_image(img, t / 30.0)
        if r is not None:
            delivered.append(r)
    delivered += vo.flush()
    assert len(requeued) == 1, requeued
    at, ba_ids, inits, n_ba, n_init = requeued[0]
    assert ba_ids and inits, requeued  # something rode a dropped window
    # the black frame failed; its successors dispatched before the drain
    # that saw it never come back
    ids = [r.frame_id for r in delivered]
    assert len(ids) == len(set(ids))
    failed = [r for r in delivered if r.quality == tfh.QUALITY_INSUFFICIENT
              and r.stage == tfh.STAGE_DEFAULT]
    assert [r.frame_id for r in failed] == [split]
    dropped = set(range(split + 1, at))
    assert dropped and not dropped & set(ids), (at, ids)
    # relocalized, then tracked to the end
    assert vo.n_relocalizations >= 1 and vo.stage == tfh.STAGE_DEFAULT
    assert delivered[-1].stage == tfh.STAGE_DEFAULT
    assert delivered[-1].quality == tfh.QUALITY_GOOD
    # the re-queued BA results and seed detections were completed after it
    assert set(ba_ids) <= set(done_ba[n_ba:]), (ba_ids, done_ba)
    assert all(i in done_init[n_init:] for i in inits), (inits, done_init)
