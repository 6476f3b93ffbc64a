"""Pipelined mode keeps its results in frame order through a failed
relocalization: a frame that fails in a drain leaves the results of its
window's earlier frames queued, and each relocalization attempt that fails
makes a result of its own. That result must come back after the queued
ones, as add_image's results do in every other call (at depth 12 the
smoke's soak found the attempts' results returned first and the queued
ones only at flush()). Port only, the golden sequence at depth 4."""
import dataclasses

import numpy as np
import torch

from plsvo_torch.pipeline import frame_handler as tfh

from test_torch_pipeline_pipelined import pipelined_config, port_handler
from test_torch_step import golden_frames

torch.set_num_threads(1)


def test_failed_relocalization_results_queue_behind_earlier_ones():
    imgs = golden_frames(16)
    vo = port_handler(pipelined_config(4))
    out = []
    for i, img in enumerate(imgs):
        r = vo.add_image(img, i / 30.0)
        if r is not None:
            out.append(r)
    out += vo.flush()
    assert vo.stage == tfh.STAGE_DEFAULT
    # a drain has just failed a frame: two results of its window queued
    queued = [dataclasses.replace(out[-1], frame_id=16 + k) for k in range(2)]
    vo._ready = list(queued)
    vo.stage = tfh.STAGE_RELOCALIZING
    # the keyframe offers no point to align: the attempt fails
    inputs = vo._align_inputs_from_frame

    def no_points(frame):
        pts, segs = inputs(frame)
        return pts._replace(valid=torch.zeros_like(pts.valid)), segs

    vo._align_inputs_from_frame = no_points
    vo.frame_id = 18
    black = np.zeros_like(imgs[0])
    got = [vo.add_image(black, 18 / 30.0), vo.add_image(black, 19 / 30.0)]
    got += vo.flush()
    assert vo.n_relocalizations == 2
    assert [r.frame_id for r in got] == [16, 17, 18, 19]
    assert [r.stage for r in got[2:]] == [tfh.STAGE_RELOCALIZING] * 2
