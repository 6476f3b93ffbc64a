"""A change that the carry's delta blobs cannot express: MapState.transform
between two pipelined frames. The carry is then rebuilt from a full upload
of the mirror, by sync_carry() and by the next add_image, which finishes
every frame in flight first and starts a new chain."""
import numpy as np

from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_torch.pipeline import fused as tfused

from test_torch_pipeline_pipelined import (golden_frames, pipelined_config,
                                           port_handler)

N_FRAMES = 16
AT = 10  # the add_image calls before the transform


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def test_transform_between_pipelined_frames_resyncs_the_carry():
    imgs = golden_frames(N_FRAMES)
    vo = port_handler(pipelined_config(2))
    delivered = []
    for i in range(AT):
        r = vo.add_image(imgs[i], i / 30.0)
        delivered += [r] if r is not None else []
    assert vo.stage == tfh.STAGE_DEFAULT and vo._pipe_q  # frames in flight
    m = vo.map
    pos = m.pt_pos[m.pt_status > 0].copy()
    assert len(pos)
    R, t, s = _rot_z(0.02), np.asarray([0.01, -0.02, 0.005]), 1.01
    m.transform(R, t, s)
    assert m.mt_needs_resync(vo._mt_ne)
    carry = vo.sync_carry()
    assert not tfused.carry_mismatches(carry, tfused.map_tables_upload(m))
    np.testing.assert_allclose(carry.pt_pos.numpy()[m.pt_status > 0],
                               s * pos @ R.T + t, atol=1e-5)
    assert not m.mt_needs_resync(vo._mt_ne) and not m.mt_dirty_pending()
    # undo it; the next frame meets the resync in the handler
    m.transform(R.T, -(R.T @ t) / s, 1.0 / s)
    in_flight = [f.frame_id for f, _ in vo._pipe_q]
    r = vo.add_image(imgs[AT], AT / 30.0)
    delivered += [r] if r is not None else []
    # every frame in flight was finished; the chain restarted at frame AT
    assert [f.frame_id for f, _ in vo._pipe_q] == [AT] and not vo._fetch_q
    assert set(in_flight) <= {x.frame_id for x in delivered}
    for i in range(AT + 1, N_FRAMES):
        r = vo.add_image(imgs[i], i / 30.0)
        delivered += [r] if r is not None else []
    delivered += vo.flush()
    assert [x.frame_id for x in delivered] == list(range(N_FRAMES))
    assert all(x.stage == tfh.STAGE_DEFAULT and x.quality == tfh.QUALITY_GOOD
               for x in delivered[AT:])
    assert not tfused.carry_mismatches(vo.sync_carry(),
                                       tfused.map_tables_upload(vo.map))


def test_failure_in_the_last_drain_leaves_no_dropped_step_in_the_carry():
    """A frame that fails in flush()'s drain drops its successors in
    flight, whose steps already wrote their structure updates into the
    carry; the next step would restart from a full upload, and so does
    sync_carry()."""
    imgs = golden_frames(N_FRAMES)
    vo = port_handler(pipelined_config(4))
    for i in range(N_FRAMES):
        vo.add_image(imgs[i], i / 30.0)
    assert vo.stage == tfh.STAGE_DEFAULT and len(vo._pipe_q) > 2
    # every frame bookkept from here on fails its quality gate
    vo._tracking_quality = lambda n_pt, n_seg: tfh.QUALITY_INSUFFICIENT
    out = vo.flush()
    assert vo.stage == tfh.STAGE_RELOCALIZING
    assert out[-1].quality == tfh.QUALITY_INSUFFICIENT
    assert out[-1].frame_id < N_FRAMES - 2  # successors were dropped
    assert not tfused.carry_mismatches(vo.sync_carry(),
                                       tfused.map_tables_upload(vo.map))
