"""A keyframe installed right after the eviction that made room for it
links none of the landmarks that eviction deleted. The soak at depth 4
and 12 (chip_smoke.py's phase_soak; the port on the CPU) found a keyframe
feature linked to a deleted landmark: `_make_keyframe` evicts the furthest
keyframe, whose deletion sweep removes landmarks seen by it and one other
keyframe only, and then installs the new keyframe, whose own frame matched
some of them. The JAX package's add_keyframe links them anyway (shown
beside the port's), so validate_map reports them, and a reused row would
give the keyframe feature an unrelated landmark."""
import numpy as np

from plsvo_torch.pipeline.state import validate_map
from plsvo_tpu.pipeline.state import MapState as JMapState
from plsvo_tpu.pipeline.state import validate_map as jvalidate_map

from test_torch_mt_deltas import (INTR, _frame_tables, _jframe, _mk_map,
                                  _tframe)


def _evict_then_install(m, frame_of, cfg):
    """kf0 and kf1 see 20 landmarks (two observations each), kf2 sees the
    first 10 of them too; evicting kf0 deletes the other 10, which the new
    keyframe's frame still links."""
    rng = np.random.default_rng(4)
    tabs = [_frame_tables(fid, rng) for fid in range(4)]
    kf0 = m.add_keyframe(frame_of(cfg, tabs[0]))
    lms = [m.new_point(rng.normal(size=3) + (0, 0, 3), kf0,
                       rng.uniform(0, 200, 2), rng.normal(size=3), 0)
           for _ in range(20)]
    tabs[1]["pt_lm"] = dict(enumerate(lms))
    m.add_keyframe(frame_of(cfg, tabs[1]))
    tabs[2]["pt_lm"] = dict(enumerate(lms[:10]))
    m.add_keyframe(frame_of(cfg, tabs[2]))
    new = frame_of(cfg, dict(tabs[3], pt_lm=dict(enumerate(lms))))
    m.remove_keyframe(kf0)
    slot = m.add_keyframe(new)
    return lms, slot


def test_keyframe_links_no_landmark_its_eviction_deleted():
    cfg, m = _mk_map()
    lms, slot = _evict_then_install(m, _tframe, cfg)
    dead = [r for r in lms if m.pt_status[r] == 0]
    assert len(dead) == 10  # seen by kf0 and kf1 only
    assert not np.isin(m.kf_pt_lm, dead).any()
    assert set(m.kf_pt_lm[slot][m.kf_pt_lm[slot] >= 0]) == set(lms) - set(dead)
    assert not (m.pt_obs_kf[dead] == slot).any()
    assert not np.isin(m.kf_key_lms[slot], dead).any()
    assert validate_map(m) == []


def test_jax_keyframe_links_deleted_landmarks():
    """The reference, on the same tables: the new keyframe links the 10
    deleted landmarks and validate_map reports each."""
    from plsvo_tpu.config import fast_config

    cfg = fast_config()
    m = JMapState(cfg, 5, (240, 320), intrinsics=INTR)
    lms, slot = _evict_then_install(m, _jframe, cfg)
    dead = [r for r in lms if m.pt_status[r] == 0]
    assert len(dead) == 10
    assert np.isin(m.kf_pt_lm[slot], dead).sum() == 10
    assert len(jvalidate_map(m)) == 10
