"""The map carry of pipelined mode: MapState's delta queues packed
(pack_mt_deltas) and applied on the device (fused.apply_mt_deltas) must give
exactly the tables a fresh upload of the mirror gives. The first five tests
mirror tests/test_mt_deltas.py on the port; then the port's blobs and
carries are held to the JAX package's, element for element, where the
reference has no fault, and to its own mirror where the reference has one:
an eviction that deletes and re-anchors landmarks (the JAX package's
remove_keyframe queues none of those rows, so its carry keeps them), and
more evictions than the JAX package's 16 blob slots (it asserts)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plsvo_torch.config import fast_config as tfast_config
from plsvo_torch.pipeline import fused as tfused
from plsvo_torch.pipeline.state import FrameState as TFrameState
from plsvo_torch.pipeline.state import MapState as TMapState
from plsvo_torch.pipeline.state import ST_GOOD
from plsvo_tpu.config import fast_config
from plsvo_tpu.pipeline import fused as jfused
from plsvo_tpu.pipeline.state import FrameState as JFrameState
from plsvo_tpu.pipeline.state import MapState as JMapState

INTR = (250.0, 250.0, 160.0, 120.0)
WIDTHS = dict(DP=tfused.MT_DELTA_DP, DL=tfused.MT_DELTA_DL,
              OP=tfused.MT_DELTA_OP, OL=tfused.MT_DELTA_OL,
              NE=tfused.MT_DELTA_NE)


def _mk_map():
    cfg = tfast_config()
    return cfg, TMapState(cfg, 5, (240, 320), intrinsics=INTR, device="cpu")


def _frame_tables(fid, rng, n_pt=24, n_seg=6):
    """A frame's host tables (tests/test_mt_deltas.py's _mk_frame)."""
    ang = 0.01 * fid
    R = np.asarray([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                    [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    t = np.asarray([0.05 * fid, 0, 0], np.float32)
    pt_f = rng.normal(size=(n_pt, 3))
    return dict(
        fid=fid, R=R, t=t, pt_uv=rng.uniform(10, 200, (n_pt, 2)),
        pt_f=pt_f / np.linalg.norm(pt_f, axis=-1, keepdims=True),
        seg_suv=rng.uniform(10, 200, (n_seg, 2)),
        seg_euv=rng.uniform(10, 200, (n_seg, 2)),
        seg_sf=rng.normal(size=(n_seg, 3)), seg_ef=rng.normal(size=(n_seg, 3)),
        pt_lm={}, seg_lm={})


def _frame(cls, cfg, d, zeros):
    fr = cls.empty(cfg, d["fid"], d["fid"] / 30.0,
                   [zeros((240 >> l, 320 >> l)) for l in range(5)],
                   d["R"], d["t"])
    n, g = len(d["pt_uv"]), len(d["seg_suv"])
    fr.pt_uv[:n], fr.pt_f[:n], fr.pt_valid[:n] = d["pt_uv"], d["pt_f"], True
    for k in ("seg_suv", "seg_euv", "seg_sf", "seg_ef"):
        getattr(fr, k)[:g] = d[k]
    fr.seg_valid[:g] = True
    for i, lm in d["pt_lm"].items():
        fr.pt_lm[i] = lm
    for i, lm in d["seg_lm"].items():
        fr.seg_lm[i] = lm
    return fr


def _tframe(cfg, d):
    return _frame(TFrameState, cfg, d, lambda s: torch.zeros(s))


def _jframe(cfg, d):
    return _frame(JFrameState, cfg, d, lambda s: jnp.zeros(s, jnp.float32))


def _mk_frame(cfg, fid, rng, n_pt=24, n_seg=6):
    return _tframe(cfg, _frame_tables(fid, rng, n_pt, n_seg))


def _fresh(m):
    m.invalidate()
    m._dev_obs.clear()
    for g in m._obs_dirty.values():
        g.clear()
    return tfused.map_tables_from_state(m)


def _assert_carry_matches_mirror(m, carry):
    """Exact equality with a fresh upload; an observation slot's payload
    counts only where its keyframe id is live (an eviction sweep clears the
    id and leaves the payload, as the mirror's own device copy does)."""
    fresh = _fresh(m)
    for name in tfused.MapTables._fields:
        a = getattr(carry, name).numpy()
        b = getattr(fresh, name).numpy()
        if "_obs_" in name and not name.endswith("obs_kf"):
            live = getattr(carry, name.split("_obs_")[0] + "_obs_kf").numpy() >= 0
            a, b = a[live], b[live]
        np.testing.assert_array_equal(a, b, err_msg=name)


def _sync(m, carry, widths=None):
    w = dict(WIDTHS, **(widths or {}))
    n = 0
    while m.mt_dirty_pending() or n == 0:
        blob = m.pack_mt_deltas(w["DP"], w["DL"], w["OP"], w["OL"], w["NE"])
        assert blob.shape[0] == tfused.mt_delta_len(m.cfg.caps.max_kfs, **w)
        carry = tfused.apply_mt_deltas(carry, torch.as_tensor(blob), **w)
        n += 1
        assert n < 50, "delta queue never drains"
    return carry


def test_deltas_landmark_creation_and_status():
    rng = np.random.default_rng(0)
    cfg, m = _mk_map()
    kf = m.add_keyframe(_mk_frame(cfg, 0, rng))
    carry = tfused.map_tables_from_state(m)
    m.mt_mark_clean()
    rows = [m.new_point(rng.normal(size=3), kf, rng.uniform(0, 200, 2),
                        rng.normal(size=3), i % 3) for i in range(40)]
    for _ in range(12):
        m.new_line(rng.normal(size=3), rng.normal(size=3), kf,
                   rng.uniform(0, 200, 2), rng.uniform(0, 200, 2),
                   rng.normal(size=3), rng.normal(size=3), 0)
    m.pt_status[rows[3]] = 0
    m.pt_status[rows[5]] = ST_GOOD
    m.mark_mt_dirty("pt", [rows[3], rows[5]])
    _assert_carry_matches_mirror(m, _sync(m, carry))


def test_deltas_keyframe_install_evict_reuse():
    rng = np.random.default_rng(1)
    cfg, m = _mk_map()
    kf0 = m.add_keyframe(_mk_frame(cfg, 0, rng))
    carry = tfused.map_tables_from_state(m)
    m.mt_mark_clean()
    lms = [m.new_point(rng.normal(size=3) + (0, 0, 3), kf0,
                       rng.uniform(0, 200, 2), rng.normal(size=3), 0)
           for _ in range(30)]
    for fid in range(1, 4):
        fr = _mk_frame(cfg, fid, rng)
        fr.pt_lm[:30] = lms
        fr.pt_valid[:30] = True
        m.add_keyframe(fr)
    carry = _sync(m, carry)
    _assert_carry_matches_mirror(m, carry)
    m.remove_keyframe(1)
    fr = _mk_frame(cfg, 9, rng)
    fr.pt_lm[:30] = lms
    fr.pt_valid[:30] = True
    assert m.add_keyframe(fr) == 1  # the freed slot is reused
    _assert_carry_matches_mirror(m, _sync(m, carry))


def test_deltas_spill_with_tiny_widths():
    """Every width tiny: deltas spill over many blobs and still converge to
    the mirror exactly."""
    rng = np.random.default_rng(2)
    cfg, m = _mk_map()
    kf0 = m.add_keyframe(_mk_frame(cfg, 0, rng))
    carry = tfused.map_tables_from_state(m)
    m.mt_mark_clean()
    for _ in range(50):
        m.new_point(rng.normal(size=3), kf0, rng.uniform(0, 200, 2),
                    rng.normal(size=3), 0)
    for _ in range(20):
        m.new_line(rng.normal(size=3), rng.normal(size=3), kf0,
                   rng.uniform(0, 200, 2), rng.uniform(0, 200, 2),
                   rng.normal(size=3), rng.normal(size=3), 0)
    m.remove_keyframe(0)
    m.add_keyframe(_mk_frame(cfg, 5, rng))
    carry = _sync(m, carry, widths=dict(DP=8, DL=4, OP=8, OL=4, NE=1))
    _assert_carry_matches_mirror(m, carry)


def test_struct_apply_matches_host():
    """apply_struct_to_mt scatters exactly what the host mirror applies
    from the fetched structure-opt results."""
    rng = np.random.default_rng(3)
    cfg, m = _mk_map()
    kf = m.add_keyframe(_mk_frame(cfg, 0, rng))
    rows = [m.new_point(rng.normal(size=3), kf, rng.uniform(0, 200, 2),
                        rng.normal(size=3), 0) for _ in range(10)]
    lrows = [m.new_line(rng.normal(size=3), rng.normal(size=3), kf,
                        rng.uniform(0, 200, 2), rng.uniform(0, 200, 2),
                        rng.normal(size=3), rng.normal(size=3), 0)
             for _ in range(4)]
    carry = tfused.map_tables_from_state(m)
    m.mt_mark_clean()
    st_pt_lm = np.asarray(rows[:4])
    st_pt_pos = rng.normal(size=(4, 3)).astype(np.float32)
    st_pt_valid = np.asarray([True, False, True, True])
    st_ln_lm = np.asarray(lrows[:2])
    st_ln_spos = rng.normal(size=(2, 3)).astype(np.float32)
    st_ln_epos = rng.normal(size=(2, 3)).astype(np.float32)
    res = tfused.FusedResult(*[None] * len(tfused.FusedResult._fields))._replace(
        st_pt_lm=torch.as_tensor(st_pt_lm), st_pt_pos=torch.as_tensor(st_pt_pos),
        st_pt_valid=torch.as_tensor(st_pt_valid),
        st_ln_lm=torch.as_tensor(st_ln_lm), st_ln_spos=torch.as_tensor(st_ln_spos),
        st_ln_epos=torch.as_tensor(st_ln_epos),
        st_ln_valid=torch.ones(2, dtype=torch.bool))
    carry = tfused.apply_struct_to_mt(carry, res)
    m.pt_pos[st_pt_lm[st_pt_valid]] = st_pt_pos[st_pt_valid]
    m.ln_spos[st_ln_lm] = st_ln_spos
    m.ln_epos[st_ln_lm] = st_ln_epos
    _assert_carry_matches_mirror(m, carry)


def test_pack_bits16_roundtrip():
    """pack_bits16 words survive the f32 fetch exactly, unpack to the mask,
    and equal the JAX package's words."""
    rng = np.random.default_rng(4)
    for n in (1, 15, 16, 17, 512, 250):
        mask = rng.random(n) > 0.5
        words = tfused.pack_bits16(torch.as_tensor(mask))
        assert words.dtype == torch.float32
        np.testing.assert_array_equal(words.numpy(),
                                      np.asarray(jfused.pack_bits16(jnp.asarray(mask))))
        back = tfused.unpack_bits16(words.numpy().astype(np.float64), n)
        np.testing.assert_array_equal(back, mask, err_msg=f"n={n}")


class _Both:
    """A JAX MapState and a port MapState driven by the same host
    operations; `sync` packs both, checks the blobs element for element,
    and applies each to its own carry."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.jcfg, self.tcfg = fast_config(), tfast_config()
        self.j = JMapState(self.jcfg, 5, (240, 320), intrinsics=INTR)
        self.t = TMapState(self.tcfg, 5, (240, 320), intrinsics=INTR,
                           device="cpu")
        self.jcarry = self.tcarry = None

    def add_keyframe(self, d):
        a = self.j.add_keyframe(_jframe(self.jcfg, d))
        b = self.t.add_keyframe(_tframe(self.tcfg, d))
        assert a == b
        return a

    def new_point(self, kf):
        args = (self.rng.normal(size=3) + (0, 0, 3), kf,
                self.rng.uniform(0, 200, 2), self.rng.normal(size=3), 0)
        a, b = self.j.new_point(*args), self.t.new_point(*args)
        assert a == b
        return a

    def new_line(self, kf):
        args = (self.rng.normal(size=3) + (0, 0, 3),
                self.rng.normal(size=3) + (0, 0, 3), kf,
                self.rng.uniform(0, 200, 2), self.rng.uniform(0, 200, 2),
                self.rng.normal(size=3), self.rng.normal(size=3), 0)
        a, b = self.j.new_line(*args), self.t.new_line(*args)
        assert a == b
        return a

    def both(self, fn):
        fn(self.j)
        fn(self.t)

    def start_carries(self):
        self.jcarry = jfused.map_tables_from_state(self.j)
        self.tcarry = tfused.map_tables_from_state(self.t)
        self.j.mt_mark_clean()
        self.t.mt_mark_clean()

    def sync(self, same_blobs=True):
        w = WIDTHS
        n = 0
        while self.t.mt_dirty_pending() or self.j.mt_dirty_pending() or n == 0:
            jb = self.j.pack_mt_deltas(w["DP"], w["DL"], w["OP"], w["OL"], w["NE"])
            tb = self.t.pack_mt_deltas(w["DP"], w["DL"], w["OP"], w["OL"], w["NE"])
            if same_blobs:
                np.testing.assert_array_equal(tb, jb)
            self.jcarry = jfused.apply_mt_deltas(self.jcarry, jnp.asarray(jb),
                                                 **w)
            self.tcarry = tfused.apply_mt_deltas(self.tcarry,
                                                 torch.as_tensor(tb), **w)
            n += 1

    def carries_differ(self):
        return [name for name in tfused.MapTables._fields
                if not np.array_equal(getattr(self.tcarry, name).numpy(),
                                      np.asarray(getattr(self.jcarry, name)))]


def _observed(d, lms, key="pt_lm"):
    """The frame's first len(lms) feature rows observe lms."""
    assert len(lms) <= len(d["pt_uv" if key == "pt_lm" else "seg_suv"])
    d[key].update({i: lm for i, lm in enumerate(lms)})
    return d


def test_delta_blobs_and_carries_match_jax():
    """Landmark creation, status changes, keyframe installs that refresh
    anchors and append observations, an eviction that neither deletes nor
    re-anchors (every landmark keeps >= 3 observations and its anchor on the
    newest keyframe), slot reuse and a spill of the row widths: the port's
    blob equals the JAX package's at every sync, and so do the carries."""
    b = _Both(5)
    kf0 = b.add_keyframe(_frame_tables(0, b.rng))
    b.start_carries()
    pts = [b.new_point(kf0) for _ in range(24)]
    lns = [b.new_line(kf0) for _ in range(5)]

    def status(m):
        m.pt_status[pts[4]] = ST_GOOD
        m.mark_mt_dirty("pt", [pts[4]])
    b.both(status)
    b.sync()
    for fid in range(1, 4):
        b.add_keyframe(_observed(_observed(_frame_tables(fid, b.rng), pts),
                                 lns, "seg_lm"))
    b.sync()
    assert b.carries_differ() == []
    b.both(lambda m: m.remove_keyframe(1))
    b.add_keyframe(_observed(_frame_tables(9, b.rng), pts[:12]))
    more = [b.new_point(kf0) for _ in range(300)]  # spills DP=256
    assert len(set(more)) == 300
    b.sync()
    assert b.carries_differ() == []
    _assert_carry_matches_mirror(b.t, b.tcarry)


def test_eviction_that_deletes_and_reanchors_keeps_carry_exact():
    """Points and lines seen by keyframes 0 and 1 only die when keyframe 1
    is evicted; those seen by keyframes 0-3 and anchored on 3 re-anchor
    when 3 is evicted. The port queues those rows and its carry equals its
    mirror. The JAX package's remove_keyframe queues none of them
    (plsvo_tpu/pipeline/state.py:614-683), so its carry keeps the deleted
    rows alive and the old anchors."""
    b = _Both(6)
    kf0 = b.add_keyframe(_frame_tables(0, b.rng))
    b.start_carries()
    die = [b.new_point(kf0) for _ in range(10)]
    move = [b.new_point(kf0) for _ in range(10)]
    ldie = [b.new_line(kf0) for _ in range(3)]
    lmove = [b.new_line(kf0) for _ in range(3)]
    b.add_keyframe(_observed(_observed(_frame_tables(1, b.rng), die + move),
                             ldie + lmove, "seg_lm"))
    for fid in (2, 3):
        b.add_keyframe(_observed(_observed(_frame_tables(fid, b.rng), move),
                                 lmove, "seg_lm"))
    b.sync()
    assert b.carries_differ() == []
    b.both(lambda m: m.remove_keyframe(1))
    b.both(lambda m: m.remove_keyframe(3))
    for m in (b.j, b.t):
        assert (m.pt_status[die] == 0).all() and (m.ln_status[ldie] == 0).all()
        assert (m.pt_anchor_kf[move] == 2).all()
        assert (m.ln_anchor_kf[lmove] == 2).all()
    b.sync(same_blobs=False)
    _assert_carry_matches_mirror(b.t, b.tcarry)
    jc = b.jcarry
    assert (np.asarray(jc.pt_status)[die] > 0).all()
    assert (np.asarray(jc.ln_status)[ldie] > 0).all()
    assert (np.asarray(jc.pt_anchor_kf)[move] == 3).all()
    assert (np.asarray(jc.ln_anchor_kf)[lmove] == 3).all()


def _twenty_evictions(m, frame, rng):
    """8 keyframes observing 24 landmarks, synced; then 20 evictions of the
    oldest keyframe, each followed by a new keyframe in the freed slot, with
    no sync between them (a drain window of pipeline_depth=20 frames)."""
    kf0 = m.add_keyframe(frame(_frame_tables(0, rng)))
    lms = [m.new_point(rng.normal(size=3) + (0, 0, 3), kf0,
                       rng.uniform(0, 200, 2), rng.normal(size=3), 0)
           for _ in range(24)]
    for fid in range(1, 8):
        m.add_keyframe(frame(_observed(_frame_tables(fid, rng), lms)))
    return lms


def test_more_than_16_queued_evictions():
    """20 evictions queued between two blobs. The JAX package asserts
    (plsvo_tpu/pipeline/state.py:309). The port sizes the eviction list from
    max(16, max_kfs, 2 x pipeline_depth) = 40 and the carry equals the mirror;
    with a list of 16 it ships no eviction, keeps them queued and asks for a
    full resync instead of asserting."""
    cfg = tfast_config()
    NE = tfused.mt_evict_width(cfg.caps.max_kfs, 20)
    assert NE == 40
    maps = []
    for _ in range(2):
        rng = np.random.default_rng(7)
        _, m = _mk_map()
        _twenty_evictions(m, lambda d: _tframe(cfg, d), rng)
        carry = tfused.map_tables_from_state(m)
        m.mt_mark_clean()
        for fid in range(8, 28):
            fr = _tframe(cfg, _frame_tables(fid, rng))
            m.remove_keyframe(int(np.argmin(np.where(m.kf_occupied,
                                                     m.kf_frame_id, 1 << 40))))
            m.add_keyframe(fr)
        assert len(m._mt_evicted) == 20
        maps.append((m, carry))
    (m, carry), (m16, _) = maps
    _assert_carry_matches_mirror(m, _sync(m, carry, widths=dict(NE=NE)))
    assert m16.mt_needs_resync(16)
    blob = m16.pack_mt_deltas(256, 96, 256, 96, 16)
    assert (blob[:16] == -1).all() and m16._mt_overflow
    assert len(m16._mt_evicted) == 20
    # the reference asserts on the same queue
    rng = np.random.default_rng(7)
    jcfg = fast_config()
    jm = JMapState(jcfg, 5, (240, 320), intrinsics=INTR)
    _twenty_evictions(jm, lambda d: _jframe(jcfg, d), rng)
    jm.mt_mark_clean()
    for fid in range(8, 28):
        fr = _jframe(jcfg, _frame_tables(fid, rng))
        jm.remove_keyframe(int(np.argmin(np.where(jm.kf_occupied,
                                                  jm.kf_frame_id, 1 << 40))))
        jm.add_keyframe(fr)
    with pytest.raises(AssertionError, match="eviction list"):
        jm.pack_mt_deltas(256, 96, 256, 96, 16)
