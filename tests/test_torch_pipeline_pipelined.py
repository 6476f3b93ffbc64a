"""The port's pipelined mode on the CPU against the JAX package's, depth 1.

Both FrameHandlerMono run the golden 28-frame 320x240 sequence of
tests/test_pipeline.py with `fast_config()` unmodified (points, edgelets,
lines, local BA at every keyframe) plus pipelined=True, on identical numpy
frames, with JAX's bootstrap RANSAC draws given to the port. The bounds are
those of tests/test_pipeline.py::test_pipeline_pipelined_mode_matches and
of the golden ATE test. `run_both` and the checks serve the depth-4 file
too (test_torch_pipeline_pipelined_d4.py).

The JAX package's stale-seed guard (a strict `>`) lets the newest step's
alive mask mark a keyframe's seeds dead when a drain installs them in the
same add_image; the port keeps them (`>=`). Past the first harvest of such
a mask the two runs may part, so per-frame centres are held to JAX's only
up to it.

ATE: the golden sync bound is 0.006 (tests/test_pipeline.py:81, 1.5x the
0.00388 JAX measures with BA). Pipelined mode defers the keyframe's seed
install and BA write-back by a drain window, and on these frames the JAX
package's own pipelined runs measure 0.0064 (depth 1) and 0.0066 (depth
4). So the port's ATE is held below max(0.006, 1.2 x JAX's pipelined ATE
on the same frames).
"""
import dataclasses

import numpy as np
import pytest
import torch

from plsvo_torch import convert
from plsvo_torch.pipeline import frame_handler as tfh
from plsvo_torch.pipeline import fused as tfused
from plsvo_torch.pipeline.state import validate_map
from plsvo_tpu.config import fast_config
from plsvo_tpu.pipeline.frame_handler import FrameHandlerMono as JFH
from plsvo_tpu.utils import trajectory

from test_torch_pipeline import CAM, centers, first_default, jax_ransac_draws
from test_torch_pipeline_lines import tcam
from test_torch_step import golden_frames

N_FRAMES = 28

# One intra-op thread per test process, as in test_torch_pipeline.py.
torch.set_num_threads(1)


def pipelined_config(depth):
    cfg = fast_config()
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, pipelined=True, pipeline_depth=depth))


def gt_centers():
    return np.stack([np.asarray([0.022 * i, 0.006 * np.sin(0.3 * i), -2.0],
                                np.float32) for i in range(N_FRAMES)])


def drive(vo, imgs):
    """Every frame through add_image, then flush(): (results in delivery
    order, frame id of each add_image call's return or None)."""
    out, returned = [], []
    for i, im in enumerate(imgs):
        r = vo.add_image(im, i / 30.0)
        returned.append(None if r is None else r.frame_id)
        if r is not None:
            out.append(r)
    return out + vo.flush(), returned


def port_handler(cfg):
    return tfh.FrameHandlerMono(tcam(), convert.config_from_dict(
        dataclasses.asdict(cfg)), device="cpu", ransac_draws=jax_ransac_draws)


def record_stale_harvest(vo):
    """Instrument a port handler. installs: the add_image frames at which a
    drain installed a keyframe's seeds. stale: one entry per harvest of a
    mask from a step dispatched in such an add_image (before the install):
    (add_image frame, the mask's bits of the rows installed there, the
    mirror's bits of those rows after the harvest)."""
    installs, stale = set(), []
    init, harvest = vo._complete_seed_init, vo._apply_harvest

    def complete_seed_init(*a, **k):
        if vo.stage == tfh.STAGE_DEFAULT:  # the bootstrap's is in SECOND
            installs.add(vo.frame_id)
        return init(*a, **k)

    def apply_harvest(pt_conv, ln_conv, result_frame_id):
        fresh = vo._seed_install_frame == result_frame_id
        out = harvest(pt_conv, ln_conv, result_frame_id=result_frame_id)
        if result_frame_id in installs and pt_conv is not None:
            mask = tfused.unpack_bits16(pt_conv[3], len(fresh))
            stale.append((vo.frame_id, mask[fresh], vo._seed_alive[fresh]))
        return out

    vo._complete_seed_init = complete_seed_init
    vo._apply_harvest = apply_harvest
    return installs, stale


def step_errors(results):
    """Median |estimated - true| distance between consecutive DEFAULT
    frames (the error of tests/test_pipeline.py's pipelined-mode test)."""
    gt = gt_centers()
    est = {r.frame_id: -r.R_f_w.T @ r.t_f_w for r in results
           if r.stage == tfh.STAGE_DEFAULT}
    ks = sorted(est)
    return float(np.median([abs(np.linalg.norm(est[b] - est[a])
                                - np.linalg.norm(gt[b] - gt[a]))
                            for a, b in zip(ks[:-1], ks[1:])]))


def run_both(depth):
    imgs = golden_frames(N_FRAMES)
    jres, _ = drive(JFH(CAM, pipelined_config(depth)), imgs)
    tvo = port_handler(pipelined_config(depth))
    installs, stale = record_stale_harvest(tvo)
    tres, returned = drive(tvo, imgs)
    # the carry after a last delta sync, and a fresh upload of the mirror
    carry, fresh = tvo.sync_carry(), tfused.map_tables_upload(tvo.map)
    svo = port_handler(fast_config())
    sres = [svo.add_image(im, i / 30.0) for i, im in enumerate(imgs)]
    return dict(jres=jres, tres=tres, tvo=tvo, returned=returned,
                installs=sorted(installs), stale=stale, carry=carry,
                fresh=fresh, sres=sres)


def check_delivery(run, depth):
    """Every frame once, in order. A result returns at most 2 x depth
    add_image calls late: its window of depth frames is fetched when full
    and bookkept when the next window is submitted."""
    ids = [r.frame_id for r in run["tres"]]
    assert ids == list(range(N_FRAMES)), ids
    late = [i - f for i, f in enumerate(run["returned"]) if f is not None]
    assert max(late) <= 2 * depth, run["returned"]
    assert run["tvo"].n_relocalizations == 0


def check_against_jax(run):
    jres, tres = run["jres"], run["tres"]
    fd = first_default(tres)
    assert fd == first_default(jres)
    ids_t = {r.frame_id for r in tres if r.stage == tfh.STAGE_DEFAULT}
    ids_j = {r.frame_id for r in jres if r.stage == tfh.STAGE_DEFAULT}
    assert len(ids_t ^ ids_j) <= max(2, len(ids_j) // 10), (ids_t ^ ids_j)
    # deferred seed installs happened, and the centres agree with JAX's up
    # to the first harvest the JAX package's stale-seed fault can act on
    assert run["installs"], "no keyframe seed install in a drain"
    upto = run["stale"][0][0] if run["stale"] else N_FRAMES
    d = np.linalg.norm(centers(tres[:upto]) - centers(jres[:upto]), axis=-1)
    assert d.max() < 2e-3, (upto, d)


def ate(results):
    fd = first_default(results)
    return trajectory.ate_rmse(centers(results[fd:]).astype(np.float64),
                               gt_centers()[fd:].astype(np.float64),
                               with_scale=True)


def check_accuracy(run):
    tres = run["tres"]
    a_t, a_j = ate(tres), ate(run["jres"])
    assert a_t < max(0.006, 1.2 * a_j), (a_t, a_j)
    e_p, e_s = step_errors(tres), step_errors(run["sres"])
    assert e_p < max(2.5 * e_s, 0.004), (e_p, e_s)


def check_map(run):
    assert validate_map(run["tvo"].map) == []
    assert tfused.carry_mismatches(run["carry"], run["fresh"]) == []


@pytest.fixture(scope="module")
def run():
    return run_both(1)


def test_pipelined_d1_delivers_every_frame_once_in_order(run):
    check_delivery(run, 1)


def test_pipelined_d1_tracks_with_jax(run):
    check_against_jax(run)


def test_pipelined_d1_accuracy(run):
    check_accuracy(run)


def test_pipelined_d1_map_and_carry(run):
    check_map(run)


def test_pipelined_d1_keeps_seeds_installed_after_dispatch(run):
    """The stale-seed guard in a real run: a drain installs a keyframe's
    seeds after the newest step went out; that step's alive mask reports
    them dead, and the mirror keeps them alive."""
    assert run["stale"], run["installs"]
    for frame, mask, mirror in run["stale"]:
        assert (~mask).any(), (frame, mask)
        assert mirror.all(), (frame, mirror)
